"""Crash-durable request journal: the serving engine's write-ahead log
(counterpart of ``accelerate_tpu/journal.py``, byte-compatible with it:
either package replays the other's journal).

A serving process that dies (SIGKILL, out of memory, an injected
``engine_crash``) loses its queue and every request in flight unless their
lifecycle is durable outside the process. The journal is an append-only
JSONL log with a checksum per record; sealing a segment uses the
checkpoints' fsync, ``os.replace``, directory-fsync discipline
(``fault_tolerance._fsync_dir``).

One record a line, torn-tail tolerant::

    <crc32 hex> <compact json>\\n

A line whose checksum does not match is skipped and counted; a torn tail
(a last line without its newline: the write the crash cut) is truncated
and counted, so the journal opens appendable again. Records carry a type
tag ``"t"``:

- ``admit``, written by ``submit()``: request id, the caller's
  ``client_request_id``, prompt tokens, budget, the request's sampling
  state (``rng``: the ``torch.Generator``'s state as a list of byte values
  as it stood at ``submit``, or null for a greedy request; the JAX package
  stores its key data there), the deadline as a budget with the submit
  time on ``time.perf_counter`` (``t_mono``), never wall time;
- ``bind``: the ``weights_version`` the request bound at its grant;
- ``progress``: one record a tick with the tokens each live request
  emitted (observability; recovery replays from the prompt);
- ``recovered``: written by ``ServingEngine.recover()`` for each replayed
  request, so its ``attempt`` count survives repeated crashes;
- ``terminal``: the finished row (status, the whole padded token row,
  latencies). Self-contained, so compaction can drop a finished request's
  other records while its row still answers a duplicate ``submit`` and a
  restart.

Durability (``ServingConfig.journal_fsync``): ``every_record`` flushes
and fsyncs every append; ``every_tick`` (the default) buffers and fsyncs
once a tick, losing at most one tick; ``os`` flushes to the page cache
once a tick and never fsyncs (it survives a process death, not a power
loss).

Segments rotate every ``segment_records`` appends: the active one is
``wal_NNNNN.jsonl.open``, sealed by fsync, ``os.replace`` to
``wal_NNNNN.jsonl`` and a directory fsync. Compaction merges the sealed
segments into one, dropping the working records of finished requests
(their terminal rows stay) and keeping every unfinished request's records
as they were.

Off unless built (or ``ServingConfig.journal_dir`` set). An attached
``chaos.FaultInjector`` is drawn at ``journal_append`` (``torn_write``:
half the line lands, then the whole record on a fresh line, so replay
skips a corrupt line and loses nothing) and at ``journal_compact``
(``torn_write``: the compaction aborts, its staging file removed, the
sealed segments untouched).

Usage::

    engine = ServingEngine(model, ServingConfig(journal_dir="wal/"))
    rid = engine.submit(prompt, client_request_id="req-0")
    ...                                   # the process dies mid-flight
    engine = ServingEngine(model, ServingConfig(journal_dir="wal/"))
    engine.recover()                      # finished -> cached rows,
    ...                                   # in flight -> bit-equal replay
"""

from __future__ import annotations

import json
import logging
import os
import zlib
from typing import Optional

from .fault_tolerance import _fsync_dir

logger = logging.getLogger(__name__)

__all__ = ["RequestJournal", "JournalAdoptionError", "JOURNAL_FSYNC_POLICIES"]

#: Legal ``fsync`` policies, strongest first.
JOURNAL_FSYNC_POLICIES = ("every_record", "every_tick", "os")

_PREFIX = "wal_"
_SEALED = ".jsonl"
_OPEN = ".jsonl.open"
_COMPACT_STAGING = "compact.jsonl.tmp"
_ADOPTION = "adopted.lock"


class JournalAdoptionError(RuntimeError):
    """A second party tried to adopt a journal directory that is already
    claimed. Raised so a recovering fleet router and a restarting gang
    supervisor can never BOTH replay the same dead cell's WAL — double
    adoption is double execution."""


def _encode(rec: dict) -> str:
    data = json.dumps(rec, separators=(",", ":"))
    return f"{zlib.crc32(data.encode('utf-8')):08x} {data}\n"


def _decode(line: str) -> Optional[dict]:
    """One checksummed line -> record dict, or None if torn/corrupt."""
    parts = line.split(" ", 1)
    if len(parts) != 2 or len(parts[0]) != 8:
        return None
    try:
        crc = int(parts[0], 16)
    except ValueError:
        return None
    if zlib.crc32(parts[1].encode("utf-8")) != crc:
        return None
    try:
        rec = json.loads(parts[1])
    except ValueError:
        return None
    return rec if isinstance(rec, dict) else None


class RequestJournal:
    """Append-only, checksummed, torn-tail-tolerant request WAL.

    ``fsync`` is one of :data:`JOURNAL_FSYNC_POLICIES`; ``segment_records``
    bounds the active segment before rotation (a seal + a compaction pass
    over the sealed set). ``chaos`` is an optional
    ``chaos.FaultInjector`` (the owning engine attaches
    its own so one seeded schedule covers serving and journal faults
    together)."""

    def __init__(self, journal_dir: str, *, fsync: str = "every_tick",
                 segment_records: int = 512, chaos=None):
        if fsync not in JOURNAL_FSYNC_POLICIES:
            raise ValueError(
                f"journal fsync policy must be one of "
                f"{JOURNAL_FSYNC_POLICIES}, got {fsync!r}"
            )
        if int(segment_records) < 1:
            raise ValueError(
                f"segment_records must be >= 1, got {segment_records}"
            )
        self.dir = str(journal_dir)
        self.fsync = fsync
        self.segment_records = int(segment_records)
        self.chaos = chaos
        os.makedirs(self.dir, exist_ok=True)
        self._fh = None
        self._open_path: Optional[str] = None
        self._open_records = 0
        self._next_index = 1 + max(
            [i for i, _ in self._segments()], default=-1)
        self._dirty = False
        # Retirement state: rids with a journaled terminal row. Rebuilt by
        # replay() when this object is opened over an existing directory.
        self._retired: set[int] = set()
        self._admitted: set[int] = set()
        self._adoption_owner: Optional[str] = None
        self._c = {
            "appends": 0, "bytes_written": 0, "syncs": 0, "rotations": 0,
            "compactions": 0, "compact_aborts": 0, "records_retired": 0,
            "torn_writes": 0, "torn_tails": 0, "corrupt_skipped": 0,
        }

    # -- cross-process adoption -------------------------------------------

    @classmethod
    def adopt(cls, journal_dir: str, owner: str, *, force: bool = False,
              fsync: str = "every_tick", segment_records: int = 512,
              chaos=None) -> "RequestJournal":
        """Open another (dead) engine's journal directory for replay, first
        claiming the adoption sentinel so exactly one party drains it.
        Raises :class:`JournalAdoptionError` if someone else already holds
        the claim (``force=True`` evicts a stale sentinel — only safe when
        the previous adopter is known dead)."""
        jr = cls(journal_dir, fsync=fsync,
                 segment_records=segment_records, chaos=chaos)
        jr.acquire_adoption(owner, force=force)
        return jr

    @property
    def adopted(self) -> bool:
        return self._adoption_owner is not None

    def acquire_adoption(self, owner: str, *, force: bool = False) -> None:
        """Atomically claim this directory's adoption sentinel
        (``O_CREAT | O_EXCL`` — the filesystem arbitrates the race). The
        sentinel names the adopter and pid; it is invisible to segment
        scans (no ``wal_`` prefix) and removed by :meth:`release_adoption`
        or a clean :meth:`close`."""
        path = os.path.join(self.dir, _ADOPTION)
        payload = json.dumps({"owner": str(owner), "pid": os.getpid()},
                             separators=(",", ":")) + "\n"
        for attempt in (0, 1):
            try:
                fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY,
                             0o644)
                break
            except FileExistsError:
                holder = None
                try:
                    with open(path, "r", encoding="utf-8") as f:
                        holder = json.loads(f.read() or "{}")
                except (OSError, ValueError):
                    holder = None
                if not force or attempt:
                    who = (holder or {}).get("owner", "<unreadable>")
                    raise JournalAdoptionError(
                        f"journal {self.dir!r} is already adopted by "
                        f"{who!r} — refusing double adoption (pass "
                        f"force=True only if that adopter is known dead)"
                    )
                try:
                    os.remove(path)
                except OSError:
                    pass
        os.write(fd, payload.encode("utf-8"))
        os.fsync(fd)
        os.close(fd)
        _fsync_dir(self.dir)
        self._adoption_owner = str(owner)

    def adoption_holder(self) -> Optional[dict]:
        """The adoption sentinel's payload (owner, pid) if the directory is
        claimed, else None. Lets a restarting engine notice that a fleet
        router already drained this WAL before it replays anything."""
        try:
            with open(os.path.join(self.dir, _ADOPTION),
                      "r", encoding="utf-8") as f:
                raw = f.read()
        except OSError:
            return None
        try:
            holder = json.loads(raw or "{}")
        except ValueError:
            return {}
        return holder if isinstance(holder, dict) else {}

    def release_adoption(self) -> None:
        """Drop the adoption claim (no-op if this journal never held it)."""
        if self._adoption_owner is None:
            return
        try:
            os.remove(os.path.join(self.dir, _ADOPTION))
        except OSError:
            pass
        self._adoption_owner = None

    # -- segment bookkeeping ----------------------------------------------

    def _segments(self) -> list[tuple[int, str]]:
        """Every journal segment on disk as sorted ``(index, path)`` —
        sealed and crash-orphaned ``.open`` files alike (an index exists as
        exactly one of the two)."""
        out = []
        for fn in os.listdir(self.dir):
            if not fn.startswith(_PREFIX):
                continue
            if fn.endswith(_OPEN):
                idx = fn[len(_PREFIX):-len(_OPEN)]
            elif fn.endswith(_SEALED):
                idx = fn[len(_PREFIX):-len(_SEALED)]
            else:
                continue
            try:
                out.append((int(idx), os.path.join(self.dir, fn)))
            except ValueError:
                continue
        return sorted(out)

    def _ensure_open(self) -> None:
        if self._fh is None:
            name = f"{_PREFIX}{self._next_index:05d}{_OPEN}"
            self._next_index += 1
            self._open_path = os.path.join(self.dir, name)
            self._fh = open(self._open_path, "a", encoding="utf-8")
            self._open_records = 0

    def _seal(self) -> None:
        """Commit the active segment: fsync its bytes, then atomically
        rename away the ``.open`` suffix, then fsync the directory — the
        same stage→fsync→replace discipline as a checkpoint commit."""
        if self._fh is None:
            return
        self._fh.flush()
        os.fsync(self._fh.fileno())
        self._fh.close()
        self._fh = None
        self._dirty = False
        sealed = self._open_path[: -len(_OPEN)] + _SEALED
        os.replace(self._open_path, sealed)
        _fsync_dir(self.dir)
        self._open_path = None
        self._c["rotations"] += 1

    # -- the append path ---------------------------------------------------

    def append(self, rec: dict, *, tick: int = 0, unit: int = 0) -> None:
        """Durably (per policy) append one record. ``tick``/``unit`` key
        the deterministic chaos draw at ``journal_append``."""
        self._ensure_open()
        line = _encode(rec)
        if self.chaos is not None:
            fault = self.chaos.draw("journal_append", tick, unit=unit)
            if fault is not None and fault.kind == "torn_write":
                # A torn append: half the line lands, newline-terminated
                # garbage (the checksum-skip path on replay). The journal
                # detects the short write and re-writes the record whole —
                # durability holds, the corruption machinery gets exercised.
                frag = line[: max(1, len(line) // 2)].rstrip("\n") + "\n"
                self._fh.write(frag)
                self._c["torn_writes"] += 1
                self._c["bytes_written"] += len(frag)
        self._fh.write(line)
        self._c["appends"] += 1
        self._c["bytes_written"] += len(line)
        rid = rec.get("rid")
        t = rec.get("t")
        if rid is not None:
            if t == "terminal":
                self._retired.add(int(rid))
            elif t == "admit":
                self._admitted.add(int(rid))
        if self.fsync == "every_record":
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self._c["syncs"] += 1
        else:
            self._dirty = True
        self._open_records += 1
        if self._open_records >= self.segment_records:
            self._seal()
            self.compact(tick=tick)

    def tick_flush(self) -> None:
        """The per-tick durability point: flush buffered appends, fsync
        under ``every_tick`` (the ``os`` policy stops at the page cache)."""
        if self._fh is None or not self._dirty:
            return
        self._fh.flush()
        if self.fsync == "every_tick":
            os.fsync(self._fh.fileno())
            self._c["syncs"] += 1
        self._dirty = False

    # -- replay + compaction ----------------------------------------------

    def _read_segment(self, path: str, repair: bool = False) -> list[dict]:
        """Records from one segment, skipping corrupt lines. A torn tail
        (no trailing newline) is counted and — with ``repair`` — truncated
        in place so the file is clean for whatever appends next."""
        with open(path, "rb") as f:
            raw = f.read()
        if not raw:
            return []
        keep = len(raw)
        if not raw.endswith(b"\n"):
            self._c["torn_tails"] += 1
            nl = raw.rfind(b"\n")
            keep = nl + 1 if nl >= 0 else 0
            if repair:
                with open(path, "rb+") as f:
                    f.truncate(keep)
        out = []
        for line in raw[:keep].decode("utf-8", errors="replace").splitlines():
            if not line:
                continue
            rec = _decode(line)
            if rec is None:
                self._c["corrupt_skipped"] += 1
                continue
            out.append(rec)
        return out

    def replay(self) -> tuple[list[dict], dict]:
        """Read every record on disk, in append order, repairing torn tails
        as it goes. Returns ``(records, scan)`` where ``scan`` counts what
        recovery needs to report: segments read, records kept, torn tails
        truncated, corrupt lines skipped. Also rebuilds the retirement sets
        so compaction works on a freshly re-opened directory."""
        torn0 = self._c["torn_tails"]
        corrupt0 = self._c["corrupt_skipped"]
        records: list[dict] = []
        segs = self._segments()
        for _, path in segs:
            records.extend(self._read_segment(path, repair=True))
        for rec in records:
            rid = rec.get("rid")
            if rid is None:
                continue
            if rec.get("t") == "terminal":
                self._retired.add(int(rid))
            elif rec.get("t") == "admit":
                self._admitted.add(int(rid))
        return records, {
            "segments": len(segs),
            "records": len(records),
            "torn_tails": self._c["torn_tails"] - torn0,
            "corrupt_skipped": self._c["corrupt_skipped"] - corrupt0,
        }

    def compact(self, *, tick: int = 0) -> int:
        """Merge the SEALED segments into one, dropping the admit / bind /
        progress / recovered records of terminally-statused requests (their
        self-contained terminal rows are kept — they back duplicate-submit
        dedupe and crash-restart cached replies). Unfinished requests'
        records pass through verbatim. Returns the number of records
        retired; 0 when there is nothing to do or the (chaos-injected)
        staging write tears — the sealed segments are untouched either
        way."""
        sealed = [(i, p) for i, p in self._segments() if p.endswith(_SEALED)]
        if len(sealed) < 2 and not self._retired:
            return 0
        if not sealed:
            return 0
        kept: list[dict] = []
        dropped = 0
        for _, path in sealed:
            for rec in self._read_segment(path):
                rid = rec.get("rid")
                t = rec.get("t")
                if t == "progress":
                    toks = {k: v for k, v in (rec.get("toks") or {}).items()
                            if int(k) not in self._retired}
                    if not toks:
                        dropped += 1
                        continue
                    if len(toks) != len(rec.get("toks") or {}):
                        rec = dict(rec, toks=toks)
                elif (rid is not None and int(rid) in self._retired
                        and t != "terminal"):
                    dropped += 1
                    continue
                kept.append(rec)
        staging = os.path.join(self.dir, _COMPACT_STAGING)
        torn = None
        if self.chaos is not None:
            torn = self.chaos.draw("journal_compact", tick)
        try:
            with open(staging, "w", encoding="utf-8") as f:
                for rec in kept:
                    f.write(_encode(rec))
                f.flush()
                if torn is not None and torn.kind == "torn_write":
                    raise OSError("injected torn_write during compaction")
                os.fsync(f.fileno())
        except OSError as e:
            # Abort cleanly: staging removed, every sealed segment intact.
            try:
                os.remove(staging)
            except OSError:
                pass
            self._c["compact_aborts"] += 1
            logger.warning("journal: compaction aborted (%s); sealed segments untouched", e)
            return 0
        # Commit: the merged segment atomically replaces the FIRST sealed
        # segment, then the rest are unlinked. A crash between the two
        # steps leaves duplicate (idempotently re-read) records, never a
        # missing one.
        os.replace(staging, sealed[0][1])
        for _, path in sealed[1:]:
            try:
                os.remove(path)
            except OSError:
                pass
        _fsync_dir(self.dir)
        self._c["compactions"] += 1
        self._c["records_retired"] += dropped
        return dropped

    # -- lifecycle / reporting --------------------------------------------

    def close(self) -> None:
        """Clean shutdown: seal the active segment (full fsync + atomic
        rename) regardless of the append-path fsync policy, and release
        any adoption claim this journal holds."""
        if self._fh is not None:
            self._seal()
        self.release_adoption()

    def stats(self) -> dict:
        """The journal block (``ServingEngine.stats()["journal"]``, with the
        JAX package's keys)."""
        return {
            "dir": self.dir,
            "fsync": self.fsync,
            "appends": self._c["appends"],
            "bytes_written": self._c["bytes_written"],
            "syncs": self._c["syncs"],
            "rotations": self._c["rotations"],
            "compactions": self._c["compactions"],
            "compact_aborts": self._c["compact_aborts"],
            "records_retired": self._c["records_retired"],
            "torn_writes": self._c["torn_writes"],
            "torn_tails": self._c["torn_tails"],
            "corrupt_skipped": self._c["corrupt_skipped"],
            "pending": len(self._admitted - self._retired),
            "retired": len(self._retired),
        }
