"""Silent data corruption: cross-replica integrity votes, the
redundant-compute probe, the quarantine record, and the serving engine's
decode canary.

Counterpart of ``accelerate_tpu/sdc.py``, with its names and protocol:

- **The digest** (:func:`integrity_digest`). Every prepared step with
  ``FaultToleranceKwargs(sdc=...)`` fingerprints its new parameters and
  grad norm on the card: the sum over the flax tree's leaves (in the JAX
  tree's order, a stacked layer leaf counting once) of ``(i % 31 + 1)``
  times the leaf's fp32 abs-sum, plus the grad norm. The per-tensor
  abs-sums are one ``_foreach_norm(ord=1)``. Under FSDP2 each process sums
  its shards and the sums are added over the shard group, so the digest is
  the whole model's; it is then voted over the replicas (``dp_replicate``
  or DDP), which compute it redundantly. It is read one step late with the
  loss (``fault_tolerance.HostFetch``). Against the JAX digest it agrees
  to fp32 rounding (the sums' orders differ); the vote compares the port's
  own digests bit for bit.
- **The vote** (:func:`vote`, :class:`SDCSentinel`). Every ``vote_every``
  steps the processes allgather their digests over a gloo group
  (``state.allgather_host_floats``) and compare them bit for bit. On a
  mismatch every process re-runs the step on the golden ``(state, batch)``
  captured before the first step and compares its digest with the golden
  one. A clean probe is *transient*: the manager repairs in place
  (rollback to the newest verified checkpoint, or ``repair="broadcast"``:
  the parameters of the lowest majority rank). A probe that reproduces the
  corruption is *sticky*: the process writes ``sdc_quarantine.json`` into
  the project directory and exits ``SDC_EXIT_CODE`` (79).
- **The decode canary** (:class:`DecodeCanary`): a known prompt through the
  engine's own slots every ``every`` ticks, its tokens compared with the
  golden row bit for bit; a mismatch is counted and recorded.
  Quarantining the decode device (``autoscaler=``, ``mark_device_dead``)
  waits for ``autoscale.py`` (ROADMAP.md Queue A item 12.5).

The golden snapshot lives on the device: the parameters, the optimizer's
state, the step count, the loss scale, the extra state and the RNG states
are cloned, and a probe swaps them in, runs the step and swaps the live
state back. A probe, and the golden capture before the first step, each
cost one step plus those copies.

Off by default: nothing here runs unless ``FaultToleranceKwargs(sdc=...)``
arms the sentinel or a :class:`DecodeCanary` is attached to an engine.
"""

from __future__ import annotations

import copy
import json
import logging
import os
import platform
import re
import time
import zlib
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from .state import PartialState
from .utils.constants import SDC_EXIT_CODE, SDC_QUARANTINE_FILE

logger = logging.getLogger(__name__)

__all__ = [
    "DecodeCanary",
    "SDCConfig",
    "SDCError",
    "SDCSentinel",
    "flip_float32",
    "integrity_digest",
    "load_quarantine",
    "record_quarantine",
    "vote",
]

_AUTOSCALE_ITEM = "ROADMAP.md Queue A item 12.5 (autoscale.py)"


class SDCError(RuntimeError):
    """SDC handling cannot proceed (a transient repair found no verified
    checkpoint)."""

    exit_code = SDC_EXIT_CODE


@dataclass
class SDCConfig:
    """The sentinel's settings, as an instance or a dict of these fields in
    ``FaultToleranceKwargs(sdc=...)``: ``vote_every`` steps between votes
    (two or more processes); ``repair`` of a transient verdict,
    ``"rollback"`` or ``"broadcast"``; ``max_repairs`` before the next flag
    on a rank convicts it; ``probe`` ``"golden"`` or ``"off"`` (no probe:
    every mismatch is transient); ``bit``, the float32 mantissa bit a chaos
    ``bit_flip`` flips by default."""

    vote_every: int = 8
    repair: str = "rollback"
    max_repairs: int = 2
    probe: str = "golden"
    bit: int = 5

    def __post_init__(self):
        self.vote_every = int(self.vote_every)
        if self.vote_every < 1:
            raise ValueError(f"vote_every must be >= 1, got {self.vote_every}")
        if self.repair not in ("rollback", "broadcast"):
            raise ValueError(f"repair must be 'rollback' or 'broadcast', got {self.repair!r}")
        if self.probe not in ("golden", "off"):
            raise ValueError(f"probe must be 'golden' or 'off', got {self.probe!r}")
        self.max_repairs = int(self.max_repairs)
        if self.max_repairs < 0:
            raise ValueError(f"max_repairs must be >= 0, got {self.max_repairs}")
        self.bit = int(self.bit)
        if not 0 <= self.bit < 23:
            raise ValueError(f"bit must be a float32 mantissa bit (0..22), got {self.bit}")


# ----------------------------------------------------------------------
# Digest, vote, bit flip
# ----------------------------------------------------------------------

_STACKED = re.compile(r"^(.+)_(\d+)$")


def _leaf_keys(module: torch.nn.Module, names: list) -> list:
    """Each parameter's leaf of the JAX package's flax tree, as a sortable
    tuple of path components: the converter's name (``models/convert.py``)
    with a layer index folded into its stack (``layers_3`` -> ``layers``)
    when the config scans its layers, as the JAX tree stacks them."""
    from .models.convert import flax_converter

    conv = flax_converter(module)
    cfg = getattr(module, "config", None)
    flax = [conv.flax_name(cfg, n) if conv is not None else n.replace(".", "/") for n in names]
    if not getattr(cfg, "scan_layers", False):
        return [tuple(f.split("/")) for f in flax]
    keys = []
    for f in flax:
        keys.append(tuple(m.group(1) if (m := _STACKED.match(c)) else c for c in f.split("/")))
    return keys


class DigestPlan:
    """The weights of one model's parameters in the digest: each parameter's
    flax leaf index ``i`` gives it ``i % 31 + 1``. Made once per model; the
    weights of the whole parameters and of each sharded layout are kept on
    the device, so a step copies nothing to it."""

    def __init__(self, module: torch.nn.Module):
        named = [(n, p) for n, p in module.named_parameters() if p.is_floating_point()]
        keys = _leaf_keys(module, [n for n, _ in named])
        order = {k: i for i, k in enumerate(sorted(set(keys)))}
        weights = [float(order[k] % 31 + 1) for k in keys]
        groups: dict = {}
        for (_, p), w in zip(named, weights):
            key = (p.device_mesh, tuple(p.placements)) if isinstance(p, DTensor) else None
            params, ws = groups.setdefault(key, ([], []))
            params.append(p)
            ws.append(w)
        device = named[0][1].device
        self.groups = [(key, params, torch.tensor(ws, dtype=torch.float32, device=device))
                       for key, (params, ws) in groups.items()]
        self.device = device


def integrity_digest(plan: DigestPlan, grad_norm) -> torch.Tensor:
    """The step's fp32 fingerprint on the parameters' device:
    ``sum_i w_i |leaf_i|_1 + grad_norm`` (module docstring). Shards of a
    split parameter are summed over the mesh dims that split them."""
    from .parallel.tp import splits

    acc = torch.zeros((), dtype=torch.float32, device=plan.device)
    for key, params, weights in plan.groups:
        local = [p.detach().to_local() if isinstance(p, DTensor) else p.detach()
                 for p in params]
        norms = torch._foreach_norm(local, 1)
        part = (torch.stack([n.float() for n in norms]) * weights).sum()
        if key is not None:
            mesh, placements = key
            for d, pl in enumerate(placements):
                if splits(pl) and mesh.size(d) > 1:
                    torch.distributed.all_reduce(part, group=mesh.get_group(d))
        acc = acc + part
    return acc + torch.as_tensor(grad_norm, dtype=torch.float32, device=plan.device)


def vote(digests) -> dict:
    """Majority vote of the replicas' digests, compared bit for bit (float64
    byte patterns): ``{"agree", "has_majority", "majority_ranks",
    "outliers"}``; with no strict majority every rank is an outlier."""
    vals = [np.float64(v) for v in digests]
    n = len(vals)
    groups: dict = {}
    for i, v in enumerate(vals):
        groups.setdefault(v.tobytes(), []).append(i)
    if len(groups) == 1:
        return {"agree": True, "has_majority": True, "majority_ranks": list(range(n)),
                "outliers": []}
    best = max(groups.values(), key=lambda g: (len(g), -g[0]))
    if 2 * len(best) > n:
        return {"agree": False, "has_majority": True, "majority_ranks": list(best),
                "outliers": sorted(set(range(n)) - set(best))}
    return {"agree": False, "has_majority": False, "majority_ranks": [],
            "outliers": list(range(n))}


def flip_float32(value: float, bit: int = 5) -> float:
    """``value`` with one mantissa bit of its float32 flipped: finite and
    wrong."""
    a = np.array(np.float32(value))
    a.view(np.int32)[...] ^= np.int32(1) << np.int32(int(bit))
    return float(a)


# ----------------------------------------------------------------------
# Quarantine record
# ----------------------------------------------------------------------


def _quarantine_path(project_dir: str) -> str:
    return os.path.join(project_dir, SDC_QUARANTINE_FILE)


def load_quarantine(project_dir: Optional[str]) -> dict:
    """``{"hosts": [...]}`` from the project directory; empty when there is
    none or it is unreadable (a torn record never blocks a relaunch)."""
    if not project_dir:
        return {"hosts": []}
    try:
        with open(_quarantine_path(project_dir)) as f:
            rec = json.load(f)
        if isinstance(rec, dict) and isinstance(rec.get("hosts"), list):
            return rec
    except (OSError, ValueError):
        pass
    return {"hosts": []}


def record_quarantine(project_dir: str, entry: dict) -> dict:
    """Append one conviction to the record, atomically (tmp + rename)."""
    rec = load_quarantine(project_dir)
    rec["hosts"].append(entry)
    os.makedirs(project_dir, exist_ok=True)
    path = _quarantine_path(project_dir)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(rec, f, indent=2)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return rec


# ----------------------------------------------------------------------
# The golden snapshot: a train state's tensors cloned on their device
# ----------------------------------------------------------------------


class _Snapshot:
    """Clones of what a step changes: parameters, the optimizer's state
    (its ``state_dict``: moments, counts, rates), the step count, the loss
    scale, the extra state, and the CPU and CUDA RNG states."""

    def __init__(self, train_state):
        self.train_state = train_state
        module, opt = train_state.model.module, train_state.optimizer
        self.params = [p.detach().clone() for p in module.parameters()]
        self.opt = copy.deepcopy(opt.state_dict())
        self.step = (train_state.step.clone() if torch.is_tensor(train_state.step)
                     else train_state.step)
        ls = train_state.loss_scale
        self.loss_scale = None if ls is None else copy.deepcopy(ls)
        from .train_state import tree_items

        self.extra = ({k: v.detach().clone() for k, v in tree_items(train_state.extra_state)}
                      if train_state.extra_state is not None else None)
        self.rng = torch.get_rng_state()
        self.cuda_rng = torch.cuda.get_rng_state_all() if torch.cuda.is_initialized() else None

    @torch.no_grad()
    def restore(self) -> None:
        st = self.train_state
        module = st.model.module
        for p, saved in zip(module.parameters(), self.params):
            p.data.copy_(saved)
        st.optimizer.load_state_dict(copy.deepcopy(self.opt))
        if torch.is_tensor(st.step):
            st.step.copy_(self.step)
        else:
            st.step = self.step
        if self.loss_scale is not None:
            st.loss_scale.__dict__.update(copy.deepcopy(self.loss_scale).__dict__)
        if self.extra is not None:
            from .train_state import tree_items

            live = dict(tree_items(st.extra_state))
            torch._foreach_copy_([live[k] for k in self.extra], list(self.extra.values()))
        torch.set_rng_state(self.rng)
        if self.cuda_rng is not None:
            torch.cuda.set_rng_state_all(self.cuda_rng)


# ----------------------------------------------------------------------
# The training-side sentinel
# ----------------------------------------------------------------------


class SDCSentinel:
    """The manager's SDC half (``FaultToleranceKwargs(sdc=...)``): it owns
    the vote, the probe and the verdict; the manager takes the repair."""

    def __init__(self, manager, config: SDCConfig):
        self.manager = manager
        self.config = config
        self._flip = None  # the bit_flip drawn for the step being staged
        self._sticky = False  # an injected sticky fault: probes corrupt too
        self._golden = None  # {"step_fn", "state", "batch", "digest"}
        self._plans: dict = {}
        self.repairs_done = 0
        self.peer_quarantined = False
        self._majority: list = []
        self._stats = dict.fromkeys(("digests", "votes", "mismatches", "probes", "probes_failed",
                                     "repairs", "quarantines"), 0)
        self.timings = {"vote_s": 0.0, "votes": 0}
        hub = getattr(getattr(manager.accelerator, "telemetry", None), "hub", None)
        if hub is not None:
            hub.register_provider("sdc", self.summary, replace=True)
        self.quarantined_hosts = list(load_quarantine(
            getattr(manager.accelerator, "project_dir", None)).get("hosts", []))
        if self.quarantined_hosts:
            logger.warning("sdc: %d host(s) quarantined by earlier runs: %s",
                           len(self.quarantined_hosts),
                           [h.get("host") for h in self.quarantined_hosts])

    # -- the digest in the step --------------------------------------------

    def digest(self, model, grad_norm) -> torch.Tensor:
        plan = self._plans.get(id(model))
        if plan is None:
            plan = self._plans[id(model)] = DigestPlan(model.module)
        return integrity_digest(plan, grad_norm)

    # -- golden snapshot -----------------------------------------------------

    @property
    def needs_golden(self) -> bool:
        return self.config.probe == "golden" and self._golden is None

    def capture_golden(self, step_fn, state, batch) -> None:
        """Before the first step: clone ``(state, batch)`` and run the probe
        once, recording the golden digest; the live state is put back."""
        self._golden = {"step_fn": step_fn, "state": _Snapshot(state),
                        "batch": {k: v.detach().clone() if torch.is_tensor(v) else v
                                  for k, v in batch.items()},
                        "digest": None}
        self._golden["digest"] = self._run_golden_step()
        logger.info("sdc: golden probe captured (digest=%r)", self._golden["digest"])

    def _run_golden_step(self) -> float:
        g = self._golden
        state = g["state"].train_state
        live = _Snapshot(state)
        g["state"].restore()
        try:
            _, metrics = g["step_fn"](state, dict(g["batch"]))
            return float(metrics["sdc_digest"])
        finally:
            live.restore()

    # -- chaos hook ----------------------------------------------------------

    def note_bit_flip(self, fault) -> None:
        """A ``train_step``/``bit_flip`` draw on this rank: the step's
        observed digest is flipped; ``sticky`` corrupts every probe too."""
        self._flip = fault
        if str((fault.extra or {}).get("mode", "transient")) == "sticky":
            self._sticky = True

    def take_flip(self):
        flip, self._flip = self._flip, None
        return flip

    # -- the vote and the probe ------------------------------------------------

    def observe(self, digest: float, tick: int, flip) -> Optional[str]:
        """Step ``tick``'s digest, read one step late. On vote ticks the
        collective protocol runs; ``"repair"`` asks the manager to repair a
        transient corruption; a sticky one exits here."""
        self._stats["digests"] += 1
        if flip is not None:
            digest = flip_float32(digest, bit=int((flip.extra or {}).get("bit", self.config.bit)))
        state = PartialState()
        if state.num_processes < 2 or tick % self.config.vote_every:
            return None
        t0 = time.perf_counter()
        table = state.allgather_host_floats([digest])
        self._stats["votes"] += 1
        verdict = vote(table[:, 0])
        self.timings["vote_s"] += time.perf_counter() - t0
        self.timings["votes"] += 1
        if verdict["agree"]:
            return None
        self._stats["mismatches"] += 1
        self._majority = verdict["majority_ranks"]
        rank = state.process_index
        flagged = rank in verdict["outliers"]
        self.manager._event("sdc_vote_mismatch", tick=tick, rank=rank, flagged=flagged,
                            has_majority=verdict["has_majority"], outliers=verdict["outliers"],
                            digests=[float(v) for v in table[:, 0]])
        logger.warning("sdc: cross-replica digest mismatch at tick %d (outliers %s, "
                       "majority=%s): running the redundant-compute probe.", tick,
                       verdict["outliers"], verdict["has_majority"])
        # The probe re-runs the step, whose collectives need every rank.
        failed = self._run_probe()
        if flagged and not failed and self.repairs_done >= self.config.max_repairs:
            failed = True
            logger.error("sdc: rank %d flagged again after %d repair(s): escalating to a sticky "
                         "conviction.", rank, self.repairs_done)
        verdicts = state.allgather_host_floats([1.0 if flagged else 0.0, 1.0 if failed else 0.0])
        sticky_ranks = [i for i in range(verdicts.shape[0]) if verdicts[i, 1] > 0.5]
        if sticky_ranks:
            if rank in sticky_ranks:
                self._convict(tick)  # never returns
            self.peer_quarantined = True
            self.manager._event("sdc_peer_quarantined", tick=tick, ranks=sticky_ranks)
            logger.error("sdc: peer rank(s) %s convicted of sticky corruption; leave the loop "
                         "(fault_tolerance.sdc.peer_quarantined is set).", sticky_ranks)
            return None
        return "repair"

    def _run_probe(self) -> bool:
        """The golden step again, its digest against the golden one bit for
        bit; True when the probe failed (the corruption reproduces)."""
        if self._golden is None or self._golden.get("digest") is None:
            return False
        self._stats["probes"] += 1
        d = self._run_golden_step()
        if self._sticky:
            d = flip_float32(d, bit=self.config.bit)
        ok = np.float64(d).tobytes() == np.float64(self._golden["digest"]).tobytes()
        if not ok:
            self._stats["probes_failed"] += 1
            logger.error("sdc: redundant-compute probe FAILED (golden=%r got=%r): the "
                         "corruption reproduces on known-good inputs.",
                         self._golden["digest"], d)
        return not ok

    def note_repair(self, mode: str) -> None:
        self.repairs_done += 1
        self._stats["repairs"] += 1
        logger.warning("sdc: transient corruption repaired via %s (%d/%d repairs used).", mode,
                       self.repairs_done, self.config.max_repairs)

    @torch.no_grad()
    def broadcast_params(self, slot: int, majority_ranks: Optional[list] = None):
        """``repair="broadcast"``: every parameter (this process's tensor:
        whole under DDP, its shard under FSDP2, equal across replicas) from
        the lowest majority rank; None without a majority (the caller rolls
        back)."""
        ranks = majority_ranks if majority_ranks is not None else self._majority
        if not ranks:
            return None
        acc = self.manager.accelerator
        src = min(ranks)
        st = acc._train_states[slot]
        for p in st.model.module.parameters():
            t = p.to_local() if isinstance(p, DTensor) else p.data
            torch.distributed.broadcast(t, src=src)
        return st

    # -- conviction ------------------------------------------------------------

    def _convict(self, tick: int) -> None:
        """Sticky on this rank: write the quarantine record, flush the
        telemetry and the injector's log, exit ``SDC_EXIT_CODE``."""
        from .chaos import flush_injected_log
        from .profiler import dump_flight

        acc = self.manager.accelerator
        self._stats["quarantines"] += 1
        entry = {"process_index": int(acc.process_index), "host": platform.node(),
                 "step": int(acc._train_states[0].step) if acc._train_states else 0,
                 "tick": int(tick),
                 "reason": "redundant-compute probe reproduced the corruption",
                 "time": time.time()}
        project_dir = getattr(acc, "project_dir", None)
        if project_dir:
            record_quarantine(project_dir, entry)
        logger.error("sdc: STICKY corruption on rank %d (%s): quarantined; exiting %d.",
                     entry["process_index"], entry["host"], SDC_EXIT_CODE)
        self.manager._event("sdc_quarantine", **entry)
        tel = getattr(acc, "telemetry", None)
        flush_injected_log(self.manager.chaos, tel)
        dump_flight(tel, SDC_EXIT_CODE, reason=f"sticky SDC conviction on rank "
                                               f"{entry['process_index']} at step {entry['step']}")
        os._exit(SDC_EXIT_CODE)

    def summary(self) -> dict:
        """The ``sdc`` telemetry block."""
        return {"vote_every": self.config.vote_every, "repair": self.config.repair,
                **self._stats,
                "quarantined_hosts": [h.get("host") for h in self.quarantined_hosts],
                "peer_quarantined": self.peer_quarantined}


# ----------------------------------------------------------------------
# The serving engine's decode canary
# ----------------------------------------------------------------------


class DecodeCanary:
    """A known prompt through the live engine every ``every`` ticks.
    ``warmup()`` runs one probe to the end and keeps its row as the golden;
    afterwards the engine's tick submits a probe every ``every`` ticks,
    takes its row out of the finished queue before ``poll()`` sees it, and
    compares its tokens with the golden row bit for bit. A mismatch is
    counted, logged and recorded in the telemetry. The probe samples from
    its own fixed generator, so its tokens are deterministic for fixed
    weights. ``autoscaler`` (quarantining the decode device through
    ``mark_device_dead``) is refused: it comes with ``autoscale.py``."""

    _RNG_SEED = 0x5DC

    def __init__(self, engine, *, every: int = 64, prompt=None, max_new_tokens: int = 4,
                 autoscaler=None, telemetry=None):
        if autoscaler is not None:
            raise NotImplementedError(
                "DecodeCanary(autoscaler=...): quarantining the decode device through "
                f"mark_device_dead is not ported yet ({_AUTOSCALE_ITEM})")
        self.engine = engine
        self.every = max(1, int(every))
        self.max_new_tokens = int(max_new_tokens)
        self.prompt = (np.asarray(prompt, np.int64) if prompt is not None
                       else np.arange(1, 7, dtype=np.int64))
        if self.prompt.ndim != 1 or self.prompt.size == 0:
            raise ValueError("canary prompt must be a non-empty 1-D token row")
        self.autoscaler = None
        self.telemetry = telemetry
        self._golden: Optional[list] = None
        self._inflight: Optional[int] = None
        self._last_row_tokens: Optional[list] = None
        self.probe_rids: list = []
        self._stats = dict.fromkeys(("probes", "mismatches", "quarantines", "suppressed_rows"), 0)
        engine.attach_sdc_canary(self)

    def warmup(self) -> None:
        """One probe to the end; its row is the golden. Call after
        ``engine.warmup()`` and before real traffic."""
        rid = self._submit()
        for _ in range(10_000):
            if self._inflight is None:
                break
            self.engine.tick()
        if self._inflight is not None:
            self._inflight = None
            raise SDCError(f"canary warmup probe {rid} never completed")
        if self._last_row_tokens is None:
            raise SDCError(f"canary warmup probe {rid} finished without a row")
        self._golden = self._last_row_tokens
        self._stats["probes"] = 0
        self._stats["suppressed_rows"] = 0
        logger.info("sdc: decode canary armed (golden digest %08x, %d tokens)",
                    self.golden_digest or 0, len(self._golden))

    @property
    def armed(self) -> bool:
        return self._golden is not None

    @property
    def golden_digest(self) -> Optional[int]:
        if self._golden is None:
            return None
        return zlib.crc32(np.asarray(self._golden, np.int64).tobytes())

    def on_tick(self) -> None:
        """The engine's end-of-tick hook."""
        self._last_row_tokens = None
        if self._inflight is not None:
            row = self._pop_row(self._inflight)
            if row is not None:
                self._inflight = None
                self._last_row_tokens = [int(t) for t in np.asarray(row["tokens"]).ravel()]
                self._stats["probes"] += 1
                if self._golden is not None:
                    self._check(row, self._last_row_tokens)
        if (self._golden is not None and self._inflight is None
                and self.engine._stats["ticks"] % self.every == 0):
            self._submit()

    def _submit(self) -> int:
        gen = torch.Generator(device=self.engine.device).manual_seed(self._RNG_SEED)
        self._inflight = self.engine.submit(self.prompt.copy(),
                                            max_new_tokens=self.max_new_tokens, generator=gen)
        self.probe_rids.append(self._inflight)
        return self._inflight

    def _pop_row(self, rid: int) -> Optional[dict]:
        for row in self.engine._finished:
            if row["id"] == rid:
                self.engine._finished.remove(row)
                self._stats["suppressed_rows"] += 1
                return row
        return None

    def _check(self, row: dict, toks: list) -> None:
        if row["status"] == "ok" and toks == self._golden:
            return
        self._stats["mismatches"] += 1
        got = zlib.crc32(np.asarray(toks, np.int64).tobytes())
        logger.error("sdc: decode canary mismatch (status=%s golden=%08x got=%08x): silent "
                     "decode corruption.", row["status"], self.golden_digest or 0, got)
        if self.telemetry is not None:
            try:
                self.telemetry.record_event(
                    "sdc_canary_mismatch", tick=self.engine._stats["ticks"],
                    status=row["status"], golden_digest=self.golden_digest, got_digest=got)
            except Exception:  # observability never stops serving
                pass

    def reset_counters(self) -> None:
        """The engine's ``reset_metrics()`` hook: zero the counters, keep
        the golden row."""
        for k in self._stats:
            self._stats[k] = 0
        self._inflight = None

    def summary(self) -> dict:
        """The engine's ``stats()["sdc"]`` block."""
        return {"every": self.every, "armed": self.armed, "golden_digest": self.golden_digest,
                **self._stats}
