"""Schedule-driven ``torch.profiler`` sessions: the port of
``accelerate_tpu/utils/profiling.py``.

The JAX package starts and stops ``jax.profiler`` traces on the step
schedule of ``ProfileKwargs.schedule_option``; :class:`ProfileSession`
keeps that window arithmetic (the look-ahead start, ``cycle_<i>``
directories, ``repeat``, ``skip_first``) and traces each window with one
``torch.profiler.profile``, exported as ``trace.json`` (Chrome trace
format) into the window's directory. Kineto runs one profiler at a time
in a process, so a window must not overlap another profiler.
"""

from __future__ import annotations

import os
import pickle

import torch

from ..logging import get_logger

logger = get_logger(__name__)

TRACE_FILE = "trace.json"
MEMORY_SNAPSHOT_FILE = "memory_snapshot.pickle"


def profiler_activities(activities, device) -> list:
    """``ProfileKwargs.activities`` as ``ProfilerActivity`` members: the
    CPU, and CUDA when ``device`` is a card, by default."""
    from torch.profiler import ProfilerActivity

    if activities is None:
        activities = ["cpu"] + (["cuda"] if torch.device(device).type == "cuda" else [])
    named = {"cpu": ProfilerActivity.CPU, "cuda": ProfilerActivity.CUDA}
    return [named[a.lower()] if isinstance(a, str) else a for a in activities]


class ProfileSession:
    """One ``accelerator.profile()`` context.

    Without ``schedule_option`` the whole context is one window, written
    into ``trace_dir``. With it, call :meth:`step` once per training step;
    the session opens a window at each active-window start and closes it
    after ``active`` steps, ``repeat`` times (0 = unlimited), skipping
    ``skip_first`` then cycling (wait → warmup → active) — torch.profiler
    semantics. ``trace_dirs`` lists the windows written."""

    def __init__(self, handler, trace_dir: str, device="cpu"):
        self.handler = handler
        self.trace_dir = trace_dir
        self.device = torch.device(device)
        self.activities = profiler_activities(handler.activities, self.device)
        sched = handler.schedule_option or {}
        self.scheduled = bool(sched)
        self.wait = int(sched.get("wait", 0))
        self.warmup = int(sched.get("warmup", 0))
        self.active = int(sched.get("active", 1))
        self.repeat = int(sched.get("repeat", 0))
        self.skip_first = int(sched.get("skip_first", 0))
        if self.scheduled and self.active <= 0:
            raise ValueError("schedule_option['active'] must be >= 1")
        self.step_num = 0
        self.cycles_done = 0
        self._tracing = False
        self._prof = None
        self.trace_dirs: list[str] = []

    # -- lifecycle ---------------------------------------------------------

    def enter(self):
        if not self.scheduled:
            self._start(self.trace_dir)
        elif self.skip_first == 0 and self.wait + self.warmup == 0:
            # First active window opens before any step() call arrives.
            self._start(os.path.join(self.trace_dir, "cycle_0"))

    def exit(self):
        if self._tracing:
            self._stop()

    def step(self):
        """Advance the schedule by one training step.

        ``step()`` is called AFTER each training step (torch.profiler
        convention), so window boundaries look one step ahead: the trace
        starts when the NEXT step is the cycle's first active step and stops
        right after the cycle's LAST active step completes — the active
        steps' device work is inside the window.
        """
        if not self.scheduled:
            return
        self.step_num += 1
        pos = self.step_num - self.skip_first  # completed non-skipped steps
        # pos == 0 must fall through: with wait+warmup == 0 the look-ahead
        # start for cycle_0 fires exactly there (enter() only covers
        # skip_first == 0).
        if pos < 0:
            return
        cycle_len = self.wait + self.warmup + self.active
        in_cycle = (pos - 1) % cycle_len
        if self._tracing and in_cycle == cycle_len - 1:
            self._stop()
        # Look ahead: 0-based index of the NEXT step is `pos`.
        nxt_cycle_idx = pos // cycle_len
        nxt_in_cycle = pos % cycle_len
        if self.repeat and nxt_cycle_idx >= self.repeat:
            return
        if not self._tracing and nxt_in_cycle == self.wait + self.warmup:
            self._start(os.path.join(self.trace_dir, f"cycle_{nxt_cycle_idx}"))

    # -- internals ---------------------------------------------------------

    def _start(self, path: str):
        from torch.profiler import profile

        os.makedirs(path, exist_ok=True)
        h = self.handler
        self._prof = profile(activities=self.activities, record_shapes=h.record_shapes,
                             profile_memory=h.profile_memory, with_stack=h.with_stack,
                             with_flops=h.with_flops)
        self._prof.start()
        self._current_dir = path
        self._tracing = True

    def _stop(self):
        prof, self._prof = self._prof, None
        prof.stop()
        self._tracing = False
        prof.export_chrome_trace(os.path.join(self._current_dir, TRACE_FILE))
        self.trace_dirs.append(self._current_dir)
        self.cycles_done += 1
        if self.handler.profile_memory:
            if self.device.type == "cuda":
                with open(os.path.join(self._current_dir, MEMORY_SNAPSHOT_FILE), "wb") as f:
                    pickle.dump(torch.cuda.memory._snapshot(self.device), f)
            else:
                logger.warning_once("profile_memory: the memory snapshot needs a CUDA device")
        if self.handler.on_trace_ready is not None:
            self.handler.on_trace_ready(self)
