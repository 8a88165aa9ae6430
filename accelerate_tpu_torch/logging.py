"""Logging that knows about processes.

Counterpart of ``accelerate_tpu/logging.py``. ``get_logger(name)`` returns
a ``MultiProcessAdapter``: a record is logged on the main process only
unless the call passes ``main_process_only=False``; ``in_order=True`` logs
it on every process in rank order, with a barrier after each rank;
``warning_once`` logs a message with its arguments once per process.
``ACCELERATE_LOG_LEVEL`` sets the named logger's level when ``log_level``
is not given.
"""

from __future__ import annotations

import logging
import os


class MultiProcessAdapter(logging.LoggerAdapter):
    def log(self, level, msg, *args, **kwargs):
        from .state import PartialState

        if not PartialState._shared_state:
            raise RuntimeError(
                "You must initialize the accelerate state by calling either `PartialState()` "
                "or `Accelerator()` before using the logging utility.")
        main_process_only = kwargs.pop("main_process_only", True)
        in_order = kwargs.pop("in_order", False)
        kwargs.setdefault("stacklevel", 2)
        if not self.isEnabledFor(level):
            return
        state = PartialState()
        if not main_process_only or state.is_main_process:
            msg, kwargs = self.process(msg, kwargs)
            self.logger.log(level, msg, *args, **kwargs)
        elif in_order:
            for i in range(state.num_processes):
                if i == state.process_index:
                    msg, kwargs = self.process(msg, kwargs)
                    self.logger.log(level, msg, *args, **kwargs)
                state.wait_for_everyone()

    def process(self, msg, kwargs):
        from .state import PartialState

        state = PartialState()
        return (f"[RANK {state.process_index}] {msg}" if state.num_processes > 1 else msg), kwargs

    def warning_once(self, msg, *args, **kwargs):
        """``warning`` the first time this message with these arguments is
        seen in the process (a module-level set of keys, so that no adapter
        is kept alive by a cache)."""
        key = _warning_once_key(msg, args, kwargs)
        if key in _WARNED_ONCE:
            return
        _WARNED_ONCE.add(key)
        self.warning(msg, *args, **kwargs)


_WARNED_ONCE: set = set()


def _warning_once_key(msg, args, kwargs) -> str:
    """A string key, so that unhashable arguments dedup too; the message
    alone where an argument's ``repr`` fails."""
    try:
        return repr((str(msg), tuple(map(repr, args)),
                     tuple(sorted((k, repr(v)) for k, v in kwargs.items()))))
    except Exception:
        return str(msg)


def get_logger(name: str, log_level: str = None) -> MultiProcessAdapter:
    """The named logger behind a ``MultiProcessAdapter``; ``log_level`` sets
    that logger's level only, never the root's."""
    if log_level is None:
        log_level = os.environ.get("ACCELERATE_LOG_LEVEL", None)
    logger = logging.getLogger(name)
    if log_level is not None:
        logger.setLevel(log_level.upper())
    return MultiProcessAdapter(logger, {})
