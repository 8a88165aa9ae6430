"""Deprecated alias of ``accelerate_tpu_torch.utils.memory``, kept as the JAX
package keeps its own: importing it warns with a ``FutureWarning``."""

import warnings

from .utils.memory import *  # noqa: F401,F403

warnings.warn(
    "memory_utils has moved to accelerate_tpu_torch.utils.memory; this alias will "
    "be removed in a future release.",
    FutureWarning,
)
