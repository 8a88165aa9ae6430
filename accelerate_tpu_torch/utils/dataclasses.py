"""Plugin dataclasses: the subset of ``accelerate_tpu/utils/dataclasses.py``
that the training loop and the serving engine need, with torch dtypes.

The fields keep the JAX package's names and defaults. A field the port does
not act on yet raises ``NotImplementedError`` naming its ROADMAP.md item
when it is set away from its default, so no setting is silently ignored."""

from __future__ import annotations

import copy
import enum
import json
from dataclasses import dataclass, fields
from datetime import timedelta
from typing import Any, Callable, Optional

import torch

_REDUCED_PRECISION_ITEM = (
    "ROADMAP.md Queue A item 9: the JAX package defines MixedPrecisionPolicy's param_dtype, "
    "reduce_dtype and output_dtype and FullyShardedDataParallelPlugin.mixed_precision_policy "
    "but never reads them, so there is nothing to port; the masters, the gradient "
    "reductions and the outputs stay fp32")
_CONTROL_PLANE_ITEM = "ROADMAP.md Queue A item 12 (control plane)"


def _refuse_non_defaults(obj, item, honoured: tuple = ()) -> None:
    """Raise for the first field outside ``honoured`` that is set away from
    its default. ``item`` names the ROADMAP item: one string, or a dict from
    field name to string."""
    for f in fields(obj):
        if f.name not in honoured and getattr(obj, f.name) != f.default:
            where = item[f.name] if isinstance(item, dict) else item
            raise NotImplementedError(
                f"{type(obj).__name__}({f.name}={getattr(obj, f.name)!r}) is not "
                f"ported yet ({where})")


class EnumWithContains(enum.EnumMeta):
    """``value in Enum``: whether the value names a member."""

    def __contains__(cls, item):
        try:
            cls(item)
        except ValueError:
            return False
        return True


class BaseEnum(str, enum.Enum, metaclass=EnumWithContains):
    """A string enum whose members are their values wherever the port takes
    the string (``str(member)`` is the value)."""

    def __str__(self):
        return self.value

    @classmethod
    def list(cls):
        return list(map(str, cls))


class PrecisionType(BaseEnum):
    NO = "no"
    BF16 = "bf16"
    FP16 = "fp16"
    FP8 = "fp8"


class LoggerType(BaseEnum):
    """Tracker identifiers ``Accelerator(log_with=...)`` takes, beside
    their strings (``tracking.filter_trackers``)."""

    ALL = "all"
    TENSORBOARD = "tensorboard"
    WANDB = "wandb"
    MLFLOW = "mlflow"
    COMETML = "comet_ml"
    AIM = "aim"
    CLEARML = "clearml"
    DVCLIVE = "dvclive"
    SWANLAB = "swanlab"
    TRACKIO = "trackio"


class SaveFormat(BaseEnum):
    SAFETENSORS = "safetensors"
    ORBAX = "orbax"
    MSGPACK = "msgpack"


class FP8Format(BaseEnum):
    E4M3 = "E4M3"
    E5M2 = "E5M2"
    HYBRID = "HYBRID"


class StateDictType(BaseEnum):
    """The checkpoint formats of ``FullyShardedDataParallelPlugin``: the JAX
    package's two and the port's ``torch.distributed.checkpoint`` one."""

    FULL_STATE_DICT = "FULL_STATE_DICT"
    SHARDED_STATE_DICT = "SHARDED_STATE_DICT"
    DISTRIBUTED_STATE_DICT = "DISTRIBUTED_STATE_DICT"


class KwargsHandler:
    """Base of the handlers ``Accelerator(kwargs_handlers=[...])`` takes:
    ``to_kwargs()`` is the fields set away from their defaults."""

    def to_dict(self):
        return copy.deepcopy(self.__dict__)

    def to_kwargs(self):
        default_dict = self.__class__().to_dict()
        return {k: v for k, v in self.to_dict().items() if default_dict[k] != v}


@dataclass
class ProfileKwargs(KwargsHandler):
    """``Accelerator.profile()``'s settings (``utils/profiling.py``), the JAX
    package's fields. Each traced window is one ``torch.profiler.profile``:

    - ``activities``: ``"cpu"``/``"cuda"`` (or ``ProfilerActivity``
      members); default the CPU, and CUDA when the Accelerator is on a card;
    - ``schedule_option``: ``wait``/``warmup``/``active``/``repeat``/
      ``skip_first`` (torch.profiler's schedule) over the session's
      ``step()`` calls, one window directory ``cycle_<i>`` each; without
      it the whole context is one window;
    - ``on_trace_ready(session)``: called after each window is written;
    - ``record_shapes``, ``with_stack``, ``with_flops``: passed to the
      profiler;
    - ``profile_memory``: the profiler's allocation events, and a
      ``torch.cuda.memory`` snapshot (``memory_snapshot.pickle``) beside
      each trace;
    - ``output_trace_dir``: where the windows go (default the project
      directory)."""

    activities: Optional[list] = None
    schedule_option: Optional[dict] = None
    on_trace_ready: Optional[Callable] = None
    record_shapes: bool = False
    profile_memory: bool = False
    with_stack: bool = False
    with_flops: bool = False
    output_trace_dir: Optional[str] = None


@dataclass
class TelemetryKwargs(KwargsHandler):
    """Step telemetry (``telemetry.py``), with the JAX package's fields and
    defaults. Passing the handler turns it on; without it every hook is one
    ``is None`` check.

    - ``sync_timing``: ``torch.cuda.synchronize()`` before the step timer
      stops (the device's wall time, at the cost of the host running
      ahead); off, the step's time is the host's dispatch time, which
      converges to the device's once the card's queue is full.
    - ``log_every``: forward a summary to the trackers every N steps.
    - ``straggler_probe_every``: gather the step times of every process
      every N steps (0: never).
    - ``memory_every``: read the allocator's counters every N steps.
    - ``output_dir``: default ``<project_dir>/telemetry``.
    - ``max_log_bytes``: rotate the per-process JSONL at this size.
    - ``profile``: the device-time profiler (``profiler.py``): ``True``, a
      dict of ``ProfilerConfig`` fields, or a ``ProfilerConfig``.
    - ``tracing``: request tracing; not ported (ROADMAP.md Queue A item
      12)."""

    enabled: bool = True
    sync_timing: bool = False
    log_every: int = 10
    straggler_probe_every: int = 50
    straggler_warn_skew: float = 0.2
    ema_alpha: float = 0.1
    memory_every: int = 1
    output_dir: Optional[str] = None
    max_log_bytes: Optional[int] = 256 * 1024 * 1024
    tracing: Any = None
    profile: Any = None

    def __post_init__(self):
        if self.tracing:  # False and None both mean off, as in the JAX package
            raise NotImplementedError(
                f"TelemetryKwargs(tracing={self.tracing!r}) is not ported yet "
                f"({_CONTROL_PLANE_ITEM}: tracing.py's request tracing)")


@dataclass
class MixedPrecisionPolicy:
    """What dtype each tensor class uses inside the train step.

    Params and optimizer state stay fp32 master copies; compute and
    activations run in ``compute_dtype``; gradients are reduced in
    ``reduce_dtype``. Only ``compute_dtype`` may be changed: the JAX
    package never reads the other three."""

    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    reduce_dtype: Any = torch.float32
    output_dtype: Any = torch.float32

    def __post_init__(self):
        _refuse_non_defaults(self, _REDUCED_PRECISION_ITEM, honoured=("compute_dtype",))

    @classmethod
    def from_mixed_precision(cls, mixed_precision: Optional[str]) -> "MixedPrecisionPolicy":
        """``"fp16"`` computes in float16 (the Accelerator adds dynamic loss
        scaling); ``"fp8"`` in bfloat16, since fp8 acts per matmul (the
        model's ``fp8`` projections, ``ops/fp8.py``)."""
        if mixed_precision in (None, "no"):
            return cls(compute_dtype=torch.float32)
        if mixed_precision in ("bf16", "fp8"):
            return cls(compute_dtype=torch.bfloat16)
        if mixed_precision == "fp16":
            return cls(compute_dtype=torch.float16)
        raise ValueError(f"Unknown mixed precision {mixed_precision}")

    def cast_for_compute(self, tensors: dict) -> dict:
        """Floating tensors cast to the compute dtype (a no-op where they
        already have it, so gradients flow to the masters)."""
        return {
            name: t.to(self.compute_dtype) if t.is_floating_point() else t
            for name, t in tensors.items()
        }


@dataclass
class GradScalerKwargs(KwargsHandler):
    """Dynamic loss scaling under ``mixed_precision="fp16"``
    (``train_state.DynamicLossScale``), the JAX package's fields and
    defaults. ``enabled=False`` trains fp16 without scaling."""

    init_scale: float = 65536.0
    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    growth_interval: int = 2000
    enabled: bool = True


_FP8_FORMATS = tuple(FP8Format.list())


@dataclass
class FP8RecipeKwargs(KwargsHandler):
    """The fp8 recipe of ``Accelerator.fp8_dot_general``
    (``ops/fp8.py``): ``fp8_format`` (HYBRID: e4m3 forward, e5m2 backward),
    ``backend`` (TE and AO select the native fp8 product, QDQ the
    quantize-dequantize simulation, AUTO the default; MSAMP raises) and
    ``use_during_eval``. ``amax_history_len``, ``amax_compute_algo`` and
    ``margin`` are taken and unused, as in the JAX package: it scales by
    the current amax of every call, not a delayed history."""

    fp8_format: str = "HYBRID"
    backend: str = "AUTO"
    amax_history_len: int = 16
    amax_compute_algo: str = "max"
    margin: int = 0
    use_during_eval: bool = False

    def __post_init__(self):
        from ..ops.fp8 import backend_to_native

        self.fp8_format = str(self.fp8_format).upper()
        if self.fp8_format not in _FP8_FORMATS:
            raise ValueError(f"fp8_format must be one of {list(_FP8_FORMATS)}")
        self.backend = self.backend.upper()
        backend_to_native(self.backend)  # validates (MSAMP refused)

    @property
    def native_dots(self) -> Optional[bool]:
        """None: the default (``ACCELERATE_FP8_NATIVE``)."""
        from ..ops.fp8 import backend_to_native

        return backend_to_native(self.backend)


@dataclass
class InitProcessGroupKwargs(KwargsHandler):
    """The JAX package's fields, taken and not read, as there: the process
    group is joined from torchrun's environment (``state.py``)."""

    backend: Optional[str] = None
    init_method: Optional[str] = None
    timeout: Optional[timedelta] = None


@dataclass
class AutocastKwargs(KwargsHandler):
    """The JAX package's fields, taken and not read, as there: the compute
    dtype is the precision policy's (``Accelerator.autocast``)."""

    enabled: bool = True
    cache_enabled: bool = None


@dataclass
class GradientAccumulationPlugin:
    """How ``Accelerator.accumulate`` windows the imperative loop.

    - ``num_steps``: microbatches per optimizer step.
    - ``adjust_scheduler``: the JAX package's flag; a schedule here is a
      pure function of the optimizer's update count, so it needs no
      adjusting either way.
    - ``sync_with_dataloader``: the last batch of a loader ends the window,
      however many microbatches it holds.
    - ``sync_each_batch``: reduce the gradients over the processes on every
      microbatch (memory held flat at the price of the communication); the
      optimizer still steps only when the window ends."""

    num_steps: int = None
    adjust_scheduler: bool = True
    sync_with_dataloader: bool = True
    sync_each_batch: bool = False

    def to_kwargs(self) -> dict:
        """The fields set away from their defaults (``GradientState.plugin_kwargs``)."""
        return {f.name: getattr(self, f.name) for f in fields(self)
                if getattr(self, f.name) != f.default}


class ShardingStrategy(BaseEnum):
    """The FSDP sharding strategies, with the JAX package's names; the
    integer forms ``"1"``-``"4"`` name them in this order."""

    FULL_SHARD = "FULL_SHARD"        # parameters, gradients, optimizer state (ZeRO-3)
    SHARD_GRAD_OP = "SHARD_GRAD_OP"  # gradients and optimizer state (ZeRO-2)
    NO_SHARD = "NO_SHARD"            # replicated (DDP)
    HYBRID_SHARD = "HYBRID_SHARD"    # sharded within dp_shard, replicated across dp_replicate


_STRATEGY_CODES = {"1": "FULL_SHARD", "2": "SHARD_GRAD_OP", "3": "NO_SHARD", "4": "HYBRID_SHARD"}
_STATE_DICT_TYPES = tuple(StateDictType.list())


@dataclass
class FullyShardedDataParallelPlugin:
    """How ``prepare`` shards a model over the process group
    (``parallel/fsdp.py``); alone, there is nothing to shard.

    - ``sharding_strategy``: ``FULL_SHARD`` and ``HYBRID_SHARD`` are FSDP2
      over the data-parallel mesh (HSDP when ``dp_replicate × sp`` is wider
      than 1); ``SHARD_GRAD_OP`` is FSDP2 without resharding after the
      forward (torch's ZeRO-2); ``NO_SHARD`` replicates under DDP. The four
      names or ``"1"``-``"4"``.
    - ``min_weight_size_to_shard``: parameters with fewer elements, and
      every parameter of rank below 2, stay whole on every process, as
      the JAX plan keeps them replicated.
    - ``reshard_after_forward``, ``cpu_offload`` (``CPUOffloadPolicy``),
      ``ignored_params`` (regular expressions on parameter names, kept
      whole) and ``activation_checkpointing`` (the model's remat).
    - ``state_dict_type``: the checkpoint's format. ``SHARDED_STATE_DICT``
      (5 GB safetensors shards plus an index) or ``FULL_STATE_DICT`` (one
      file), gathered from the shards either way; ``DISTRIBUTED_STATE_DICT``
      writes every process's own shards with ``torch.distributed.checkpoint``
      (``checkpointing.py``).

    ``mixed_precision_policy`` raises, naming its ROADMAP.md item."""

    sharding_strategy: str = "FULL_SHARD"
    reshard_after_forward: bool = True
    min_weight_size_to_shard: int = 2**11
    cpu_offload: bool = False
    state_dict_type: str = "SHARDED_STATE_DICT"
    activation_checkpointing: bool = False
    mixed_precision_policy: Optional[MixedPrecisionPolicy] = None
    ignored_params: Optional[list] = None

    def __post_init__(self):
        _refuse_non_defaults(self, _REDUCED_PRECISION_ITEM, honoured=tuple(
            f.name for f in fields(self) if f.name != "mixed_precision_policy"))
        strategy = str(self.sharding_strategy).upper()
        self.sharding_strategy = _STRATEGY_CODES.get(strategy, strategy)
        if self.sharding_strategy not in ShardingStrategy.list():
            raise ValueError(f"sharding_strategy must be one of {ShardingStrategy.list()}")
        self.state_dict_type = str(self.state_dict_type).upper()
        if self.state_dict_type not in _STATE_DICT_TYPES:
            raise ValueError(f"Unknown state_dict_type {self.state_dict_type!r}")

    @property
    def shards_params(self) -> bool:
        return self.sharding_strategy in ("FULL_SHARD", "HYBRID_SHARD")

    @property
    def shards_grads_and_opt(self) -> bool:
        return self.sharding_strategy != "NO_SHARD"


@dataclass
class DeepSpeedPlugin:
    """A DeepSpeed ZeRO configuration read as a sharding strategy, as the
    JAX package reads it: stage 0 is ``NO_SHARD``, 1 and 2 ``SHARD_GRAD_OP``,
    3 ``FULL_SHARD`` (``to_fsdp_plugin``). ``Accelerator(deepspeed_plugin=)``
    takes its ``gradient_accumulation_steps`` and ``gradient_clipping``
    where the caller sets neither; ``mixed_precision`` is only carried (pass
    it to the Accelerator yourself). Offload to ``"cpu"`` of the optimizer
    or the parameters becomes ``cpu_offload``."""

    zero_stage: int = 2
    offload_optimizer_device: str = "none"
    offload_param_device: str = "none"
    gradient_accumulation_steps: int = 1
    gradient_clipping: Optional[float] = None
    zero3_init_flag: bool = False
    mixed_precision: Optional[str] = None

    def __post_init__(self):
        if self.zero_stage not in (0, 1, 2, 3):
            raise ValueError(f"zero_stage must be 0, 1, 2 or 3, got {self.zero_stage!r}")

    @classmethod
    def from_ds_json(cls, path: str, mixed_precision: Optional[str] = None) -> "DeepSpeedPlugin":
        """The plugin of a DeepSpeed ``ds_config.json``, with the JAX
        package's reading: ``"auto"`` takes the field's default; no
        ``zero_optimization`` section is stage 0, and ``"stage": "auto"``
        stage 2; a ``bf16``/``fp16`` section ``{"enabled": "auto"}`` is on
        when ``mixed_precision`` names it. The engine's other keys
        (optimizer, scheduler, communication) are ignored."""
        with open(path) as f:
            cfg = json.load(f)

        def noauto(v, default):
            return default if v in (None, "auto") else v

        z = cfg.get("zero_optimization")
        default_stage = 2 if z is not None else 0
        z = z or {}
        enabled = {}
        for section in ("bf16", "fp16"):
            on = (cfg.get(section, {}) or {}).get("enabled")
            enabled[section] = mixed_precision == section if on == "auto" else on
        mp = "bf16" if enabled["bf16"] is True else "fp16" if enabled["fp16"] is True else None
        clip = noauto(cfg.get("gradient_clipping"), None)
        return cls(
            zero_stage=int(noauto(z.get("stage"), default_stage)),
            offload_optimizer_device=noauto((z.get("offload_optimizer") or {}).get("device"),
                                            "none"),
            offload_param_device=noauto((z.get("offload_param") or {}).get("device"), "none"),
            gradient_accumulation_steps=int(noauto(cfg.get("gradient_accumulation_steps"), 1)),
            gradient_clipping=None if clip is None else float(clip),
            mixed_precision=mp)

    def to_fsdp_plugin(self) -> FullyShardedDataParallelPlugin:
        strategy = {0: "NO_SHARD", 1: "SHARD_GRAD_OP", 2: "SHARD_GRAD_OP",
                    3: "FULL_SHARD"}[self.zero_stage]
        return FullyShardedDataParallelPlugin(
            sharding_strategy=strategy,
            cpu_offload="cpu" in (self.offload_optimizer_device, self.offload_param_device))


@dataclass
class DistributedDataParallelKwargs(KwargsHandler):
    """DDP's reducer settings, passed to ``DistributedDataParallel`` when
    ``prepare`` replicates a model (no plugin, or ``NO_SHARD``):
    ``bucket_cap_mb``, ``find_unused_parameters``,
    ``gradient_as_bucket_view`` and ``static_graph``. The JAX package takes
    them and acts on none (its gradient mean is one all-reduce the compiler
    places). ``comm_hook`` (``"no"``, ``"fp16"``, ``"bf16"``, ``"powersgd"``
    with ``powersgd_rank``) makes ``prepare`` keep the replicas without
    DDP's reducer and ``prepare_train_step`` reduce the gradients through
    the hook (``parallel/comm_hooks.py``, ``Accelerator._comm_hook_step``);
    an unknown name raises there, as in the JAX package."""

    bucket_cap_mb: int = 25
    find_unused_parameters: bool = False
    gradient_as_bucket_view: bool = False
    static_graph: bool = False
    comm_hook: str = "no"
    powersgd_rank: int = 8

    def ddp_kwargs(self) -> dict:
        """The ``DistributedDataParallel`` arguments of these settings."""
        return {"bucket_cap_mb": self.bucket_cap_mb,
                "find_unused_parameters": self.find_unused_parameters,
                "gradient_as_bucket_view": self.gradient_as_bucket_view,
                "static_graph": self.static_graph}


@dataclass
class FaultToleranceKwargs(KwargsHandler):
    """Fault tolerance (``fault_tolerance.py``): passing this handler turns
    it on; without it ``accelerator.fault_tolerance`` is None. The JAX
    package's fields and checks:

    - atomic verified checkpoints (``atomic_checkpoints``,
      ``verify_on_load``; ``checksum`` ``"sha256"`` hashes every byte,
      ``"size"`` checks sizes only);
    - save retries (``save_retries`` with backoff from ``retry_backoff_s``
      doubling up to ``retry_backoff_max_s``, then ``fallback_dir``);
    - preemption (``install_signal_handlers`` for ``preemption_signals``);
    - the divergence sentinel (``sentinel`` ``off|warn|halt|rollback``,
      ``sentinel_window`` bad steps in a row, ``sentinel_explode_factor``
      times the loss's EMA of ``sentinel_ema_alpha``, ``max_rollbacks``);
    - chaos (``chaos``: a ``chaos.FaultInjector`` or its arguments as a
      dict) and silent-data-corruption votes (``sdc``: an
      ``sdc.SDCConfig`` or its arguments as a dict);
    - the step watchdog (``watchdog`` ``off|warn|error|preempt``,
      ``watchdog_warn_s``, ``watchdog_stall_s``, ``watchdog_poll_s``,
      ``watchdog_heartbeat_every`` steps between gang heartbeats,
      ``watchdog_grace_s``)."""

    enabled: bool = True
    atomic_checkpoints: bool = True
    verify_on_load: bool = True
    checksum: str = "sha256"  # sha256 | size
    save_retries: int = 3
    retry_backoff_s: float = 0.5
    retry_backoff_max_s: float = 8.0
    fallback_dir: Optional[str] = None
    install_signal_handlers: bool = True
    preemption_signals: tuple = ("SIGTERM", "SIGUSR1")
    sentinel: str = "warn"  # off | warn | halt | rollback
    sentinel_window: int = 3
    sentinel_explode_factor: float = 10.0
    sentinel_ema_alpha: float = 0.1
    max_rollbacks: int = 2
    chaos: Optional[object] = None
    sdc: Optional[object] = None
    watchdog: str = "off"  # off | warn | error | preempt
    watchdog_warn_s: float = 60.0
    watchdog_stall_s: float = 300.0
    watchdog_poll_s: float = 1.0
    watchdog_heartbeat_every: int = 0
    watchdog_grace_s: float = 30.0

    def __post_init__(self):
        if self.checksum not in ("sha256", "size"):
            raise ValueError("checksum must be sha256|size")
        if self.sentinel not in ("off", "warn", "halt", "rollback"):
            raise ValueError("sentinel must be off|warn|halt|rollback")
        if self.sentinel_window < 1:
            raise ValueError("sentinel_window must be >= 1")
        if self.watchdog not in ("off", "warn", "error", "preempt"):
            raise ValueError("watchdog must be off|warn|error|preempt")
        if self.watchdog_warn_s <= 0 or self.watchdog_stall_s <= 0:
            raise ValueError("watchdog_warn_s/watchdog_stall_s must be > 0")
        if self.watchdog_stall_s < self.watchdog_warn_s:
            raise ValueError("watchdog_stall_s must be >= watchdog_warn_s (warn first, then "
                             "escalate)")
        if self.watchdog_poll_s <= 0:
            raise ValueError("watchdog_poll_s must be > 0")
        if self.watchdog_heartbeat_every < 0:
            raise ValueError("watchdog_heartbeat_every must be >= 0")
        if self.sdc is not None and not isinstance(self.sdc, dict):
            if type(self.sdc).__name__ != "SDCConfig":
                raise ValueError("sdc must be an sdc.SDCConfig or a dict of its kwargs, got "
                                 f"{type(self.sdc).__name__}")


@dataclass
class ProjectConfiguration:
    """Where checkpoints and logs go. With ``automatic_checkpoint_naming``,
    ``save_state()`` writes ``<project_dir>/checkpoints/checkpoint_<iteration>``
    and keeps at most ``total_limit`` of them; ``load_state()`` reads the
    newest. ``save_on_each_node`` writes the shared files once per node
    (by each node's local process 0) instead of once. ``logging_dir`` is
    where the trackers write (default ``project_dir``). With
    ``automatic_resume`` (and automatic naming) a relaunched run
    (``ACCELERATE_RESTART_ATTEMPT > 0``) restores the newest checkpoint
    right after ``prepare``, at the same world size and layout
    (``Accelerator._maybe_elastic_resume``)."""

    project_dir: str = None
    logging_dir: str = None
    automatic_checkpoint_naming: bool = False
    total_limit: int = None
    iteration: int = 0
    save_on_each_node: bool = False
    automatic_resume: bool = False

    def __post_init__(self):
        self.set_directories(self.project_dir)

    def set_directories(self, project_dir: str = None):
        self.project_dir = project_dir
        if self.logging_dir is None:
            self.logging_dir = project_dir


@dataclass
class DataLoaderConfiguration:
    """How ``Accelerator.prepare`` builds data loaders (the JAX package's
    names and defaults). ``split_batches`` splits each batch over the
    processes instead of giving each its own; ``dispatch_batches`` reads on
    process 0 and sends each its slice; ``even_batches`` cycles samples
    from the start so every process gets as many batches; a shuffling
    loader uses ``SeedableRandomSampler(seed=data_seed or 0)`` when
    ``use_seedable_sampler``; ``non_blocking`` copies batches to the card
    from pinned host memory without waiting; ``prefetch_size`` batches are
    assembled ahead on a thread. Every loader keeps its mid-epoch state, so
    ``use_stateful_dataloader`` changes nothing. ``dispatch_group_size``
    is how many batches process 0 sends in one broadcast when it
    dispatches."""

    split_batches: bool = False
    dispatch_batches: Optional[bool] = None
    even_batches: bool = True
    use_seedable_sampler: bool = True
    data_seed: Optional[int] = None
    non_blocking: bool = True
    use_stateful_dataloader: bool = False
    prefetch_size: int = 2
    dispatch_group_size: int = 8

    def __post_init__(self):
        if self.prefetch_size < 0:
            raise ValueError("prefetch_size must be >= 0")


_JOURNAL_ITEM = "ROADMAP.md Queue A item 8.8 (the engine's journal hooks, with item 12)"
# ServingConfig fields the engine does not act on yet, by ROADMAP item.
_UNPORTED_SERVING_FIELDS = {
    "enabled": "ROADMAP.md Queue A item 12 (control plane: Accelerator.build_serving_engine)",
    "journal_dir": _JOURNAL_ITEM, "journal_fsync": _JOURNAL_ITEM,
    "journal_segment_records": _JOURNAL_ITEM,
}


@dataclass
class ServingConfig:
    """Continuous-batching engine settings (``serving.ServingEngine``).

    - ``n_slots``: concurrent sequences; the slot cache is
      ``(L, n_slots, max_len, Hkv, D)`` and one decode step advances every
      live slot.
    - ``max_len``: per-slot capacity (prompt + continuation); default
      ``min(max_position_embeddings, 4096)``.
    - ``prefill_chunks``: the chunk-size ladder of chunked prefill; default
      pow2 ``min_prefill_chunk..max_prefill_chunk``.
      ``prefill_chunks_per_tick`` prompt chunks run per tick.
    - ``temperature`` / ``top_k`` / ``top_p`` / ``eos_token_id`` /
      ``pad_token_id``: sampling, engine-wide. ``max_new_tokens`` is the
      default per-request budget. ``seed`` seeds the sampling stream of a
      request submitted without its own generator.
    - ``cache_dtype``: None (the model's dtype) or ``torch.int8``, which
      keeps the slot cache as int8 ``QuantPages`` with one fp32 scale per
      row of the head dim: (D + 4) / (2 D) of a 16-bit cache's bytes.
    - ``speculate_k``: 0, or the drafts per slot per tick, verified in one
      ``(n_slots, k + 1)`` forward; ``speculate_ngram`` (>= 2) is the
      token-history window the n-gram draft matches in.
    - ``max_queue_depth`` (None: unbounded) and ``overload_policy``
      (``reject``, ``shed_oldest`` or ``block``): admission control.
      ``deadline_s``: the default per-request deadline from ``submit``.
      ``max_retries``: replays of a request after a failed prefill or a
      quarantined slot before it finishes ``failed``. ``max_idle_ticks``:
      ticks without progress before ``ServingStalledError``.
      ``window_requests``: the rolling window of ``window_stats()``.

    ``enabled`` and the journal fields keep the JAX package's names and
    defaults and raise ``NotImplementedError`` naming their ROADMAP item
    when set away from them."""

    enabled: bool = True
    n_slots: int = 8
    max_len: Optional[int] = None
    max_new_tokens: int = 32
    prefill_chunks: Optional[list] = None
    min_prefill_chunk: int = 16
    max_prefill_chunk: int = 256
    prefill_chunks_per_tick: int = 1
    temperature: float = 0.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    eos_token_id: Optional[int] = None
    pad_token_id: Optional[int] = None
    cache_dtype: Any = None
    seed: int = 0
    speculate_k: int = 0
    speculate_ngram: int = 16
    max_queue_depth: Optional[int] = None
    overload_policy: str = "reject"
    deadline_s: Optional[float] = None
    max_retries: int = 2
    max_idle_ticks: int = 100
    window_requests: int = 128
    journal_dir: Optional[str] = None
    journal_fsync: str = "every_tick"
    journal_segment_records: int = 512

    def __post_init__(self):
        _refuse_non_defaults(self, _UNPORTED_SERVING_FIELDS, honoured=tuple(
            f.name for f in fields(self) if f.name not in _UNPORTED_SERVING_FIELDS))
        if self.n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if self.prefill_chunks_per_tick < 1:
            raise ValueError("prefill_chunks_per_tick must be >= 1")
        if self.min_prefill_chunk < 1 or self.max_prefill_chunk < self.min_prefill_chunk:
            raise ValueError(
                "need 1 <= min_prefill_chunk <= max_prefill_chunk, got "
                f"{self.min_prefill_chunk}..{self.max_prefill_chunk}")
        if self.cache_dtype is not None and self.cache_dtype != torch.int8:
            raise ValueError(f"cache_dtype must be None or torch.int8, got {self.cache_dtype!r}")
        if self.overload_policy not in ("reject", "shed_oldest", "block"):
            raise ValueError("overload_policy must be 'reject', 'shed_oldest', or "
                             f"'block', got {self.overload_policy!r}")
        if self.max_queue_depth is not None and self.max_queue_depth < 1:
            raise ValueError("max_queue_depth must be >= 1 (or None)")
        if self.deadline_s is not None and not self.deadline_s > 0:
            raise ValueError("deadline_s must be > 0 (or None)")
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.max_idle_ticks < 1:
            raise ValueError("max_idle_ticks must be >= 1")
        if self.window_requests < 1:
            raise ValueError("window_requests must be >= 1")
        if self.speculate_k < 0:
            raise ValueError("speculate_k must be >= 0")
        if self.speculate_ngram < 2:
            raise ValueError("speculate_ngram must be >= 2")
