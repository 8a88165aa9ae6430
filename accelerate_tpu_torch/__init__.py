"""PyTorch/CUDA port of accelerate_tpu: the Llama training loop on NVIDIA
Hopper GPUs (the train step with hand-written CUDA kernels for flash
attention, on one GPU or data-parallel over a process group with FSDP2
(every ``sharding_strategy``, and DeepSpeed ZeRO stages read as them),
HSDP or DDP, fused or as the imperative loop of ``accumulate``,
``backward`` and ``optimizer.step()``; prepared data loaders,
learning-rate schedules, and checkpoints in the JAX package's directory
contract, which resume in either package, or written by every process with
``torch.distributed.checkpoint``, blocking or in the background), KV-cache
generation and continuous-batching serving, for the Llama decoder chassis
with every knob of the JAX config (Gemma, Qwen2, Phi-3, Mistral and the
generic specs: StarCoder2, StableLM, Granite, InternLM2, loaded from
Hugging Face checkpoints by ``models.load_pretrained``) and the Mixtral
sparse-MoE family (``MixtralForCausalLM``: capacity dispatch with the
global batch's semantics over data parallelism, ``moe_cross_entropy_loss``),
GPT-2, OPT and GPT-NeoX, the T5 and Whisper encoder-decoders (their
encoder runs once in ``generate`` and ``beam_search``), BERT, ViT, CLIP and
ResNet (flax's BatchNorm through ``prepare_train_step(mutable_state=True)``,
the global batch's statistics over processes), long-context generation with the prompt split over ``cp``
(``cp_generate``: ring-attention prefill, flash-decoding), and their
observability: experiment trackers (``log_with``), step
telemetry and the device-time profiler (``TelemetryKwargs``), and
``Accelerator.profile`` (``ProfileKwargs``). Reduced precision:
``mixed_precision="fp16"`` with dynamic loss scaling (``GradScalerKwargs``)
and ``"fp8"`` with fp8 projections on Hopper's fp8 tensor cores
(``FP8RecipeKwargs``, ``LlamaConfig(fp8=True)``). Big-model inference:
device maps over the card, pinned host memory and a disk store, and
streamed forwards of every decoder family (``load_checkpoint_and_dispatch``,
``dispatch_model``, ``cpu_offload``, ``disk_offload``); weight-only int8 and
NF4 quantization (``utils.load_and_quantize_model``); Megatron-LM
checkpoints (``models.megatron.load_megatron_model``). Pipeline
parallelism (``ParallelismConfig(pp_size=...)``, GPipe and interleaved,
``llama_pipeline_forward``, ``pipeline_apply``, ``prepare_pippy``), the
gradient-compression hooks (``DistributedDataParallelKwargs(comm_hook=
"fp16"|"bf16"|"powersgd")``) and ``LocalSGD``.

It imports torch only, never JAX or the ``accelerate_tpu`` package, and
runs on CUDA unless the caller asks for the CPU (``Accelerator(cpu=True)``).
"""

from .accelerator import Accelerator
from .big_modeling import (
    DispatchedModel,
    UserCpuOffloadHook,
    cpu_offload,
    cpu_offload_with_hook,
    disk_offload,
    dispatch_model,
    init_empty_weights,
    init_on_device,
    load_checkpoint_and_dispatch,
    register_stream_plan,
    register_stream_spec,
)
from .chaos import Fault, FaultInjector, InjectedFaultError
from .checkpointing import CheckpointSaveError
from .cp_generation import cp_generate
from .data_loader import (
    ColumnDataset,
    SeedableRandomSampler,
    prepare_data_loader,
    skip_first_batches,
)
from .generation import (
    GenerationConfig,
    beam_search,
    generate,
    register_encdec_generation_plan,
    register_generation_plan,
    speculative_generate,
)
from .inference import pipeline_stage_layers, prepare_pippy, register_pipeline_plan
from .local_sgd import LocalSGD
from .model import Model
from .models import (
    MixtralConfig,
    MixtralForCausalLM,
    compute_dispatch,
    fused_cross_entropy_loss,
    load_balance_loss,
    llama_params_from_hf,
    llama_params_to_hf,
    load_pretrained,
    model_from_pretrained,
    moe_cross_entropy_loss,
)
from .optimizer import (
    AcceleratedOptimizer,
    adamw,
    constant_schedule,
    cosine_decay_schedule,
    join_schedules,
    linear_schedule,
    warmup_cosine_decay_schedule,
)
from .parallelism_config import ParallelismConfig, ParallelismOversubscriptionError
from .scheduler import AcceleratedScheduler
from .sdc import DecodeCanary, SDCConfig
from .serving import ServingEngine, ServingStalledError, replay_trace
from .state import AcceleratorState, DistributedType, GradientState, PartialState
from .telemetry import TelemetryRecorder
from .train_state import DynamicLossScale, TrainState, grads_all_finite
from .utils import (
    AutocastKwargs,
    DataLoaderConfiguration,
    DeepSpeedPlugin,
    DistributedDataParallelKwargs,
    FP8RecipeKwargs,
    FullyShardedDataParallelPlugin,
    GradientAccumulationPlugin,
    GradScalerKwargs,
    InitProcessGroupKwargs,
    MixedPrecisionPolicy,
    ProfileKwargs,
    FaultToleranceKwargs,
    ProjectConfiguration,
    ServingConfig,
    ShardingStrategy,
    TelemetryKwargs,
    find_executable_batch_size,
    set_seed,
)
from .parallel.pp import llama_pipeline_forward, pipeline_apply
from .utils.quantization import quantize_model_for_decode

__all__ = [
    "AcceleratedOptimizer",
    "AcceleratedScheduler",
    "Accelerator",
    "AcceleratorState",
    "AutocastKwargs",
    "CheckpointSaveError",
    "DecodeCanary",
    "Fault",
    "FaultInjector",
    "InjectedFaultError",
    "SDCConfig",
    "ColumnDataset",
    "DataLoaderConfiguration",
    "DeepSpeedPlugin",
    "DispatchedModel",
    "DistributedDataParallelKwargs",
    "DistributedType",
    "DynamicLossScale",
    "FP8RecipeKwargs",
    "FullyShardedDataParallelPlugin",
    "GenerationConfig",
    "GradScalerKwargs",
    "GradientAccumulationPlugin",
    "GradientState",
    "InitProcessGroupKwargs",
    "LocalSGD",
    "MixedPrecisionPolicy",
    "MixtralConfig",
    "MixtralForCausalLM",
    "Model",
    "ParallelismConfig",
    "ParallelismOversubscriptionError",
    "PartialState",
    "ProfileKwargs",
    "FaultToleranceKwargs",
    "ProjectConfiguration",
    "SeedableRandomSampler",
    "ServingConfig",
    "ServingEngine",
    "ServingStalledError",
    "ShardingStrategy",
    "TelemetryKwargs",
    "TelemetryRecorder",
    "TrainState",
    "UserCpuOffloadHook",
    "adamw",
    "beam_search",
    "compute_dispatch",
    "constant_schedule",
    "cosine_decay_schedule",
    "cp_generate",
    "cpu_offload",
    "cpu_offload_with_hook",
    "disk_offload",
    "dispatch_model",
    "find_executable_batch_size",
    "fused_cross_entropy_loss",
    "generate",
    "grads_all_finite",
    "init_empty_weights",
    "init_on_device",
    "join_schedules",
    "linear_schedule",
    "llama_pipeline_forward",
    "load_checkpoint_and_dispatch",
    "llama_params_from_hf",
    "llama_params_to_hf",
    "load_balance_loss",
    "load_pretrained",
    "model_from_pretrained",
    "moe_cross_entropy_loss",
    "pipeline_apply",
    "pipeline_stage_layers",
    "prepare_data_loader",
    "prepare_pippy",
    "quantize_model_for_decode",
    "register_encdec_generation_plan",
    "register_generation_plan",
    "register_pipeline_plan",
    "register_stream_plan",
    "register_stream_spec",
    "replay_trace",
    "set_seed",
    "skip_first_batches",
    "speculative_generate",
    "warmup_cosine_decay_schedule",
]
