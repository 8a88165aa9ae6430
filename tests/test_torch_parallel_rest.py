"""The rest of ROADMAP.md Queue A item 6 in the port against the JAX
package: fp8 over split operands, ``generate`` over ``tp`` for every
decoding family and from FSDP2 × ``tp``, the pipeline stages of the other
decoder families, ``has_aux``/``mutable_state``, the imperative loop and
``DISTRIBUTED_STATE_DICT`` under ``pp``, ``ep`` under ``pp``, two prepared
models under FSDP2, and the one whole-tensor gather.

Without processes: ``keep_stage`` of BERT, ViT, CLIP, T5, Whisper and
ResNet, refused until item 6.3's rest was ported.

On gloo gangs of 2 and 4 CPU processes (``torch.multiprocessing`` spawn,
a ``file://`` rendezvous under the test's temporary directory), spawned
once for the module while the JAX references are computed (half of them
in a spawned process of their own), from
numpy-seeded fp32 weights carried into both packages by
``models/convert.py``. GSPMD gives every mesh the numbers of the unsharded
JAX program (its amax the global tensor's, its routing the global
batch's), so each port layout is held to the JAX step on the 8 virtual
CPU devices at one mesh that splits the same axes:

- 2 processes: fp8 at ``dp_shard=2`` (fault 10: also against the port's
  own one-process fp8 step on the global batch, within 1e-6), at
  ``dp_replicate=2`` with the ``"fp16"`` hook (against the JAX hooked
  step, whose amax is each process's, as its ``shard_map`` computes it),
  at ``tp=2``, ``sp=2`` and ``cp=2``, and in the QDQ formulation at
  ``dp_shard=2``; greedy ``generate`` of GPT-2, OPT, NeoX, T5
  and Whisper at ``tp=2``; ``pp=2`` steps of GPT-2 (GPipe and
  interleaved), OPT, NeoX and Mixtral, the Llama step with ``has_aux``
  and with ``mutable_state``, the imperative loop with ``clip_grad_norm_``
  and accumulation (the three with 2 microbatches a step), a
  ``DISTRIBUTED_STATE_DICT`` round trip;
- 4 processes: Mixtral at ``pp=2 × dp_shard=2`` with ``ep=2``,
  ``generate`` of a Llama FSDP2 shards over ``dp_shard=2 × tp=2``, fp8
  there, two prepared models under FSDP2 at ``dp_shard=4`` (the second
  held to its own one-process steps), GPT-2 at ``pp=2 × cp=2``, and
  ``utils/operations.gather_shards`` against ``DTensor.full_tensor`` for
  every placement the plans make.

Losses and grad norms within 1e-5 relative (fp8 steps against another
program: step 1's loss, then ``FP8_LOSS_RTOL`` and ``FP8_NORM_RTOL``),
parameters after the steps as ``tests/test_torch_distributed.py``'s
``_assert_params_close`` holds them, greedy tokens and dropped choices
equal, DCP round trips bit for bit.
The spawned processes import this module: JAX is imported only inside the
functions that compute the references.
"""

from __future__ import annotations

import pickle

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import accelerate_tpu_torch.models as M
from accelerate_tpu_torch import (
    Accelerator,
    DistributedDataParallelKwargs,
    FullyShardedDataParallelPlugin,
    Model,
    ParallelismConfig,
    adamw,
    generate,
    moe_cross_entropy_loss,
)
from accelerate_tpu_torch.models import convert, cross_entropy_loss
from accelerate_tpu_torch.ops import fp8 as fp8_ops
from accelerate_tpu_torch.parallel.sharding import local_batch
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState
from test_torch_distributed import LR, STEPS, _assert_params_close, _jax_reset
from test_torch_expert_parallel import _batches, _jax_moe_train, _moe_config
from test_torch_expert_parallel import _weights as _stack_weights
from test_torch_tensor_parallel import FAMILIES, _inputs, _jax_module, _rules

RTOL, SELF_RTOL, MIN_GAP = 1e-5, 1e-6, 1e-4
# fp8 steps against another program (tests/test_torch_fp8.py's tolerances):
# a last-bit difference before a quantization moves a code by a whole fp8
# step, and AdamW carries step 1's difference into the steps after it.
FP8_LOSS_RTOL, FP8_NORM_RTOL = 5e-3, 2e-2
NEW_TOKENS = 6
# The pp families: name -> config knobs (GPT-2 at 4 layers, so that the
# interleaved schedule has 2 chunks of one layer a stage).
PP_FAMILIES = {"gpt2": {"n_layer": 4}, "opt": {}, "neox": {}}
# The QDQ formulation (quantize-dequantize around a plain product) in E4M3.
QDQ = dict(fp8_backend="QDQ", fp8_format="E4M3")
FP8_RUNS = {  # name -> (ParallelismConfig kwargs, attention_impl, plugin, hook, config knobs)
    "dp_shard2": (dict(dp_shard_size=2), "flash", True, None, {}),
    "hook": (dict(dp_replicate_size=2), "flash", False, "fp16", {}),
    "tp2": (dict(tp_size=2), "flash", False, None, {}),
    "sp2": (dict(sp_size=2), "ulysses", False, None, {}),
    "cp2": (dict(cp_size=2), "flash", False, None, {}),
    "qdq_dp_shard2": (dict(dp_shard_size=2), "flash", True, None, QDQ),
    "dp_shard2_tp2": (dict(dp_shard_size=2, tp_size=2), "flash", True, None, {}),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's spinning thread pools would contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _reset_port():
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()


@pytest.fixture(autouse=True)
def reset_port_state():
    yield
    _reset_port()


def _config(family, **kw):
    _, cfg_cls, _, _, knobs = FAMILIES[family]
    return getattr(M, cfg_cls).tiny(dtype=torch.float32, **{**knobs, **kw})


def _module(family, sd=None, **kw):
    module = getattr(M, FAMILIES[family][0])(_config(family, **kw))
    if sd is not None:
        module.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})
    return module


def _weights(family, seed=0, **kw) -> dict:
    """numpy-seeded fp32 weights of a family's tiny module (fan-in scaled
    matrices, norm scales about one, biases about zero)."""
    rng = np.random.default_rng(seed)
    cfg = _config(family, **kw)
    out = {}
    for name, p in _module(family, **kw).state_dict().items():
        if name == "encoder.embed_positions":  # Whisper's fixed sinusoids
            out[name] = p.numpy().copy()
            continue
        if p.dim() == 1:
            a = rng.standard_normal(p.shape) * 0.1 + (0.0 if name.endswith("bias") else 1.0)
        else:
            a = rng.standard_normal(p.shape) / np.sqrt(np.prod(p.shape[1:]))
            if name.endswith(".q.weight"):  # T5 scales no query
                a = a / np.sqrt(cfg.d_kv)
        out[name] = np.asarray(a, np.float32)
    return out


def _flax(family, sd, **kw):
    import jax

    module = _module(family, **kw)
    tree = convert.flax_converter(module).to_flax(
        module.config, {k: torch.as_tensor(v) for k, v in sd.items()})
    return jax.tree.map(lambda t: np.asarray(t.numpy()), tree)


def _whole(t) -> np.ndarray:
    return (t.full_tensor() if hasattr(t, "full_tensor") else t).detach().numpy().copy()


def _stage_params(module) -> dict:
    """Every stage's parameters, whole, merged by name (each process's gang
    peers join)."""
    params = {n: _whole(p) for n, p in module.named_parameters()}
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, params)
    return {n: v for part in parts for n, v in part.items()}


def _ce(m, b):
    return cross_entropy_loss(m(b["x"].long()), b["y"].long())


def _moe_loss(m, b):
    return moe_cross_entropy_loss(m, b["x"].long(), b["y"].long())


def _steps(acc, step, batches, rank, extra=None) -> list:
    rows = []
    for b in batches:
        lb = {k: torch.from_numpy(v) for k, v in
              local_batch(b, acc.parallelism_config, rank).items()}
        _, m = step(acc.train_state, lb)
        rows.append((float(m["loss"]), float(m["grad_norm"])) + (extra() if extra else ()))
    return rows


# ---------------------------------------------------------------------------
# The jobs each spawned process runs
# ---------------------------------------------------------------------------


def _fp8_run(ctx, name):
    """STEPS fp8 steps of the tiny Llama at ``FP8_RUNS[name]``: metrics,
    the whole parameters after them, the amax all-reduces a step, and step
    1's per-projection input scales (this process's)."""
    kw, impl, plugin, hook, knobs = FP8_RUNS[name]
    rank = dist.get_rank()
    module = M.LlamaForCausalLM(M.LlamaConfig.tiny(dtype=torch.float32, fp8=True,
                                                   attention_impl=impl, **knobs))
    module.load_state_dict({k: torch.from_numpy(v) for k, v in ctx["llama"].items()})
    pc = ParallelismConfig(**kw)
    handlers = [DistributedDataParallelKwargs(comm_hook=hook)] if hook else []
    acc = Accelerator(cpu=True, parallelism_config=pc, kwargs_handlers=handlers,
                      fsdp_plugin=FullyShardedDataParallelPlugin() if plugin else None)
    rules = M.llama_tp_rules(True) if pc.tp_size > 1 else None
    acc.prepare(Model(module, tp_rules=rules), adamw(LR))
    step = acc.prepare_train_step(_ce, max_grad_norm=1.0)
    scales = []
    real = fp8_ops._quant

    def tap(x, fp8_dtype, fp8_max=None, groups=()):
        q, scale = real(x, fp8_dtype, fp8_max, groups)
        scales.append((float(scale), fp8_dtype == torch.float8_e5m2))
        return q, scale

    fp8_ops._quant = tap
    try:
        fp8_ops.reset_paths()
        rows = _steps(acc, step, ctx["batches"][:1], rank)
        reduces = fp8_ops.AMAX_REDUCES["all_reduce"]
    finally:
        fp8_ops._quant = real
    rows += _steps(acc, step, ctx["batches"][1:], rank)
    out = {"metrics": rows, "scales": scales, "amax_reduces": reduces}
    _reset_port()
    return out


def _job_fp8(ctx):
    world = dist.get_world_size()
    names = (["dp_shard2", "hook", "tp2", "sp2", "cp2", "qdq_dp_shard2"] if world == 2
             else ["dp_shard2_tp2"])
    return {name: _fp8_run(ctx, name) for name in names}


def _job_generate_tp(ctx):
    """Greedy tokens of each decoding family at tp=2."""
    out = {}
    for family in ("gpt2", "opt", "neox", "t5", "whisper"):
        module = _module(family, ctx["families"][family], **PP_FAMILIES.get(family, {}))
        acc = Accelerator(cpu=True, parallelism_config=ParallelismConfig(tp_size=2))
        model = acc.prepare_model(Model(module, tp_rules=_rules(family)))
        out[family] = {"tokens": generate(model, torch.from_numpy(ctx["prompts"][family]),
                                          max_new_tokens=NEW_TOKENS).numpy(),
                       "split": sum(isinstance(p, torch.distributed.tensor.DTensor)
                                    for p in module.parameters())}
        _reset_port()
    return out


def _pp_family(ctx, family, virtual=1):
    rank = dist.get_rank()
    sd = ctx["families"][family] if family != "mixtral" else ctx["moe"]
    module = (M.MixtralForCausalLM(_moe_config()) if family == "mixtral"
              else _module(family, **PP_FAMILIES[family]))
    module.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})
    acc = Accelerator(cpu=True, parallelism_config=ParallelismConfig(
        pp_size=2, pp_virtual_stages=virtual))
    model, _ = acc.prepare(Model(module), adamw(LR))
    step = acc.prepare_train_step(_moe_loss if family == "mixtral" else _ce, max_grad_norm=1.0)

    def drops():
        if family != "mixtral":
            return ()
        n = torch.as_tensor(module.router_stats()["dropped"]).reshape(())
        dist.all_reduce(n)
        return (int(n),)

    batches = ctx["moe_batches"] if family == "mixtral" else ctx["batches"]
    out = {"metrics": _steps(acc, step, batches, rank, drops), "params": _stage_params(module),
           "shared": list(model.pipeline_shared)}
    _reset_port()
    return out


def _llama_pp(ctx, **acc_kw):
    module = M.LlamaForCausalLM(M.LlamaConfig.tiny(dtype=torch.float32))
    module.load_state_dict({k: torch.from_numpy(v) for k, v in ctx["llama"].items()})
    acc = Accelerator(cpu=True, parallelism_config=ParallelismConfig(pp_size=2), **acc_kw)
    model, opt = acc.prepare(Model(module), adamw(LR))
    return acc, model, opt, module


def _job_pp(ctx):
    """pp=2: the families' steps; the Llama step with has_aux and with
    mutable_state; the imperative loop; a DISTRIBUTED_STATE_DICT round
    trip."""
    rank = dist.get_rank()
    out = {f: _pp_family(ctx, f) for f in PP_FAMILIES}
    out["gpt2_interleaved"] = _pp_family(ctx, "gpt2", virtual=2)
    out["mixtral"] = _pp_family(ctx, "mixtral")

    # has_aux and mutable_state over 2 microbatches a step, as the loop below.
    acc, _, _, module = _llama_pp(ctx, gradient_accumulation_steps=2)

    def with_aux(m, b):
        logits = m(b["x"].long())
        return cross_entropy_loss(logits, b["y"].long()), {"logits": logits}

    step = acc.prepare_train_step(with_aux, has_aux=True, max_grad_norm=1.0)
    out["has_aux"] = {"metrics": _steps(acc, step, ctx["batches"], rank)}
    _reset_port()

    acc, _, _, module = _llama_pp(ctx, gradient_accumulation_steps=2)

    def mutable(m, extra, b):
        loss = _ce(m, b)
        seen = torch.zeros(()) if extra is None else extra["seen"]
        return loss, {"seen": seen + loss.detach()}

    step = acc.prepare_train_step(mutable, mutable_state=True, max_grad_norm=1.0)
    out["mutable"] = {"metrics": _steps(acc, step, ctx["batches"], rank),
                      "seen": float(acc.train_state.extra_state["seen"])}
    _reset_port()

    # The imperative loop: 2 microbatches a step, clip, AdamW.
    acc, model, opt, module = _llama_pp(ctx, gradient_accumulation_steps=2)
    rows = []
    for b in ctx["batches"]:
        lb = local_batch(b, acc.parallelism_config, rank)
        half = lb["x"].shape[0] // 2
        losses, norm = [], None
        for i in range(2):
            mb = {k: torch.from_numpy(v[i * half:(i + 1) * half]) for k, v in lb.items()}
            with acc.accumulate(model):
                losses.append(float(acc.backward(_ce, mb)))
                norm = acc.clip_grad_norm_(None, 1.0)
                opt.step()
                opt.zero_grad()
        rows.append((float(np.mean(losses)), float(norm)))
    out["loop"] = {"metrics": rows, "params": _stage_params(module)}
    _reset_port()

    # DISTRIBUTED_STATE_DICT: a step, save, a fresh prepare loads it, a step;
    # against the same two steps without the round trip.
    dcp = FullyShardedDataParallelPlugin(state_dict_type="DISTRIBUTED_STATE_DICT")
    runs = {}
    for trip in (False, True):
        acc, model, _, module = _llama_pp(ctx, fsdp_plugin=dcp)
        step = acc.prepare_train_step(_ce, max_grad_norm=1.0)
        rows = _steps(acc, step, ctx["batches"][:1], rank)
        if trip:
            acc.save_state(ctx["dcp_dir"], block=False)  # the stager under pp
            acc.wait_for_checkpoint()
            _reset_port()
            acc, model, _, module = _llama_pp(ctx, fsdp_plugin=dcp)
            with torch.no_grad():
                for p in module.parameters():
                    p.zero_()
            acc.load_state(ctx["dcp_dir"])
            loaded = {"params": {n: _whole(p) for n, p in module.named_parameters()},
                      "moments": {n: _whole(acc.train_state.optimizer.state[p]["exp_avg_sq"])
                                  for n, p in module.named_parameters()}}
            step = acc.prepare_train_step(_ce, max_grad_norm=1.0)
        rows += _steps(acc, step, ctx["batches"][1:2], rank)
        runs[trip] = {"metrics": rows, "params": {n: _whole(p)
                                                  for n, p in module.named_parameters()},
                      "moments": {n: _whole(acc.train_state.optimizer.state[p]["exp_avg"])
                                  for n, p in module.named_parameters()}}
        _reset_port()
    out["dcp"] = runs
    out["dcp_loaded"] = loaded
    return out


def _job_pp_ep(ctx):
    """Mixtral at pp=2 × dp_shard=2 with ep=2 over dp_shard (FSDP2 on each
    stage's other parameters), one microbatch a process."""
    rank = dist.get_rank()
    module = M.MixtralForCausalLM(_moe_config())
    module.load_state_dict({k: torch.from_numpy(v) for k, v in ctx["moe"].items()})
    pc = ParallelismConfig(pp_size=2, dp_shard_size=2, ep_size=2)
    acc = Accelerator(cpu=True, parallelism_config=pc,
                      fsdp_plugin=FullyShardedDataParallelPlugin())
    model, _ = acc.prepare(Model(module, tp_rules=M.mixtral_tp_rules(True, ep_axes=pc.ep_axes)),
                           adamw(LR))
    step = acc.prepare_train_step(_moe_loss, max_grad_norm=1.0)

    def drops():
        n = torch.as_tensor(module.router_stats()["dropped"]).reshape(()).clone()
        dist.all_reduce(n, group=acc.state.pipeline_mesh.get_group())
        return (int(n),)

    out = {"metrics": _steps(acc, step, ctx["moe_batches"], rank, drops),
           "experts": sorted(model.expert_params), "params": _stage_params(module)}
    _reset_port()
    return out


def _job_fsdp_tp(ctx):
    """A Llama FSDP2 shards over dp_shard=2 × tp=2: its greedy tokens, and
    every parameter gathered (``gather_shards``) against ``full_tensor``;
    the same for a Mixtral whose stacks are split over ep=2."""
    from accelerate_tpu_torch.utils.operations import gather_shards

    out = {"placements": set()}
    module = M.LlamaForCausalLM(M.LlamaConfig.tiny(dtype=torch.float32))
    module.load_state_dict({k: torch.from_numpy(v) for k, v in ctx["llama"].items()})
    acc = Accelerator(cpu=True, parallelism_config=ParallelismConfig(dp_shard_size=2, tp_size=2),
                      fsdp_plugin=FullyShardedDataParallelPlugin(min_weight_size_to_shard=0))
    model, _ = acc.prepare(Model(module, tp_rules=M.llama_tp_rules(True)), adamw(LR))
    out["tokens"] = generate(model, torch.from_numpy(ctx["prompts"]["llama"]),
                             max_new_tokens=NEW_TOKENS).numpy()
    for p in module.parameters():
        if hasattr(p, "full_tensor"):
            assert torch.equal(gather_shards(p), p.full_tensor())
            out["placements"].add(tuple(map(str, p.placements)))
    _reset_port()
    module = M.MixtralForCausalLM(_moe_config())
    module.load_state_dict({k: torch.from_numpy(v) for k, v in ctx["moe"].items()})
    pc = ParallelismConfig(dp_shard_size=2, tp_size=2, ep_size=2)
    acc = Accelerator(cpu=True, parallelism_config=pc,
                      fsdp_plugin=FullyShardedDataParallelPlugin())
    acc.prepare(Model(module, tp_rules=M.mixtral_tp_rules(True, ep_axes=pc.ep_axes)), adamw(LR))
    for p in module.parameters():
        if hasattr(p, "full_tensor"):
            assert torch.equal(gather_shards(p), p.full_tensor())
            out["placements"].add(tuple(map(str, p.placements)))
    _reset_port()
    return out


def _job_two_models(ctx):
    """Two prepared Llamas under FSDP2 at dp_shard=4, each with its own
    optimizer and step (``model=``), stepped in turn on their batches (2
    microbatches a step)."""
    rank = dist.get_rank()
    acc = Accelerator(cpu=True, parallelism_config=ParallelismConfig(dp_shard_size=4),
                      fsdp_plugin=FullyShardedDataParallelPlugin(), gradient_accumulation_steps=2)
    modules, slots = [], []
    for sd in (ctx["llama"], ctx["llama_b"]):
        module = M.LlamaForCausalLM(M.LlamaConfig.tiny(dtype=torch.float32))
        module.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
        model, _ = acc.prepare(Model(module), adamw(LR))
        modules.append(module)
        slots.append(model)
    steps = [acc.prepare_train_step(_ce, max_grad_norm=1.0, model=m) for m in slots]
    states = acc._train_states
    rows = [[], []]
    for pair in zip(ctx["batches"], ctx["batches_b"]):
        for i, b in enumerate(pair):
            lb = {k: torch.from_numpy(v) for k, v in
                  local_batch(b, acc.parallelism_config, rank).items()}
            _, m = steps[i](states[i], lb)
            rows[i].append((float(m["loss"]), float(m["grad_norm"])))
    out = {"metrics": rows,
           "params": [{n: _whole(p) for n, p in mod.named_parameters()} for mod in modules]}
    _reset_port()
    return out


def _job_pp_cp(ctx):
    """GPT-2 at pp=2 × cp=2: each stage's attention over the whole sequence
    through the ring."""
    rank = dist.get_rank()
    module = _module("gpt2", ctx["families"]["gpt2"], **PP_FAMILIES["gpt2"])
    acc = Accelerator(cpu=True, parallelism_config=ParallelismConfig(pp_size=2, cp_size=2))
    acc.prepare(Model(module), adamw(LR))
    step = acc.prepare_train_step(_ce, max_grad_norm=1.0)
    out = {"metrics": _steps(acc, step, ctx["batches"], rank), "params": _stage_params(module)}
    _reset_port()
    return out


JOBS = {name[5:]: fn for name, fn in globals().items() if name.startswith("_job_")}


def _worker(rank, world, init_file, ctx_path, jobs):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    with open(ctx_path, "rb") as f:
        ctx = pickle.load(f)
    results = {job: JOBS[job](ctx) for job in jobs}
    gathered = [None] * world
    dist.all_gather_object(gathered, results)
    if rank == 0:
        with open(ctx_path + f".out{world}", "wb") as f:
            pickle.dump(gathered, f)
    dist.destroy_process_group()


def _start(tmp, world, jobs, ctx):
    """A gang started in the background: (its context, the result file)."""
    ctx_path = str(tmp / f"ctx{world}.pkl")
    with open(ctx_path, "wb") as f:
        pickle.dump(ctx, f)
    gang = mp.start_processes(_worker, args=(world, str(tmp / f"rendezvous{world}"), ctx_path,
                                             jobs),
                              nprocs=world, join=False, start_method="spawn")
    return gang, ctx_path + f".out{world}"


def _finish(gang, path) -> list:
    while not gang.join():
        pass
    with open(path, "rb") as f:
        return pickle.load(f)


# ---------------------------------------------------------------------------
# The JAX references
# ---------------------------------------------------------------------------


def _jax_step(family, module, params, batches, loss, pc_kwargs, mixed=None, **acc_kw):
    """STEPS steps of the JAX Accelerator at ``pc_kwargs``: (loss, grad
    norm) per step and the parameters after them."""
    import jax
    import jax.numpy as jnp
    import optax

    from accelerate_tpu import Accelerator as JaxAccelerator
    from accelerate_tpu import Model as JaxModel
    from accelerate_tpu import ParallelismConfig as JaxPC

    _jax_reset()
    acc = JaxAccelerator(parallelism_config=JaxPC(**pc_kwargs), **acc_kw)
    acc.prepare(JaxModel(module=module, params=params), optax.adamw(LR))
    step = acc.prepare_train_step(loss, max_grad_norm=1.0)
    metrics = []
    for b in batches:
        b = mixed(b) if mixed else b
        _, m = step(acc.train_state, {k: jnp.asarray(v, jnp.int32) for k, v in b.items()})
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    final = jax.tree.map(np.asarray, acc.train_state.params)
    _jax_reset()
    return metrics, final


def _jax_ce(module):
    from accelerate_tpu.models import cross_entropy_loss as jax_ce

    return lambda p, b: jax_ce(module.apply({"params": p}, b["x"]), b["y"])


def _jax_llama(dtype="float32", **kw):
    import jax.numpy as jnp

    from accelerate_tpu.models import LlamaConfig as JaxLlamaConfig
    from accelerate_tpu.models import LlamaForCausalLM as JaxLlama

    return JaxLlama(JaxLlamaConfig.tiny(dtype=getattr(jnp, dtype), **kw))


def _jax_llama_references(ctx) -> dict:
    """The JAX Llama steps (fp8, fp8 under the hook, 2 microbatches a step
    at pp=2) and every family's greedy tokens."""
    from accelerate_tpu.generation import generate as jax_generate
    from accelerate_tpu import Model as JaxModel
    from accelerate_tpu.utils.dataclasses import DistributedDataParallelKwargs as JaxDDPK
    from test_torch_comm_hooks import _jax_batch
    import jax.numpy as jnp

    ref = {}
    llama = _flax("llama", ctx["llama"])
    fp8 = _jax_llama(fp8=True)
    ref["fp8"] = _jax_step("llama", fp8, llama, ctx["batches"], _jax_ce(fp8),
                           dict(dp_shard_size=4, tp_size=2))
    ref["fp8_hook"] = _jax_step("llama", fp8, llama, ctx["batches"], _jax_ce(fp8),
                                dict(dp_replicate_size=8), mixed=_jax_batch,
                                kwargs_handlers=[JaxDDPK(comm_hook="fp16")])
    plain = _jax_llama()
    ref["llama_ga2"] = _jax_step("llama", plain, llama, ctx["batches"], _jax_ce(plain),
                                 dict(pp_size=2), gradient_accumulation_steps=2)
    ref["tokens"] = {}
    for family in ("gpt2", "opt", "neox", "t5", "whisper", "llama"):
        kw = PP_FAMILIES.get(family, {})
        params = llama if family == "llama" else _flax(family, ctx["families"][family], **kw)
        module = _jax_llama() if family == "llama" else _jax_module(family, **kw)
        ref["tokens"][family] = np.asarray(jax_generate(
            JaxModel(module=module, params=params), jnp.asarray(ctx["prompts"][family]),
            max_new_tokens=NEW_TOKENS))
    return ref


def _jax_stage_references(ctx_path: str, out_path: str) -> None:
    """The JAX steps of the pp families at pp=2 and of the Mixtral, written
    to ``out_path``: run in a process of its own, beside the gangs and
    ``_jax_llama_references``."""
    with open(ctx_path, "rb") as f:
        ctx = pickle.load(f)
    ref = {}
    for family, kw in PP_FAMILIES.items():
        module = _jax_module(family, **kw)
        ref[family] = _jax_step(family, module, _flax(family, ctx["families"][family], **kw),
                                ctx["batches"], _jax_ce(module), dict(pp_size=2))
    moe_rows, moe_final, _ = _jax_moe_train(ctx["moe"], ctx["moe_batches"])
    ref["mixtral"] = (moe_rows, moe_final)
    with open(out_path, "wb") as f:
        pickle.dump(ref, f)


def _one_process_llama(weights, batches):
    """The port's own fp32 Llama steps (2 microbatches a step) in one
    process: metrics and the parameters after them."""
    module = M.LlamaForCausalLM(M.LlamaConfig.tiny(dtype=torch.float32))
    module.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    acc = Accelerator(cpu=True, gradient_accumulation_steps=2)
    acc.prepare(Model(module), adamw(LR))
    step = acc.prepare_train_step(_ce, max_grad_norm=1.0)
    rows = []
    for b in batches:
        _, m = step(acc.train_state, {k: torch.from_numpy(v) for k, v in b.items()})
        rows.append((float(m["loss"]), float(m["grad_norm"])))
    params = {n: _whole(p) for n, p in module.named_parameters()}
    _reset_port()
    return rows, params


def _one_process_fp8(ctx, **knobs) -> dict:
    """The port's own fp8 steps on the global batch in one process: metrics
    and step 1's scales, in the order they were taken."""
    module = M.LlamaForCausalLM(M.LlamaConfig.tiny(dtype=torch.float32, fp8=True, **knobs))
    module.load_state_dict({k: torch.from_numpy(v) for k, v in ctx["llama"].items()})
    acc = Accelerator(cpu=True)
    acc.prepare(Model(module), adamw(LR))
    step = acc.prepare_train_step(_ce, max_grad_norm=1.0)
    rows, scales, real = [], [], fp8_ops._quant

    def tap(x, fp8_dtype, *args, **kwargs):
        q, scale = real(x, fp8_dtype, *args, **kwargs)
        scales.append((float(scale), fp8_dtype == torch.float8_e5m2))
        return q, scale

    for i, b in enumerate(ctx["batches"]):
        fp8_ops._quant = tap if i == 0 else real
        try:
            _, m = step(acc.train_state, {k: torch.from_numpy(v) for k, v in b.items()})
        finally:
            fp8_ops._quant = real
        rows.append((float(m["loss"]), float(m["grad_norm"])))
    _reset_port()
    return {"metrics": rows, "scales": scales}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both gangs' results, the JAX references and the port's one-process
    fp8 steps."""
    tmp = tmp_path_factory.mktemp("rest")
    families = {f: _weights(f, seed=10 + i, **PP_FAMILIES.get(f, {}))
                for i, f in enumerate(("gpt2", "opt", "neox", "t5", "whisper"))}
    rng = np.random.default_rng(7)
    prompts = {f: rng.integers(1, 250, (2, 8)) for f in ("gpt2", "opt", "neox", "llama")}
    prompts["t5"] = _inputs("t5")[0]
    prompts["whisper"] = _inputs("whisper")[0]
    ctx = {"llama": _stack_weights(M.LlamaForCausalLM, M.LlamaConfig.tiny(dtype=torch.float32),
                                   seed=1),
           "llama_b": _stack_weights(M.LlamaForCausalLM,
                                     M.LlamaConfig.tiny(dtype=torch.float32), seed=2),
           "moe": _stack_weights(M.MixtralForCausalLM, _moe_config(), seed=0),
           "families": families, "prompts": prompts, "batches": _batches(),
           "batches_b": _batches(seed=4), "moe_batches": _batches(),
           "dcp_dir": str(tmp / "dcp")}
    two = _start(tmp, 2, ["fp8", "generate_tp", "pp"], ctx)
    four = _start(tmp, 4, ["pp_ep", "fsdp_tp", "fp8", "two_models", "pp_cp"], ctx)
    stages = mp.get_context("spawn").Process(
        target=_jax_stage_references, args=(str(tmp / "ctx2.pkl"), str(tmp / "stages.pkl")))
    stages.start()
    ref = _jax_llama_references(ctx)
    ref["llama_b"] = _one_process_llama(ctx["llama_b"], ctx["batches_b"])
    ref["fp8_one_process"] = _one_process_fp8(ctx)
    ref["qdq_one_process"] = _one_process_fp8(ctx, **QDQ)
    stages.join()
    assert stages.exitcode == 0
    with open(tmp / "stages.pkl", "rb") as f:
        ref.update(pickle.load(f))
    return {2: _finish(*two), 4: _finish(*four), "ctx": ctx, "ref": ref}


# ---------------------------------------------------------------------------
# Helpers of the checks
# ---------------------------------------------------------------------------


def _assert_metrics(got, want, rtol):
    for g, w in zip(got, want):
        for a, b in zip(g[:2], w[:2]):
            assert abs(a - b) <= rtol * abs(b), (got, want)


# The key bias of each family (the end of its flax path, the k part's index
# in the leaf): its gradient is zero in exact arithmetic (a query's scores
# all shift by the same q·b, which the softmax ignores), so AdamW's m/√v
# turns its rounding into moves of up to lr either way; those entries are
# held to the STEPS·lr bound alone.
KEY_BIAS = {"gpt2": (("attn", "c_attn", "bias"), (slice(None), 1)),
            "opt": (("self_attn", "k_proj", "bias"), ()),
            "neox": (("attention", "query_key_value", "bias"), (slice(None), slice(None), 1))}


def _assert_family_params(family, got: dict, want_tree, init: dict, **kw):
    got_tree = _flax(family, got, **kw)
    if family in KEY_BIAS:
        path, index = KEY_BIAS[family]
        g, w = got_tree, want_tree
        *parents, leaf = _find_path(got_tree, path)
        for key in parents:
            g, w = g[key], w[key]
        g, w = g[leaf], w[leaf]
        assert np.abs(g[index] - np.asarray(w)[index]).max() <= STEPS * LR
        g[index] = np.asarray(w)[index]
    _assert_params_close(got_tree, want_tree, _flax(family, init, **kw))


def _find_path(tree, tail, above=()) -> list:
    """The keys of the leaf of ``tree`` whose path ends with ``tail``."""
    for key, value in tree.items():
        path = above + (key,)
        if isinstance(value, dict):
            found = _find_path(value, tail, path)
            if found:
                return found
        elif path[-len(tail):] == tail:
            return list(path)
    return []


# ---------------------------------------------------------------------------
# fp8 over split operands (fault 10)
# ---------------------------------------------------------------------------


def _assert_fp8_metrics(got, want, first_rtol):
    """Step 1's loss within ``first_rtol`` (no update has carried a code
    flip forward yet); every loss and grad norm within the fp8 room."""
    assert abs(got[0][0] - want[0][0]) <= first_rtol * abs(want[0][0]), (got, want)
    for (gl, gn), (wl, wn) in zip(got, want):
        assert abs(gl - wl) <= FP8_LOSS_RTOL * abs(wl), (got, want)
        assert abs(gn - wn) <= FP8_NORM_RTOL * abs(wn), (got, want)


def _assert_scales(got, want, processes: int, rtol: float = 0.0):
    """Step 1's scales against the one-process step's, in the order they
    were taken: the forward's (inputs, weights) equal, the cotangents'
    ``processes`` times theirs (each process's loss is its share of the
    global mean times the processes it is averaged over, a power of two
    here: the codes are the same)."""
    assert len(got) == len(want)
    for (g, backward), (w, _) in zip(got, want):
        w = w * processes if backward else w
        assert abs(g - w) <= rtol * w, (got, want)


def test_fp8_at_dp_shard2_takes_the_global_amax(runs):
    """Fault 10: under FSDP2 at dp_shard=2 each process quantizes its half
    of the batch with the scale of the whole batch's amax: step 1's every
    scale (inputs, weights, cotangents) is the port's one-process fp8 step
    on the global batch's bit for bit on both processes, its loss and grad
    norm within 1e-6; all steps match that run and the JAX fp8 step."""
    want, _ = runs["ref"]["fp8"]
    one = runs["ref"]["fp8_one_process"]
    results = [r["fp8"]["dp_shard2"] for r in runs[2]]
    for r in results:
        _assert_scales(r["scales"], one["scales"], 2)
        _assert_metrics(r["metrics"][:1], one["metrics"][:1], SELF_RTOL)
        _assert_fp8_metrics(r["metrics"], one["metrics"], SELF_RTOL)
        _assert_fp8_metrics(r["metrics"], want, RTOL)
        assert r["amax_reduces"] > 0


def test_qdq_at_dp_shard2_takes_the_global_amax(runs):
    """The QDQ formulation at dp_shard=2: each operand's amax over the
    batch's processes, its gradient through the scale reaching the process
    that holds the global amax (summed over the processes first): the
    port's one-process QDQ steps on the global batch, step 1 within 1e-6."""
    one = runs["ref"]["qdq_one_process"]
    for r in runs[2]:
        got = r["fp8"]["qdq_dp_shard2"]
        _assert_metrics(got["metrics"][:1], one["metrics"][:1], SELF_RTOL)
        _assert_fp8_metrics(got["metrics"], one["metrics"], SELF_RTOL)
        assert got["amax_reduces"] > 0


def test_fp8_under_the_comm_hook_keeps_each_process_amax(runs):
    """Under the "fp16" comm hook each process's gradients come from its
    own rows with its own scales (no amax collective), as the JAX
    shard_map step computes them: its metrics, and scales that differ
    between the processes."""
    want, _ = runs["ref"]["fp8_hook"]
    results = [r["fp8"]["hook"] for r in runs[2]]
    for r in results:
        _assert_fp8_metrics(r["metrics"], want, RTOL)
        assert r["amax_reduces"] == 0
    assert results[0]["scales"] != results[1]["scales"]


@pytest.mark.parametrize("world,name,processes,rtol",
                         [(2, "tp2", 1, 1e-6), (2, "sp2", 2, 0.0), (2, "cp2", 2, 1e-6),
                          (4, "dp_shard2_tp2", 2, 1e-6)])
def test_fp8_under_tp_and_sp_matches_jax(runs, world, name, processes, rtol):
    """fp8 at tp=2 (the split operands' amax over tp too), at sp=2
    (Ulysses) and cp=2 (the ring: each over the sequence group) and at
    dp_shard=2 × tp=2 (the "fp8 native dots x FSDP" scenario of
    dryrun_multichip at half size): the JAX fp8 step's metrics; step 1's
    scales the one-process step's (under tp and the ring within 1e-6:
    their sums round in another order), equal on every process."""
    want, _ = runs["ref"]["fp8"]
    one = runs["ref"]["fp8_one_process"]
    results = [r["fp8"][name] for r in runs[world]]
    for r in results:
        _assert_fp8_metrics(r["metrics"], want, RTOL)
        assert r["amax_reduces"] > 0
        _assert_scales(r["scales"], one["scales"], processes, rtol)
        assert r["scales"] == results[0]["scales"]


# ---------------------------------------------------------------------------
# generate over tp
# ---------------------------------------------------------------------------


def _gaps(family, sd, prompt, tokens) -> float:
    """The smallest top-2 logit gap of the greedy steps (one process)."""
    module = _module(family, sd, **PP_FAMILIES.get(family, {}))
    with torch.no_grad():
        if family in ("t5", "whisper"):
            args = (torch.from_numpy(prompt), torch.from_numpy(tokens[:, :-1]))
            logits = module(*args)
        else:
            n0 = prompt.shape[1]
            logits = module(torch.from_numpy(tokens[:, :-1]))[:, n0 - 1:]
    logits = logits[0] if isinstance(logits, tuple) else logits
    top2 = torch.topk(logits.float(), 2, dim=-1).values
    return float((top2[..., 0] - top2[..., 1]).min())


@pytest.mark.parametrize("family", ["gpt2", "opt", "neox", "t5", "whisper"])
def test_generate_at_tp2_matches_jax(runs, family):
    """Greedy tokens at tp=2 (each rank's heads, the cross K/V split by
    heads, the vocab-split embedding and head) equal the JAX package's;
    each step's top-2 logit gap is above MIN_GAP."""
    want = runs["ref"]["tokens"][family]
    ctx = runs["ctx"]
    assert _gaps(family, ctx["families"][family], ctx["prompts"][family], want) > MIN_GAP
    for r in runs[2]:
        got = r["generate_tp"][family]
        assert got["split"] > 0
        np.testing.assert_array_equal(got["tokens"], want)


def test_generate_of_fsdp2_by_tp_matches_jax(runs):
    """A Llama FSDP2 shards over dp_shard=2 × tp=2 decodes its shards
    gathered over dp_shard only, the tp split kept: the JAX tokens."""
    want = runs["ref"]["tokens"]["llama"]
    for r in runs[4]:
        np.testing.assert_array_equal(r["fsdp_tp"]["tokens"], want)


def test_gather_shards_equals_full_tensor_for_every_placement(runs):
    """``gather_shards`` gave ``full_tensor``'s values on every process for
    FSDP2's 1-D shards, the 2-D ``dp_shard × tp`` ones (its strided split
    inside the tp chunk) and the ep stacks."""
    placements = runs[4][0]["fsdp_tp"]["placements"]
    assert ("S(0)",) in placements                      # the ep stacks, FSDP2 1-D
    assert ("_S(0, 2)", "S(0)") in placements           # FSDP2 inside a tp row split
    assert ("S(0)", "S(1)") in placements               # FSDP2 by a tp column split


# ---------------------------------------------------------------------------
# pp
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", ["gpt2", "gpt2_interleaved", "opt", "neox"])
def test_pp2_family_steps_match_jax(runs, family):
    """GPipe (and for GPT-2 the interleaved schedule, 2 chunks a stage)
    steps at pp=2 of each decoder family: the JAX step's metrics and
    parameters; the tied embedding (GPT-2's wte, OPT's embed_tokens) held
    by both edge stages, equal after the steps."""
    base = family.split("_")[0]
    kw = PP_FAMILIES[base]
    want, final = runs["ref"][base]
    results = [r["pp"][family] for r in runs[2]]
    for r in results:
        _assert_metrics(r["metrics"], want, RTOL)
    tied = {"gpt2": ["transformer.wte.weight"], "opt": ["model.embed_tokens.weight"],
            "neox": []}[base]
    assert [r["shared"] for r in results] == [tied, tied]
    _assert_family_params(base, results[0]["params"], final, runs["ctx"]["families"][base],
                          **kw)


def _moe_params(got, want_tree, init):
    from accelerate_tpu_torch.models import llama_params_to_flax

    def tree(sd):
        return llama_params_to_flax(_moe_config(), {k: torch.as_tensor(v) for k, v in sd.items()})

    import jax

    _assert_params_close(jax.tree.map(np.asarray, tree(got)), want_tree,
                         jax.tree.map(np.asarray, tree(init)))


@pytest.mark.parametrize("world,job", [(2, "pp"), (4, "pp_ep")], ids=["pp2", "pp2_ep2"])
def test_mixtral_stages_match_jax(runs, world, job):
    """Mixtral at pp=2: GPipe over 2 microbatches in one process (each
    layer carries the earlier microbatches' choices, the aux terms wait
    for the whole batch's frac), and at pp=2 × dp_shard=2 with ep=2 (the
    stacks split inside each stage, one microbatch over the processes'
    global batch): the JAX step's losses (aux included), grad norms and
    dropped choices, and its parameters."""
    want, final = runs["ref"]["mixtral"]
    results = [r[job]["mixtral"] if job == "pp" else r[job] for r in runs[world]]
    for r in results:
        _assert_metrics(r["metrics"], [(w[0], w[2]) for w in want], RTOL)
        assert [m[2] for m in r["metrics"]] == [w[3] for w in want]
    assert sum(w[3] for w in want) > 0
    if job == "pp_ep":
        assert all(n.endswith(("w_gate", "w_up", "w_down")) for n in results[0]["experts"])
    _moe_params(results[0]["params"], final, runs["ctx"]["moe"])


def test_pp2_has_aux_and_mutable_state(runs):
    """``has_aux`` and ``mutable_state`` under pp=2, 2 microbatches a step:
    the JAX step's metrics; the new state is the last stage's on both
    stages (here the sum of the microbatches' losses, which the stages
    before it computed on a stand-in: twice the sum of the steps')."""
    want, _ = runs["ref"]["llama_ga2"]
    for r in runs[2]:
        _assert_metrics(r["pp"]["has_aux"]["metrics"], want, RTOL)
        _assert_metrics(r["pp"]["mutable"]["metrics"], want, RTOL)
        seen = 2 * sum(m[0] for m in want)
        assert abs(r["pp"]["mutable"]["seen"] - seen) <= RTOL * seen


def test_pp2_imperative_loop_matches_the_jax_accumulated_step(runs):
    """``backward``/``clip_grad_norm_``/``optimizer.step()`` under pp=2
    with 2 microbatches a window: the losses' mean and the clip's global
    norm (over both stages) equal the JAX step with gradient accumulation
    2; the parameters after the steps too."""
    want, final = runs["ref"]["llama_ga2"]
    results = [r["pp"]["loop"] for r in runs[2]]
    for r in results:
        _assert_metrics(r["metrics"], want, RTOL)
    _assert_family_params("llama", results[0]["params"], final, runs["ctx"]["llama"])


def test_pp2_dcp_round_trip_is_bit_equal(runs):
    """``DISTRIBUTED_STATE_DICT`` at pp=2: each stage saves its own
    parameters and moments under their global names (in the background,
    ``block=False``); a fresh prepare loads them bit for bit, and its next
    step equals the one taken without the round trip."""
    for r in runs[2]:
        plain, trip = r["pp"]["dcp"][False], r["pp"]["dcp"][True]
        assert plain["metrics"] == trip["metrics"]
        assert plain["params"].keys() == trip["params"].keys()
        for n in plain["params"]:
            np.testing.assert_array_equal(plain["params"][n], trip["params"][n])
            np.testing.assert_array_equal(plain["moments"][n], trip["moments"][n])


def test_pp2_dcp_checkpoint_resumes_at_pp1(runs):
    """The pp=2 DCP checkpoint (global names) loads into one process at
    pp=1: every parameter and second moment bit for bit as the stages
    loaded it."""
    module = M.LlamaForCausalLM(M.LlamaConfig.tiny(dtype=torch.float32))
    acc = Accelerator(cpu=True, fsdp_plugin=FullyShardedDataParallelPlugin(
        state_dict_type="DISTRIBUTED_STATE_DICT"))
    acc.prepare(Model(module), adamw(LR))
    acc.load_state(runs["ctx"]["dcp_dir"])
    merged = {"params": {}, "moments": {}}
    for r in runs[2]:
        for key in merged:
            merged[key].update(r["pp"]["dcp_loaded"][key])
    assert merged["params"].keys() == {n for n, _ in module.named_parameters()}
    for n, p in module.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), merged["params"][n], err_msg=n)
        np.testing.assert_array_equal(acc.train_state.optimizer.state[p]["exp_avg_sq"].numpy(),
                                      merged["moments"][n], err_msg=n)
    assert int(acc.train_state.step) == 1


def test_pp2_cp2_gpt2_stage_attends_over_the_whole_sequence(runs):
    """A GPT-2 stage at pp=2 × cp=2: each process's half of the sequence at
    its global positions, the attention through the ring: the JAX GPT-2
    step's metrics and parameters."""
    want, final = runs["ref"]["gpt2"]
    for r in runs[4]:
        _assert_metrics(r["pp_cp"]["metrics"], want, RTOL)
    _assert_family_params("gpt2", runs[4][0]["pp_cp"]["params"], final,
                          runs["ctx"]["families"]["gpt2"], **PP_FAMILIES["gpt2"])


def test_two_models_under_fsdp2_match_jax(runs):
    """Two prepared Llamas under FSDP2 in one group (dryrun_multichip's
    "multi-model (2x FSDP slots)"), each stepped by its own slot: the
    first equals the JAX step of its weights and batches, the second its
    own model's steps on one process (the one-process step is the JAX
    step's, as the first slot and tests/test_torch_train.py hold it)."""
    want, final = runs["ref"]["llama_ga2"]
    for r in runs[4]:
        _assert_metrics(r["two_models"]["metrics"][0], want, RTOL)
    _assert_family_params("llama", runs[4][0]["two_models"]["params"][0], final,
                          runs["ctx"]["llama"])
    want, final = runs["ref"]["llama_b"]
    assert want != runs["ref"]["llama_ga2"][0]
    for r in runs[4]:
        _assert_metrics(r["two_models"]["metrics"][1], want, RTOL)
    _assert_family_params("llama", runs[4][0]["two_models"]["params"][1],
                          _flax("llama", final), runs["ctx"]["llama_b"])


def test_the_step_batch_is_seen_from_the_backward_thread():
    """The running step's batch processes (``operations.loss_over_processes``)
    are seen from another thread, as the autograd engine's CUDA thread runs
    the backward and the remat recompute whose fp8 amax reduces over them
    (a context variable is not: on the card the recompute took each
    process's own amax)."""
    import threading

    from accelerate_tpu_torch.utils import operations

    seen = []
    with operations.loss_over_processes(2, "group"):
        thread = threading.Thread(target=lambda: seen.append(
            (operations.loss_processes(), operations.loss_group(), fp8_ops.batch_groups())))
        thread.start()
        thread.join()
    assert seen == [(2, "group", ("group",))]
    assert operations.loss_processes() == 1 and fp8_ops.batch_groups() == ()


# ---------------------------------------------------------------------------
# The refusals that remain
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", ["bert", "vit", "clip", "t5", "whisper", "resnet"])
def test_pp_of_the_other_families_is_refused(family):
    """pp of the encoders, the two-stack models and ResNet was refused here
    until item 6.3's rest was ported: ``keep_stage`` now cuts each family to
    a stage (``parallel/pp.ReplicatedSpec``; the steps are held to the JAX
    package in tests/test_torch_pipeline_encoders.py) and marks it as one."""
    from accelerate_tpu_torch.parallel.pp import keep_stage

    if family == "resnet":
        module = M.ResNet(M.ResNetConfig.tiny())
    else:
        module = getattr(M, FAMILIES[family][0])(_config(family))
    names = {n for n, _ in module.named_parameters()}
    shared = keep_stage(module, 2, 0)
    assert module.pipeline_stage == (2, 0, 1) and module.pipeline_replicated
    assert set(shared) <= names
