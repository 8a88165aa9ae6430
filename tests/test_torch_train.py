"""The port's train step (accelerate_tpu_torch.Accelerator) against the JAX
package's, and the guards that keep the port apart from JAX.

The trajectory test builds the JAX side as tests/test_llama.py does and the
port's side from the same flax-initialised weights, then compares the loss
and grad norm of five steps, fp32 on the CPU.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import accelerate_tpu_torch
from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu import Model as JaxModel
from accelerate_tpu.models import LlamaConfig as JaxLlamaConfig
from accelerate_tpu.models import LlamaForCausalLM as JaxLlama
from accelerate_tpu.models import cross_entropy_loss as jax_cross_entropy
from accelerate_tpu_torch import (
    Accelerator,
    FullyShardedDataParallelPlugin,
    GradientAccumulationPlugin,
    MixedPrecisionPolicy,
    Model,
    ParallelismConfig,
    ProjectConfiguration,
    ServingConfig,
    adamw,
)
from accelerate_tpu_torch.utils import TelemetryKwargs
from accelerate_tpu_torch.models import (
    LlamaConfig,
    LlamaForCausalLM,
    cross_entropy_loss,
    llama_params_from_flax,
)
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the driver runs several test processes at once,
    and torch's spinning thread pools would contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


PACKAGE = Path(accelerate_tpu_torch.__file__).parent


@pytest.fixture(autouse=True)
def reset_port_state():
    yield
    AcceleratorState._reset_state()
    GradientState._reset_state()
    PartialState._reset_state()


def _batches(n=5, bs=16, seq=16, vocab=256):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        ids = rng.integers(0, vocab, size=(bs, seq + 1), dtype=np.int32)
        out.append({"x": ids[:, :-1], "y": ids[:, 1:]})
    return out


@pytest.mark.parametrize("ga", [1, 2])
def test_five_steps_match_jax_accelerator(ga):
    batches = _batches()
    jcfg = JaxLlamaConfig.tiny(dtype=jnp.float32)
    module = JaxLlama(jcfg)
    jacc = JaxAccelerator(gradient_accumulation_steps=ga)
    jmodel = JaxModel.from_flax(module, jax.random.key(0), batches[0]["x"])
    params = jax.tree.map(np.asarray, jmodel.params)
    jacc.prepare(jmodel, optax.adamw(1e-3))

    def jax_loss(p, b):
        return jax_cross_entropy(module.apply({"params": p}, b["x"]), b["y"])

    jstep = jacc.prepare_train_step(jax_loss, max_grad_norm=1.0)
    jstate, jax_metrics = jacc.train_state, []
    for b in batches:
        jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        jax_metrics.append((float(m["loss"]), float(m["grad_norm"])))

    tcfg = LlamaConfig.tiny(dtype=torch.float32)
    model = Model(LlamaForCausalLM(tcfg))
    model.load_state_dict(llama_params_from_flax(tcfg, params))
    acc = Accelerator(cpu=True, gradient_accumulation_steps=ga)
    model, _ = acc.prepare(model, adamw(1e-3))

    def loss_fn(model, b):
        return cross_entropy_loss(model(b["x"].long()), b["y"].long())

    step = acc.prepare_train_step(loss_fn, max_grad_norm=1.0)
    state, port_metrics = acc.train_state, []
    for b in batches:
        state, m = step(state, b)
        port_metrics.append((float(m["loss"]), float(m["grad_norm"])))
    assert state.step == len(batches)
    np.testing.assert_allclose(np.array(port_metrics), np.array(jax_metrics), rtol=1e-4)


def test_bf16_step_casts_for_compute_and_keeps_fp32_masters():
    torch.manual_seed(0)
    module = LlamaForCausalLM(LlamaConfig.tiny(remat=True, remat_policy="dots"))
    module.init_weights(torch.Generator().manual_seed(0))
    acc = Accelerator(mixed_precision="bf16", cpu=True)
    model, _ = acc.prepare(Model(module), adamw(3e-4, weight_decay=0.1))
    step = acc.prepare_train_step(
        lambda m, b: cross_entropy_loss(m(b["x"]), b["y"]), max_grad_norm=1.0)
    b = _batches(n=1, bs=4)[0]
    state, metrics = step(acc.train_state, {k: v.astype(np.int64) for k, v in b.items()})
    assert np.isfinite(float(metrics["loss"])) and float(metrics["grad_norm"]) > 0
    assert all(p.dtype == torch.float32 for p in state.params.values())
    assert acc.unwrap_model(model) is module


def test_port_imports_neither_jax_nor_the_jax_package():
    modules = sorted(
        ".".join(("accelerate_tpu_torch",) + p.relative_to(PACKAGE).with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PACKAGE.rglob("*.py"))
    code = (
        "import importlib, sys\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax', "
        "'accelerate_tpu')]\n"
        "assert not bad, bad\n"
        "# The trackers import their packages when built (TensorBoard pulls in TensorFlow).\n"
        "tb = [m for m in sys.modules if m.split('.')[0] in ('tensorboard', 'tensorflow') "
        "or m.startswith('torch.utils.tensorboard')]\n"
        "assert not tb, tb\n"
        "print(len(sys.modules))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=PACKAGE.parent, timeout=120)
    assert res.returncode == 0, res.stderr
    assert len(modules) >= 15
    for name in ("accelerate_tpu_torch.native", "accelerate_tpu_torch.data_loader",
                 "accelerate_tpu_torch.checkpointing", "accelerate_tpu_torch.scheduler",
                 "accelerate_tpu_torch.utils.other", "accelerate_tpu_torch.utils.constants",
                 "accelerate_tpu_torch.tracking", "accelerate_tpu_torch.telemetry",
                 "accelerate_tpu_torch.profiler", "accelerate_tpu_torch.utils.profiling",
                 "accelerate_tpu_torch.utils.imports", "accelerate_tpu_torch.models.gpt2",
                 "accelerate_tpu_torch.models.neox", "accelerate_tpu_torch.models.opt",
                 "accelerate_tpu_torch.models.t5", "accelerate_tpu_torch.models.whisper",
                 "accelerate_tpu_torch.models.layers", "accelerate_tpu_torch.parallel.tp",
                 "accelerate_tpu_torch.utils.estimate_memory"):
        assert name in modules, name


def test_port_sources_have_no_jax_imports():
    import re

    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|accelerate_tpu)\b(?!_torch)", re.M)
    offenders = [str(p) for p in PACKAGE.rglob("*.py") if pattern.search(p.read_text())]
    assert not offenders


def test_accelerator_needs_a_gpu_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="No CUDA device"):
        Accelerator()
    PartialState._reset_state()
    acc = Accelerator(cpu=True)
    assert acc.device == torch.device("cpu")


def test_accelerator_refuses_a_second_device_choice(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    Accelerator(cpu=True)
    with pytest.raises(ValueError, match="cpu=True"):
        Accelerator()
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    Accelerator()
    with pytest.raises(ValueError, match="cpu=False"):
        Accelerator(cpu=True)


@pytest.mark.parametrize("make", [
    lambda: adamw(1e-3, mu_dtype=torch.bfloat16),
    lambda: FullyShardedDataParallelPlugin(mixed_precision_policy=MixedPrecisionPolicy()),
    # ProjectConfiguration(automatic_resume=True) stood here until fault
    # tolerance was ported (tests/test_torch_fault_tolerance.py).
    lambda: ServingConfig(journal_fsync="always"),
    # ParallelismConfig(ep_size=2) stood here until expert parallelism was
    # ported (tests/test_torch_expert_parallel.py).
    lambda: ServingConfig(journal_dir="journal"),
    lambda: MixedPrecisionPolicy(reduce_dtype=torch.bfloat16),
    lambda: TelemetryKwargs(tracing=True),
])
def test_settings_the_port_does_not_act_on_raise(make):
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue A item"):
        make()


def test_project_dir_is_acted_on(tmp_path):
    """A project_dir, given either way, is where automatic checkpoints go."""
    for acc in (Accelerator(cpu=True, project_dir=str(tmp_path)),
                Accelerator(cpu=True, project_config=ProjectConfiguration(
                    project_dir=str(tmp_path), automatic_checkpoint_naming=True))):
        assert acc.project_dir == str(tmp_path)
    torch.manual_seed(0)
    acc.prepare(Model(torch.nn.Linear(3, 2)), adamw(1e-3))
    out = acc.save_state()
    assert out == str(tmp_path / "checkpoints" / "checkpoint_0")
    assert (tmp_path / "checkpoints" / "checkpoint_0" / "model.safetensors").exists()
    assert acc.project_configuration.iteration == 1


def test_default_plugins_are_accepted():
    acc = Accelerator(cpu=True, fsdp_plugin=FullyShardedDataParallelPlugin(),
                      gradient_accumulation_steps=2)
    assert acc.gradient_state.num_steps == 2
    assert GradientAccumulationPlugin(num_steps=4).num_steps == 4
    assert ProjectConfiguration().project_dir is None


def test_set_seed_seeds_every_generator_and_returns_one():
    import random

    draws = []
    for _ in range(2):
        gen = accelerate_tpu_torch.set_seed(1234)
        draws.append((random.random(), np.random.rand(), torch.rand(3),
                      torch.rand(3, generator=gen)))
    (py_a, np_a, t_a, g_a), (py_b, np_b, t_b, g_b) = draws
    assert py_a == py_b and np_a == np_b
    assert torch.equal(t_a, t_b) and torch.equal(g_a, g_b)
    assert gen.initial_seed() == 1234


def test_wider_mesh_and_fp16_are_not_ported():
    """cp, sp, tp, pp and ep are ported (tests/test_torch_tensor_parallel.py,
    tests/test_torch_pipeline.py, tests/test_torch_expert_parallel.py); ep
    borrows whole axes, as the JAX constructor checks. fp16 is ported (with dynamic loss scaling,
    tests/test_torch_mixed_precision.py); a lower AdamW ``mu_dtype`` is
    not."""
    for axes in (dict(cp_size=2), dict(sp_size=2)):
        assert ParallelismConfig(**axes).seq_size == 2
    assert ParallelismConfig(tp_size=2).total_size == 2
    assert ParallelismConfig(pp_size=2).total_size == 2
    with pytest.raises(ValueError, match="ep_size must divide"):
        ParallelismConfig(ep_size=2)
    assert ParallelismConfig(dp_shard_size=2, ep_size=2).ep_axes == ("dp_shard",)
    with pytest.raises(ValueError, match="mutually exclusive"):
        ParallelismConfig(cp_size=2, sp_size=2)
    assert Accelerator(mixed_precision="fp16", cpu=True).mixed_precision == "fp16"
    with pytest.raises(NotImplementedError, match="Queue A item 9"):
        adamw(1e-3, mu_dtype=torch.bfloat16)


_SCHEDULES = [
    ("constant_schedule", dict(value=3e-4)),
    ("linear_schedule", dict(init_value=1e-3, end_value=1e-5, transition_steps=7)),
    ("linear_schedule", dict(init_value=0.0, end_value=2e-4, transition_steps=5,
                             transition_begin=3)),
    ("linear_schedule", dict(init_value=1e-3, end_value=0.0, transition_steps=0)),
    ("cosine_decay_schedule", dict(init_value=3e-4, decay_steps=9, alpha=0.1)),
    ("cosine_decay_schedule", dict(init_value=1e-3, decay_steps=6, exponent=2.0)),
    ("warmup_cosine_decay_schedule", dict(init_value=0.0, peak_value=3e-4, warmup_steps=2,
                                          decay_steps=12)),
    ("warmup_cosine_decay_schedule", dict(init_value=1e-5, peak_value=1e-3, warmup_steps=4,
                                          decay_steps=20, end_value=1e-4)),
]


@pytest.mark.parametrize("name,kw", _SCHEDULES, ids=[n for n, _ in _SCHEDULES])
def test_schedules_match_optax(name, kw):
    """The port's schedules (Python floats) against optax's (float32) at
    counts 0-24: within 1e-6 of the value, or of the schedule's largest
    value where optax's float32 arithmetic cancels (an initial value far
    below the peak, the cosine's tail), which puts its own rounding error
    above 1e-6 of a small value."""
    port, ref = getattr(accelerate_tpu_torch, name)(**kw), getattr(optax, name)(**kw)
    values = [float(ref(count)) for count in range(25)]
    peak = max(abs(v) for v in values)
    for count, want in enumerate(values):
        assert port(count) == pytest.approx(want, rel=1e-6, abs=1e-6 * peak), count


def test_join_schedules_matches_optax():
    parts = dict(boundaries=[3, 8])
    port = accelerate_tpu_torch.join_schedules(
        [accelerate_tpu_torch.constant_schedule(1.0),
         accelerate_tpu_torch.linear_schedule(1.0, 0.5, 5),
         accelerate_tpu_torch.constant_schedule(0.25)], **parts)
    ref = optax.join_schedules([optax.constant_schedule(1.0), optax.linear_schedule(1.0, 0.5, 5),
                                optax.constant_schedule(0.25)], **parts)
    assert [port(c) for c in range(12)] == pytest.approx([float(ref(c)) for c in range(12)])


def test_scheduled_adamw_applies_schedule_k_at_update_k():
    """Update k (from 0) runs at schedule(k), as optax's scale_by_schedule;
    the count survives the optimizer's state_dict."""
    schedule = accelerate_tpu_torch.linear_schedule(1.0, 0.0, 4)
    p = torch.nn.Parameter(torch.zeros(3))
    opt = adamw(schedule)([p])
    lrs = []
    for _ in range(5):
        p.grad = torch.ones(3)
        opt.step()
        lrs.append(opt.param_groups[0]["lr"])
    assert lrs == [schedule(k) for k in range(5)] == [1.0, 0.75, 0.5, 0.25, 0.0]
    assert opt.count == 5 and float(opt.state[p]["step"]) == 5.0
    fresh = adamw(schedule)([torch.nn.Parameter(torch.zeros(3))])
    fresh.load_state_dict(opt.state_dict())
    assert fresh.count == 5
