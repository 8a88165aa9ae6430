"""The rest of the port's ``prepare_train_step`` (``has_aux``,
``mutable_state``, ``model=``, ``donate``), the kwargs handlers and enums
of ``utils/dataclasses.py``, and the repairs of ROADMAP.md faults 6 and 7
on one process, against the JAX package on the CPU.

A two-layer MLP (flax ``nn.Dense`` / ``torch.nn.Linear``; with a flax
BatchNorm for ``mutable_state``) carries the same numpy-seeded weights in
both packages; three fp32 steps (adamw, clipping at 1.0; SGD under
``mutable_state``, whose update is linear in the gradient, as
tests/test_torch_resnet.py explains) agree within rtol 1e-4 in losses and
grad norms, and the running statistics within 1e-5.
"""

import dataclasses
import importlib.util
import logging
from pathlib import Path

import flax.linen as fnn
import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu import FullyShardedDataParallelPlugin as JaxPlugin
from accelerate_tpu import Model as JaxModel
from accelerate_tpu.models import LlamaConfig as JaxLlamaConfig
from accelerate_tpu.models import LlamaForCausalLM as JaxLlama
from accelerate_tpu.state import AcceleratorState as JaxAS
from accelerate_tpu.state import GradientState as JaxGS
from accelerate_tpu.state import PartialState as JaxPS
from accelerate_tpu.utils import dataclasses as jax_dataclasses
from accelerate_tpu_torch import (
    Accelerator,
    FP8RecipeKwargs,
    FullyShardedDataParallelPlugin,
    Model,
    adamw,
)
from accelerate_tpu_torch import models
from accelerate_tpu_torch.models.layers import FlaxBatchNorm
from accelerate_tpu_torch.parallel.fsdp import decoder_blocks
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState
from accelerate_tpu_torch.train_state import tree_items
from accelerate_tpu_torch.utils import (
    AutocastKwargs,
    FP8Format,
    InitProcessGroupKwargs,
    LoggerType,
    PrecisionType,
    SaveFormat,
    StateDictType,
)

STEPS = 3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def reset_states():
    yield
    for cls in (AcceleratorState, GradientState, PartialState, JaxAS, JaxGS, JaxPS):
        cls._reset_state()


class _FlaxMLP(fnn.Module):
    out: int
    norm: bool = False

    @fnn.compact
    def __call__(self, x, train: bool = False):
        h = fnn.Dense(16, name="fc1")(x)
        if self.norm:
            h = fnn.BatchNorm(use_running_average=not train, momentum=0.9, epsilon=1e-5,
                              name="bn")(h)
        return fnn.Dense(self.out, name="fc2")(fnn.relu(h))


class _MLP(torch.nn.Module):
    def __init__(self, out: int, norm: bool = False):
        super().__init__()
        self.fc1, self.fc2 = torch.nn.Linear(4, 16), torch.nn.Linear(16, out)
        self.bn = FlaxBatchNorm(16, 0.9, 1e-5, torch.float32) if norm else None

    def forward(self, x, train: bool = False, batch_stats=None):
        h, new = self.fc1(x), None
        if self.bn is not None:  # the BatchNorm over (B, 16) as NCHW (B, 16, 1, 1)
            h, new = self.bn(h[:, :, None, None], train, None if batch_stats is None
                             else batch_stats["bn"])
            h, new = h[:, :, 0, 0], {"batch_stats": {"bn": new}}
        y = self.fc2(torch.relu(h))
        return (y, new) if train else y


def _pair(out=3, seed=0, norm=False):
    """(port module, flax variables) of one set of numpy-seeded weights."""
    rng = np.random.default_rng(seed)
    module = _MLP(out, norm)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.from_numpy(rng.normal(size=p.shape).astype(np.float32) * 0.5))
        if norm:
            module.bn.mean.copy_(torch.from_numpy(rng.normal(size=16).astype(np.float32) * .1))
            module.bn.var.copy_(torch.from_numpy(rng.uniform(.5, 1.5, 16).astype(np.float32)))
    variables = {"params": {n: {"kernel": getattr(module, n).weight.detach().numpy().T.copy(),
                                "bias": getattr(module, n).bias.detach().numpy().copy()}
                            for n in ("fc1", "fc2")}}
    if norm:
        variables["params"]["bn"] = {"scale": module.bn.scale.detach().numpy().copy(),
                                     "bias": module.bn.bias.detach().numpy().copy()}
        variables["batch_stats"] = {"bn": {"mean": module.bn.mean.numpy().copy(),
                                           "var": module.bn.var.numpy().copy()}}
    return module, variables


def _data(n=8, out=3, seed=1):
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(size=(n, 4)).astype(np.float32),
            "y": rng.normal(size=(n, out)).astype(np.float32)}


def _jax_model(variables, out=3, norm=False):
    extra = {"batch_stats": variables["batch_stats"]} if norm else None
    return JaxModel(module=_FlaxMLP(out, norm),
                    params=jax.tree.map(jnp.array, variables["params"]), extra_state=extra)


def _run(step, state, batch, steps=STEPS):
    out = []
    for _ in range(steps):
        state, m = step(state, batch)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return state, out


def _port_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_has_aux_drops_the_aux_and_matches_jax():
    """``has_aux``: the step uses the loss of ``(loss, aux)`` and drops the
    aux, as the JAX step does: its metrics are ``{"loss", "grad_norm"}``,
    equal to the plain step's bit for bit and to the JAX has_aux step's
    within rtol 1e-4."""
    batch = _data()
    _, variables = _pair()
    jm = _FlaxMLP(3)
    jacc = JaxAccelerator()
    jacc.prepare(_jax_model(variables), optax.adamw(1e-2))
    jstep = jacc.prepare_train_step(
        lambda p, b: (jnp.mean((jm.apply({"params": p}, b["x"]) - b["y"]) ** 2), {"n": 1}),
        has_aux=True, max_grad_norm=1.0)
    _, want = _run(jstep, jacc.train_state, {k: jnp.asarray(v) for k, v in batch.items()})

    def loss(m, b):
        return ((m(b["x"]) - b["y"]) ** 2).mean()

    runs = {}
    for has_aux in (False, True):
        module, _ = _pair()
        acc = Accelerator(cpu=True)
        acc.prepare(Model(module), adamw(1e-2))
        fn = (lambda m, b: (loss(m, b), {"aux": torch.ones(2)})) if has_aux else loss
        step = acc.prepare_train_step(fn, has_aux=has_aux, max_grad_norm=1.0)
        state, m = step(acc.train_state, _port_batch(batch))
        assert set(m) == {"loss", "grad_norm"}
        runs[has_aux] = [(float(m["loss"]), float(m["grad_norm"]))] + _run(
            step, state, _port_batch(batch), STEPS - 1)[1]
        PartialState._reset_state()
        AcceleratorState._reset_state()
    assert runs[True] == runs[False]
    np.testing.assert_allclose(np.array(runs[True]), np.array(want), rtol=1e-4)


@pytest.mark.parametrize("ga", [1, 2], ids=["ga1", "ga2"])
def test_mutable_state_threads_the_statistics_like_jax(ga):
    """``mutable_state``: ``loss_fn(model, extra_state, batch) -> (loss,
    new_extra_state)``, the statistics carried through the microbatches of
    an accumulation window in order and stored in ``state.extra_state``
    (the buffers, in place); against the JAX step with ``mutable_state``."""
    batch = _data()
    _, variables = _pair(norm=True)
    jm = _FlaxMLP(3, norm=True)
    jacc = JaxAccelerator(gradient_accumulation_steps=ga)
    jacc.prepare(_jax_model(variables, norm=True), optax.sgd(0.1))

    def jloss(p, extra, b):
        y, mutated = jm.apply({"params": p, **extra}, b["x"], train=True,
                              mutable=["batch_stats"])
        return jnp.mean((y - b["y"]) ** 2), dict(mutated)

    jstep = jacc.prepare_train_step(jloss, mutable_state=True, max_grad_norm=1.0)
    jstate, want = _run(jstep, jacc.train_state, {k: jnp.asarray(v) for k, v in batch.items()})

    module, _ = _pair(norm=True)
    acc = Accelerator(cpu=True, gradient_accumulation_steps=ga)
    model = Model(module)
    acc.prepare(model, torch.optim.SGD(module.parameters(), lr=0.1))
    assert acc.train_state.extra_state["batch_stats"]["bn"]["mean"] is module.bn.mean

    def loss(m, extra, b):
        y, new = m(b["x"], train=True, batch_stats=extra["batch_stats"])
        return ((y - b["y"]) ** 2).mean(), new

    step = acc.prepare_train_step(loss, mutable_state=True, max_grad_norm=1.0)
    state, got = _run(step, acc.train_state, _port_batch(batch))
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=1e-4)
    want_stats = dict(tree_items(jax.tree.map(np.asarray, dict(jstate.extra_state))))
    got_stats = dict(tree_items(state.extra_state))
    assert got_stats.keys() == want_stats.keys()
    for k, w in want_stats.items():
        np.testing.assert_allclose(got_stats[k].numpy(), w, rtol=0, atol=1e-5, err_msg=str(k))
    assert state.extra_state["batch_stats"]["bn"]["var"] is module.bn.var


def test_model_selects_the_slot_of_a_student_teacher_pair():
    """``model=``: the step of that model's slot, as tests/test_multi_model.py
    holds the JAX package. The student trains against the teacher's
    outputs within rtol 1e-4 of the JAX step; the teacher, prepared without
    an optimizer, stays as it was and has no step; a model this Accelerator
    did not prepare raises, and so does the step given another slot's state."""
    batch = _data()
    teacher, tvars = _pair(seed=2)
    student, svars = _pair(seed=3)
    with torch.no_grad():
        targets = teacher(torch.from_numpy(batch["x"])).numpy()
    jsm = _FlaxMLP(3)
    jacc = JaxAccelerator()
    jstudent, _, _ = jacc.prepare(_jax_model(svars), optax.adamw(1e-2), _jax_model(tvars))
    jstep = jacc.prepare_train_step(
        lambda p, b: jnp.mean((jsm.apply({"params": p}, b["x"]) - b["t"]) ** 2),
        model=jstudent, max_grad_norm=1.0)
    _, want = _run(jstep, jacc._train_states[jstudent._state_slot],
                   {"x": jnp.asarray(batch["x"]), "t": jnp.asarray(targets)})

    acc = Accelerator(cpu=True)
    s_model, _, t_model = acc.prepare(Model(student), adamw(1e-2), Model(teacher))
    step = acc.prepare_train_step(lambda m, b: ((m(b["x"]) - b["t"]) ** 2).mean(),
                                  model=s_model, max_grad_norm=1.0)
    slot = next(st for st in acc._train_states if st.model is s_model)
    _, got = _run(step, slot, {"x": torch.from_numpy(batch["x"]),
                               "t": torch.from_numpy(targets)})
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=1e-4)
    with torch.no_grad():
        np.testing.assert_array_equal(teacher(torch.from_numpy(batch["x"])).numpy(), targets)
    for other in (t_model, Model(_MLP(3))):
        with pytest.raises(ValueError, match="not prepared"):
            acc.prepare_train_step(lambda m, b: None, model=other)
    with pytest.raises(ValueError, match="another model's slot"):
        step(dataclasses.replace(slot, model=t_model), {"x": torch.from_numpy(batch["x"])})


def test_donate_is_taken_and_changes_nothing():
    """``donate``: eager PyTorch updates in place either way; the steps with
    ``donate=True`` and ``False`` are bit-equal."""
    batch = _data()
    runs = []
    for donate in (True, False):
        module, _ = _pair()
        acc = Accelerator(cpu=True)
        acc.prepare(Model(module), adamw(1e-2))
        step = acc.prepare_train_step(lambda m, b: ((m(b["x"]) - b["y"]) ** 2).mean(),
                                      donate=donate)
        runs.append(_run(step, acc.train_state, _port_batch(batch))[1])
        PartialState._reset_state()
        AcceleratorState._reset_state()
    assert runs[0] == runs[1]


def test_handlers_and_enums_are_the_jax_packages(tmp_path):
    """``InitProcessGroupKwargs`` and ``AutocastKwargs`` with the JAX
    fields, taken by ``Accelerator(kwargs_handlers=...)``; the enums with
    ``in`` on values; each enum member taken where its string is."""
    import dataclasses

    for ours, theirs in ((InitProcessGroupKwargs, jax_dataclasses.InitProcessGroupKwargs),
                         (AutocastKwargs, jax_dataclasses.AutocastKwargs)):
        assert [f.name for f in dataclasses.fields(ours)] == [
            f.name for f in dataclasses.fields(theirs)]
    assert AutocastKwargs(enabled=False).to_kwargs() == {"enabled": False}
    for ours, theirs in ((PrecisionType, jax_dataclasses.PrecisionType),
                         (LoggerType, jax_dataclasses.LoggerType),
                         (SaveFormat, jax_dataclasses.SaveFormat),
                         (FP8Format, jax_dataclasses.FP8Format)):
        assert ours.list() == theirs.list()
    assert set(jax_dataclasses.StateDictType.list()) < set(StateDictType.list())
    assert "bf16" in PrecisionType and "bf17" not in PrecisionType
    assert str(PrecisionType.FP16) == "fp16"
    acc = Accelerator(cpu=True, mixed_precision=PrecisionType.BF16, project_dir=str(tmp_path),
                      log_with=LoggerType.TENSORBOARD,
                      kwargs_handlers=[InitProcessGroupKwargs(backend="gloo"),
                                       AutocastKwargs(cache_enabled=True)])
    assert acc.mixed_precision == "bf16" and acc.init_handler.backend == "gloo"
    assert acc.autocast_handler.cache_enabled and acc.log_with == ["tensorboard"]
    plugin = FullyShardedDataParallelPlugin(state_dict_type=StateDictType.FULL_STATE_DICT)
    assert plugin.state_dict_type == "FULL_STATE_DICT"
    assert FP8RecipeKwargs(fp8_format=FP8Format.E4M3).fp8_format == "E4M3"


@pytest.mark.parametrize("remat_knob", [True, False], ids=["llama", "no_knob"])
def test_activation_checkpointing_flips_remat_like_jax(remat_knob, caplog):
    """Fault 6: on one process, ``prepare`` with ``FullyShardedDataParallelPlugin(
    activation_checkpointing=True)`` leaves ``config.remat`` as the JAX
    package leaves it; a module without the knob warns, in both packages,
    and is prepared as it is."""
    plugin_kw = dict(activation_checkpointing=True)
    ids = np.zeros((2, 8), np.int32)
    with caplog.at_level(logging.WARNING):
        if remat_knob:
            jacc = JaxAccelerator(fsdp_plugin=JaxPlugin(**plugin_kw))
            jcfg = JaxLlamaConfig.tiny(dtype=jnp.float32)
            jmodel = JaxModel.from_flax(JaxLlama(jcfg), jax.random.key(0), ids)
            jacc.prepare(jmodel, optax.adamw(1e-3))
            want = jmodel.module.config.remat, jcfg.remat
        else:
            jacc = JaxAccelerator(fsdp_plugin=JaxPlugin(**plugin_kw))
            jacc.prepare(JaxModel.from_flax(_FlaxMLP(3), jax.random.key(0), _data()["x"]),
                         optax.adamw(1e-3))
        jax_warned = sum("config.remat" in r.message for r in caplog.records)
        caplog.clear()
        cfg = models.LlamaConfig.tiny(dtype=torch.float32)
        module = models.LlamaForCausalLM(cfg) if remat_knob else _MLP(3)
        acc = Accelerator(cpu=True, fsdp_plugin=FullyShardedDataParallelPlugin(**plugin_kw))
        model, _ = acc.prepare(Model(module), adamw(1e-3))
        port_warned = sum("config.remat" in r.message for r in caplog.records)
    assert jax_warned >= 1 and port_warned >= 1
    if remat_knob:
        # The prepared module remats; the caller's config is left alone.
        assert (model.module.config.remat, cfg.remat) == want == (True, False)
        held = [getattr(m, a) for m in model.module.modules() for a in ("config", "cfg")
                if hasattr(m, a)]
        assert len(held) > 3 and all(c is model.module.config for c in held)


# chip_smoke.py's table of every family the port trains, with the blocks of
# its tiny config, and its classes (``unit_family``).
_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(chip_smoke)


@pytest.mark.parametrize("family", sorted(chip_smoke.UNIT_FAMILIES))
def test_fsdp2_wraps_every_block_of_every_family(family):
    """Fault 7: ``decoder_blocks`` (FSDP2's per-block units) finds every
    repeated block by its class: GPT-2's under ``h`` and T5's ``block_{i}``
    too, one each, and nothing else. (The 2-process gang of
    tests/test_torch_distributed.py shards them.)"""
    cfg_cls, mod_cls = chip_smoke.unit_family(family)[:2]
    n = chip_smoke.UNIT_FAMILIES[family]
    module = mod_cls(cfg_cls.tiny(), device="meta")
    blocks = decoder_blocks(module)
    assert len(blocks) == n == len({id(b) for b in blocks})
    assert all(isinstance(b, mod_cls._fsdp_blocks) for b in blocks)
