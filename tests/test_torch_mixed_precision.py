"""fp16 with dynamic loss scaling in the port, against the JAX package.

A tiny Llama (2 layers, hidden 64) computing in float16 over fp32 masters,
from the same flax-initialised weights in both packages
(``models/convert.py``), on the CPU:

- ``DynamicLossScale``'s growth, backoff and floor of 1.0, step for step;
- the fused step over 6 steps, the fourth of which overflows (its loss is
  multiplied by inf): losses and grad norms within rtol 2e-3 (float16
  activations round at other places in the two packages; observed
  differences are below 1e-4), scales, growth trackers and step counts
  equal exactly, the parameters bit-unchanged on the skipped step, and
  with a warmup-cosine ``adamw`` the rates (rtol 1e-6: both evaluate the
  schedule in float32) and optimizer counts of every step equal;
- the imperative loop at 2 microbatches with one overflowing window,
  against the JAX package's loop and the port's fused step. The port's
  ``clip_grad_norm_`` returns the norm of the unscaled gradients, which
  is the JAX package's (scaled) norm divided by its scale: a fault of the
  reference (ROADMAP.md Queue C);
- ``scaler.bin``: a JAX fp16 ``save_state()`` resumes in the port with its
  scale, and the port writes the JAX pickle's keys and types.
"""

import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu import Model as JaxModel
from accelerate_tpu.models import LlamaConfig as JaxLlamaConfig
from accelerate_tpu.models import LlamaForCausalLM as JaxLlama
from accelerate_tpu.models import cross_entropy_loss as jax_cross_entropy
from accelerate_tpu.train_state import DynamicLossScale as JaxLossScale
from accelerate_tpu.train_state import grads_all_finite as jax_grads_all_finite
from accelerate_tpu.utils import GradientAccumulationPlugin as JaxPlugin
from accelerate_tpu.utils import GradScalerKwargs as JaxGradScalerKwargs
from accelerate_tpu.utils import ProjectConfiguration as JaxProjectConfiguration
from accelerate_tpu_torch import (
    Accelerator,
    DynamicLossScale,
    GradientAccumulationPlugin,
    GradScalerKwargs,
    Model,
    ProjectConfiguration,
    adamw,
    grads_all_finite,
    warmup_cosine_decay_schedule,
)
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


WIDTH = dict(num_hidden_layers=2, hidden_size=64)
STEPS, ROWS, SEQ, OVERFLOW = 6, 8, 16, 3   # 8 rows for the 8-device CPU mesh
SCHEDULE = dict(init_value=0.0, peak_value=1e-3, warmup_steps=2, decay_steps=8)
SCALER = dict(init_scale=1024.0, growth_interval=2)
LOSS_RTOL = 2e-3


def _reset():
    from accelerate_tpu.state import AcceleratorState as JS
    from accelerate_tpu.state import GradientState as JG

    for cls in (AcceleratorState, GradientState, PartialState, JS, JG):
        cls._reset_state()


@pytest.fixture(autouse=True)
def reset_state():
    _reset()
    yield
    _reset()


def _batches(n=STEPS, rows=ROWS, overflow=OVERFLOW):
    """Token batches; ``m`` multiplies the loss: inf on the overflowing one."""
    rng = np.random.default_rng(0)
    out = []
    for i in range(n):
        ids = rng.integers(0, 256, (rows, SEQ + 1), dtype=np.int32)
        m = np.full((rows,), np.inf if i == overflow else 1.0, np.float32)
        out.append({"x": ids[:, :-1], "y": ids[:, 1:], "m": m})
    return out


@pytest.fixture(scope="module")
def flax_params():
    module = JaxLlama(JaxLlamaConfig.tiny(dtype=jnp.float16, **WIDTH))
    params = JaxModel.from_flax(module, jax.random.key(0), _batches(1)[0]["x"][:2]).params
    return jax.tree.map(np.asarray, params)


def _jax_counts(opt_state):
    kinds = (optax.ScaleByAdamState, optax.ScaleByScheduleState)
    leaves = jax.tree.leaves(opt_state, is_leaf=lambda x: isinstance(x, kinds))
    return [int(x.count) for x in leaves if isinstance(x, kinds)]


def _jax_fused(flax_params, scheduled, project_dir=None, save_after=None):
    """The JAX package's fused fp16 step: per step (loss, grad norm, scale,
    growth tracker, step, optimizer counts, params unchanged)."""
    module = JaxLlama(JaxLlamaConfig.tiny(dtype=jnp.float16, **WIDTH))
    acc = JaxAccelerator(
        mixed_precision="fp16", kwargs_handlers=[JaxGradScalerKwargs(**SCALER)],
        project_config=JaxProjectConfiguration(project_dir=project_dir,
                                               automatic_checkpoint_naming=True))
    model = JaxModel(module=module, params=jax.tree.map(jnp.asarray, flax_params))
    rate = optax.warmup_cosine_decay_schedule(**SCHEDULE) if scheduled else 1e-3
    acc.prepare(model, optax.adamw(rate, weight_decay=0.1))

    def loss_fn(p, b):
        return jax_cross_entropy(module.apply({"params": p}, b["x"]), b["y"]) * jnp.max(b["m"])

    step = acc.prepare_train_step(loss_fn, max_grad_norm=1.0)
    rows = []
    for i, b in enumerate(_batches()):
        before = jax.tree.map(np.asarray, acc.train_state.params)
        state, m = step(acc.train_state, {k: jnp.asarray(v) for k, v in b.items()})
        after = jax.tree.map(np.asarray, state.params)
        unchanged = all(np.array_equal(a, c) for a, c in zip(jax.tree.leaves(before),
                                                             jax.tree.leaves(after)))
        rows.append((float(m["loss"]), float(m["grad_norm"]), float(state.loss_scale.scale),
                     int(state.loss_scale.growth_tracker), int(state.step),
                     _jax_counts(state.opt_state), unchanged))
        if save_after == i + 1:
            acc.save_state()
    return rows


def _port_accelerator(flax_params, scheduled, seed_params=True, **acc_kw):
    cfg = LlamaConfig.tiny(dtype=torch.float16, **WIDTH)
    module = LlamaForCausalLM(cfg)
    if seed_params:
        module.load_state_dict(llama_params_from_flax(cfg, flax_params))
    else:
        module.init_weights(torch.Generator().manual_seed(5))
    acc = Accelerator(mixed_precision="fp16", cpu=True,
                      kwargs_handlers=[GradScalerKwargs(**SCALER)], **acc_kw)
    rate = warmup_cosine_decay_schedule(**SCHEDULE) if scheduled else 1e-3
    model, opt = acc.prepare(Model(module), adamw(rate, weight_decay=0.1))
    return acc, model, opt


def _port_loss(model, b):
    return cross_entropy_loss(model(b["x"].long()), b["y"].long()) * b["m"].max()


def _port_fused(acc, batches):
    step = acc.prepare_train_step(_port_loss, max_grad_norm=1.0)
    rows, lrs = [], []
    for b in batches:
        st = acc.train_state
        before = {k: v.detach().clone() for k, v in st.params.items()}
        st, m = step(st, b)
        unchanged = all(torch.equal(before[k], v) for k, v in st.params.items())
        opt = st.optimizer
        adam_steps = {float(s["step"]) for s in opt.state.values()}
        assert len(adam_steps) == 1
        rows.append((float(m["loss"]), float(m["grad_norm"]), float(st.loss_scale.scale),
                     int(st.loss_scale.growth_tracker), int(st.step),
                     [int(adam_steps.pop()), opt.count], unchanged))
        lrs.append(float(opt.param_groups[0]["lr"]))
    return rows, lrs


def _assert_rows_match(port, ref):
    for i, (got, want) in enumerate(zip(port, ref)):
        if i == OVERFLOW:
            assert not np.isfinite(got[0]) and not np.isfinite(want[0])
            assert not np.isfinite(got[1]) and not np.isfinite(want[1])
        else:
            np.testing.assert_allclose(got[:2], want[:2], rtol=LOSS_RTOL, err_msg=str(i))
        # scale, growth tracker, step, counts and the skip: exactly.
        assert got[2:5] == want[2:5], (i, got, want)
        assert got[5][0] == got[5][1] and [got[5][0]] * len(want[5]) == want[5], (i, got, want)
        assert got[6] == want[6], (i, got, want)   # parameters unchanged
    assert ref[OVERFLOW][6] and not ref[OVERFLOW + 1][6]


# ---------------------------------------------------------------------------
# DynamicLossScale
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("init,interval,flags", [
    (1024.0, 2, [True, True, False, True, True, True, False, False]),
    (4.0, 3, [False, False, False, False, True, True, True, True]),     # the 1.0 floor
    (65536.0, 1, [True, False, True, True, False, True]),
])
def test_dynamic_loss_scale_matches_jax(init, interval, flags):
    ref = JaxLossScale.create(init_scale=init, growth_interval=interval)
    port = DynamicLossScale.create(init_scale=init, growth_interval=interval)
    for finite in flags:
        ref = ref.update(jnp.asarray(finite))
        port.update(torch.tensor(finite))
        assert float(port.scale) == float(ref.scale)
        assert int(port.growth_tracker) == int(ref.growth_tracker)
    assert port.scale.dtype == torch.float32 and port.growth_tracker.dtype == torch.int32


def test_unscale_and_finite_check_match_jax():
    rng = np.random.default_rng(3)
    grads = [rng.standard_normal(s).astype(np.float32) * 512 for s in ((4, 3), (7,))]
    ref = JaxLossScale.create(init_scale=512.0)
    port = DynamicLossScale.create(init_scale=512.0)
    want = ref.unscale([jnp.asarray(g) for g in grads])
    got = [torch.from_numpy(g.copy()) for g in grads]
    assert bool(port.unscale(got))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    grads[1][2] = np.nan
    assert not bool(port.unscale([torch.from_numpy(g) for g in grads]))
    for bad in (np.nan, np.inf, -np.inf, None):
        g = [x.copy() for x in grads[:1]]
        if bad is not None:
            g[0][1, 2] = bad
        assert bool(grads_all_finite([torch.from_numpy(x) for x in g])) == bool(
            jax_grads_all_finite([jnp.asarray(x) for x in g]))


# ---------------------------------------------------------------------------
# The fused step
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_scheduled_run(flax_params, tmp_path_factory):
    """The JAX fused run with the warmup-cosine schedule, saved after the
    overflow and one more step (step 5 of 6)."""
    _reset()
    project = tmp_path_factory.mktemp("jax_fp16")
    rows = _jax_fused(flax_params, True, project_dir=str(project), save_after=OVERFLOW + 2)
    _reset()
    return rows, project


@pytest.mark.parametrize("scheduled", [False, True], ids=["constant", "warmup_cosine"])
def test_fused_fp16_step_matches_jax(flax_params, jax_scheduled_run, scheduled):
    ref = jax_scheduled_run[0] if scheduled else _jax_fused(flax_params, False)
    _reset()
    acc, _, _ = _port_accelerator(flax_params, scheduled)
    rows, lrs = _port_fused(acc, _batches())
    _assert_rows_match(rows, ref)
    # The rate of every step: optax's schedule, in float32, at JAX's count
    # before the step (the overflowed step tried the rate its successor
    # applies).
    schedule = (optax.warmup_cosine_decay_schedule(**SCHEDULE) if scheduled
                else optax.constant_schedule(1e-3))
    counts_before = [0] + [r[5][0] for r in ref[:-1]]
    np.testing.assert_allclose(lrs, [float(schedule(c)) for c in counts_before], rtol=1e-6,
                               atol=1e-12)
    assert rows[OVERFLOW][5] == rows[OVERFLOW - 1][5] and lrs[OVERFLOW] == lrs[OVERFLOW + 1]


def test_scaler_bin_resumes_a_jax_fp16_checkpoint(flax_params, jax_scheduled_run, tmp_path):
    """The port (other weights) loads the JAX checkpoint saved after step 5
    and takes step 6 as the JAX run did: the scale and its tracker come
    from ``scaler.bin``. The port's own ``scaler.bin`` holds the JAX
    pickle's keys and types."""
    ref, project = jax_scheduled_run
    with open(project / "checkpoints" / "checkpoint_0" / "scaler.bin", "rb") as f:
        jax_scaler = pickle.load(f)
    acc, _, _ = _port_accelerator(flax_params, True, seed_params=False,
                                  project_config=ProjectConfiguration(
                                      project_dir=str(project), automatic_checkpoint_naming=True))
    acc.load_state()
    st = acc.train_state
    assert (float(st.loss_scale.scale), int(st.loss_scale.growth_tracker)) == (
        jax_scaler["scale"], jax_scaler["growth_tracker"]) == ref[OVERFLOW + 1][2:4]
    assert int(st.step) == st.optimizer.count == ref[OVERFLOW + 1][4]
    rows, _ = _port_fused(acc, _batches()[OVERFLOW + 2:])
    np.testing.assert_allclose(rows[0][:2], ref[-1][:2], rtol=LOSS_RTOL)
    assert rows[0][2:5] == ref[-1][2:5]

    out = acc.save_state(str(tmp_path / "port_ckpt"))
    with open(f"{out}/scaler.bin", "rb") as f:
        port_scaler = pickle.load(f)
    assert set(port_scaler) == set(jax_scaler) == {"scale", "growth_tracker"}
    assert type(port_scaler["scale"]) is float and type(port_scaler["growth_tracker"]) is int
    assert (port_scaler["scale"], port_scaler["growth_tracker"]) == ref[-1][2:4]


# ---------------------------------------------------------------------------
# The imperative loop
# ---------------------------------------------------------------------------

GA, WINDOWS, BAD_WINDOW = 2, 4, 1


def _loop_batches():
    """Microbatches of 8 rows, two a window; window 1's second overflows."""
    flat = _batches(n=GA * WINDOWS, overflow=GA * BAD_WINDOW + 1)
    return [flat[w * GA:(w + 1) * GA] for w in range(WINDOWS)]


def _jax_loop(flax_params):
    module = JaxLlama(JaxLlamaConfig.tiny(dtype=jnp.float16, **WIDTH))
    acc = JaxAccelerator(mixed_precision="fp16", kwargs_handlers=[JaxGradScalerKwargs(**SCALER)],
                         gradient_accumulation_plugin=JaxPlugin(num_steps=GA))
    model = JaxModel(module=module, params=jax.tree.map(jnp.asarray, flax_params))
    _, opt = acc.prepare(model, optax.adamw(1e-3, weight_decay=0.1))

    def loss_fn(p, b):
        return jax_cross_entropy(module.apply({"params": p}, b["x"]), b["y"]) * jnp.max(b["m"])

    rows = []
    for window in _loop_batches():
        for mb in window:
            with acc.accumulate(model):
                loss = acc.backward(loss_fn, {k: jnp.asarray(v) for k, v in mb.items()})
                norm = acc.clip_grad_norm_(None, 1.0)
                scale = float(acc.train_state.loss_scale.scale)
                opt.step()
                opt.zero_grad()
        rows.append((float(loss), float(norm) / scale, opt.step_was_skipped,
                     float(acc.train_state.loss_scale.scale), int(acc.train_state.step)))
    return rows


def test_imperative_fp16_loop_matches_jax_and_the_fused_step(flax_params):
    ref = _jax_loop(flax_params)
    _reset()
    acc, model, opt = _port_accelerator(
        flax_params, False, gradient_accumulation_plugin=GradientAccumulationPlugin(num_steps=GA))
    rows = []
    for window in _loop_batches():
        for mb in window:
            with acc.accumulate(model):
                loss = acc.backward(_port_loss, mb)
                norm = acc.clip_grad_norm_(None, 1.0)
                opt.step()
                opt.zero_grad()
        rows.append((float(loss), float(norm), opt.step_was_skipped,
                     float(acc.train_state.loss_scale.scale), int(acc.train_state.step)))
    assert acc.optimizer_step_was_skipped is False
    assert [r[2] for r in rows] == [r[2] for r in ref] == [w == BAD_WINDOW
                                                          for w in range(WINDOWS)]
    for i, (got, want) in enumerate(zip(rows, ref)):
        assert got[3:] == want[3:], (i, got, want)
        if i != BAD_WINDOW:
            # The port's norm is the unscaled one: JAX's divided by its scale.
            np.testing.assert_allclose(got[:2], want[:2], rtol=LOSS_RTOL, err_msg=str(i))

    # The port's fused step on the windows' rows (microbatch i of the fused
    # split takes rows i, i + GA, ...) from the same weights, within rtol
    # 1e-4: the loop seeds each backward with loss / GA · scale, the fused
    # step with loss · scale, and halving changes the rounding of float16
    # gradients below float16's smallest normal (observed 3e-5).
    _reset()
    acc2, _, _ = _port_accelerator(
        flax_params, False, gradient_accumulation_plugin=GradientAccumulationPlugin(num_steps=GA))
    fused = [{k: np.stack([mb[k] for mb in window], axis=1).reshape(GA * ROWS, *mb[k].shape[1:])
              for k in window[0]} for window in _loop_batches()]
    step = acc2.prepare_train_step(_port_loss, max_grad_norm=1.0)
    for i, b in enumerate(fused):
        st, m = step(acc2.train_state, b)
        assert (float(st.loss_scale.scale), int(st.step)) == rows[i][3:], i
        if i != BAD_WINDOW:
            np.testing.assert_allclose(float(m["grad_norm"]), rows[i][1], rtol=1e-4)


# ---------------------------------------------------------------------------
# Settings
# ---------------------------------------------------------------------------


def test_fp16_settings():
    """The handler is taken; ``enabled=False`` trains fp16 without a scale;
    an optimizer that cannot skip on the device is refused; a fused torch
    AdamW is taken; ``mu_dtype`` still refuses, naming its reason."""
    acc = Accelerator(mixed_precision="fp16", cpu=True,
                      kwargs_handlers=[GradScalerKwargs(enabled=False)])
    assert acc._mp_policy.compute_dtype == torch.float16
    acc.prepare(Model(torch.nn.Linear(3, 2)), adamw(1e-3))
    assert acc.train_state.loss_scale is None and acc.train_state.step == 0
    _reset()
    acc = Accelerator(mixed_precision="fp16", cpu=True)
    module = torch.nn.Linear(3, 2)
    with pytest.raises(ValueError, match="fused"):
        acc.prepare(Model(module), torch.optim.SGD(module.parameters(), lr=0.1))
    _reset()
    acc = Accelerator(mixed_precision="fp16", cpu=True)
    module = torch.nn.Linear(3, 2)
    acc.prepare(Model(module), torch.optim.AdamW(module.parameters(), fused=True))
    assert float(acc.train_state.loss_scale.scale) == 65536.0
    with pytest.raises(NotImplementedError, match="first moment"):
        adamw(1e-3, mu_dtype=torch.bfloat16)
