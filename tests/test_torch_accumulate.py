"""The port's imperative training loop (``accumulate`` / ``backward`` /
``optimizer.step()`` / ``clip_grad_norm_``) against the JAX package's, and
against the port's own fused step.

The JAX side runs the loop as ``tests/test_training.py`` drives it, on the
tiny Llama (2 layers, hidden 64, fp32) over a prepared 10-batch loader; the
port's side starts from the same flax-initialised weights
(``models/convert.py``) and the same batches. Both must give the same
per-microbatch losses, ``clip_grad_norm_`` returns, ``sync_gradients``
flags, optimizer-step and scheduler counts, learning rates, and
parameters after the run (rtol 1e-4, as ``test_torch_train.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import accelerate_tpu.data_loader as jdl
from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu import Model as JaxModel
from accelerate_tpu.models import LlamaConfig as JaxLlamaConfig
from accelerate_tpu.models import LlamaForCausalLM as JaxLlama
from accelerate_tpu.models import cross_entropy_loss as jax_cross_entropy
from accelerate_tpu.utils import GradientAccumulationPlugin as JaxPlugin
from accelerate_tpu_torch import (
    Accelerator,
    AcceleratedOptimizer,
    ColumnDataset,
    GradientAccumulationPlugin,
    Model,
    ProjectConfiguration,
    adamw,
    warmup_cosine_decay_schedule,
)
from accelerate_tpu_torch.accelerator import _microbatch_split
from accelerate_tpu_torch.models import (
    LlamaConfig,
    LlamaForCausalLM,
    cross_entropy_loss,
    llama_params_from_flax,
    llama_params_to_flax,
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
# 10 batches of 8 rows (one per virtual device of the JAX mesh).
ROWS, SEQ, BATCH, LR = 80, 17, 8, 1e-3
SCHEDULE = dict(init_value=0.0, peak_value=1e-3, warmup_steps=2, decay_steps=8)


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


def _tokens():
    return np.random.default_rng(0).integers(0, 256, (ROWS, SEQ), dtype=np.int32)


class _Spec:
    def __init__(self, dataset):
        self.dataset, self.batch_size, self.sampler, self.drop_last = dataset, BATCH, None, True


@pytest.fixture(scope="module")
def flax_params():
    module = JaxLlama(JaxLlamaConfig.tiny(dtype=jnp.float32, **WIDTH))
    params = JaxModel.from_flax(module, jax.random.key(0), _tokens()[:2, :-1]).params
    return jax.tree.map(np.asarray, params)


def _jax_loop(flax_params, ga, clip, scheduled, sync_with_dataloader=True):
    """The JAX package's imperative loop over one pass of the loader: per
    microbatch (loss, clip_grad_norm_ return, sync_gradients, optimizer
    steps, scheduler count, scheduler rate), and the parameters after."""
    module = JaxLlama(JaxLlamaConfig.tiny(dtype=jnp.float32, **WIDTH))
    acc = JaxAccelerator(gradient_accumulation_plugin=JaxPlugin(
        num_steps=ga, sync_with_dataloader=sync_with_dataloader))
    model = JaxModel(module=module, params=jax.tree.map(jnp.asarray, flax_params))
    schedule = optax.warmup_cosine_decay_schedule(**SCHEDULE) if scheduled else LR
    prepared = acc.prepare(model, optax.adamw(schedule),
                           _Spec(jdl.ColumnDataset(ids=_tokens())),
                           *([schedule] if scheduled else []))
    _, opt, loader = prepared[:3]
    sched = prepared[3] if scheduled else None

    def loss_fn(p, b):
        return jax_cross_entropy(module.apply({"params": p}, b["ids"][:, :-1]), b["ids"][:, 1:])

    rows = []
    for batch in loader:
        with acc.accumulate(model):
            loss = acc.backward(loss_fn, batch)
            norm = acc.clip_grad_norm_(None, 1.0) if clip else None
            opt.step()
            if sched is not None:
                sched.step()
            opt.zero_grad()
        rows.append((float(loss), None if norm is None else float(norm), acc.sync_gradients,
                     int(acc.train_state.step), sched and sched._step_count,
                     sched and sched.get_last_lr()))
    return rows, jax.tree.map(np.asarray, acc.train_state.params)


def _port_accelerator(flax_params, ga, scheduled, sync_with_dataloader=True,
                      project_dir=None):
    cfg = LlamaConfig.tiny(dtype=torch.float32, **WIDTH)
    module = LlamaForCausalLM(cfg)
    module.load_state_dict(llama_params_from_flax(cfg, flax_params))
    acc = Accelerator(cpu=True, gradient_accumulation_plugin=GradientAccumulationPlugin(
        num_steps=ga, sync_with_dataloader=sync_with_dataloader),
        project_config=ProjectConfiguration(project_dir=project_dir,
                                            automatic_checkpoint_naming=project_dir is not None))
    schedule = warmup_cosine_decay_schedule(**SCHEDULE) if scheduled else LR
    prepared = acc.prepare(Model(module), adamw(schedule),
                           _Spec(ColumnDataset(ids=_tokens())), *([schedule] if scheduled else []))
    return acc, prepared


def _port_loss(model, b):
    ids = b["ids"].long()
    return cross_entropy_loss(model(ids[:, :-1]), ids[:, 1:])


def _port_microbatch(acc, model, opt, sched, batch, clip):
    with acc.accumulate(model):
        loss = acc.backward(_port_loss, batch)
        norm = acc.clip_grad_norm_(None, 1.0) if clip else None
        opt.step()
        if sched is not None:
            sched.step()
        opt.zero_grad()
    return (float(loss), None if norm is None else float(norm), acc.sync_gradients,
            acc.train_state.step, sched and sched._step_count, sched and sched.get_last_lr())


def _port_loop(flax_params, ga, clip, scheduled, sync_with_dataloader=True):
    acc, prepared = _port_accelerator(flax_params, ga, scheduled, sync_with_dataloader)
    model, opt, loader = prepared[:3]
    sched = prepared[3] if scheduled else None
    rows = [_port_microbatch(acc, model, opt, sched, batch, clip) for batch in loader]
    cfg = model.module.config
    params = llama_params_to_flax(cfg, {n: p.detach() for n, p in
                                        model.module.named_parameters()})
    return rows, jax.tree.map(lambda t: t.numpy(), params), acc, opt


LOOPS = [  # (ga, clip, scheduled, sync_with_dataloader)
    (1, True, False, True),
    (2, False, True, True),
    (4, True, True, True),      # 10 batches: windows of 4, 4 and a last one of 2
    (4, True, False, False),    # the last 2 batches never step
]


@pytest.mark.parametrize("ga,clip,scheduled,sync_with_dataloader", LOOPS,
                         ids=["ga1_clip", "ga2_schedule", "ga4_clip_schedule_cut",
                              "ga4_no_dataloader_sync"])
def test_imperative_loop_matches_jax(flax_params, ga, clip, scheduled, sync_with_dataloader):
    want, want_params = _jax_loop(flax_params, ga, clip, scheduled, sync_with_dataloader)
    _reset()
    got, got_params, _, opt = _port_loop(flax_params, ga, clip, scheduled,
                                         sync_with_dataloader)
    assert isinstance(opt, AcceleratedOptimizer) and isinstance(opt, torch.optim.Optimizer)
    assert len(got) == len(want) == ROWS // BATCH
    # Flags, step and scheduler counts exactly; numbers within rtol 1e-4.
    assert [r[2:5] for r in got] == [r[2:5] for r in want]
    np.testing.assert_allclose([r[0] for r in got], [r[0] for r in want], rtol=1e-4)
    if clip:
        np.testing.assert_allclose([r[1] for r in got], [r[1] for r in want], rtol=1e-4)
    if scheduled:
        np.testing.assert_allclose([r[5] for r in got], [r[5] for r in want], rtol=1e-6)
    windows = -(-ROWS // BATCH // ga) if sync_with_dataloader else ROWS // BATCH // ga
    assert got[-1][3] == windows
    _assert_params_close(got_params, want_params, steps=got[-1][3])


def _assert_params_close(got, want, steps):
    """Parameters after ``steps`` AdamW steps: within rtol 1e-4 (atol 1e-5)
    but for at most 2 entries a tensor, and every entry within steps·lr.
    AdamW's m/√v turns a last-bit difference of a near-zero gradient into
    a move of up to lr either way (tests/test_torch_distributed.py's
    _assert_params_close has the JAX package's own example)."""
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        g, name = flat_got[path], jax.tree_util.keystr(path)
        diff = np.abs(g - w)
        assert diff.max() <= steps * LR, name
        assert (diff > 1e-5 + 1e-4 * np.abs(w)).sum() <= 2, name


def test_sync_flags_over_a_cut_window():
    """ga 4 over 10 batches: the 4th, 8th and the loader's last batch end a
    window; without sync_with_dataloader only the 4th and 8th."""
    for sync, want in ((True, [3, 7, 9]), (False, [3, 7])):
        _reset()
        acc = Accelerator(cpu=True, gradient_accumulation_plugin=GradientAccumulationPlugin(
            num_steps=4, sync_with_dataloader=sync))
        loader = acc.prepare(_Spec(ColumnDataset(ids=_tokens())))
        flags = []
        for _ in loader:
            with acc.accumulate():
                flags.append(acc.sync_gradients)
        assert [i for i, f in enumerate(flags) if f] == want


def _fused_and_imperative(flax_params, ga, batches):
    """Three fused steps, then three windows of the imperative loop over
    the same microbatches (``_microbatch_split``), from the same weights:
    each run's (loss, grad norm) per optimizer step and parameters."""
    runs = []
    for fused in (True, False):
        _reset()
        cfg = LlamaConfig.tiny(dtype=torch.float32, **WIDTH)
        module = LlamaForCausalLM(cfg)
        module.load_state_dict(llama_params_from_flax(cfg, flax_params))
        acc = Accelerator(cpu=True, gradient_accumulation_steps=ga)
        model, opt = acc.prepare(Model(module), adamw(LR, weight_decay=0.1))
        metrics = []
        if fused:
            step = acc.prepare_train_step(_port_loss, max_grad_norm=1.0)
            for b in batches:
                _, m = step(acc.train_state, b)
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
        else:
            for b in batches:
                losses = []
                for mb in _microbatch_split({k: torch.as_tensor(v) for k, v in b.items()}, ga):
                    with acc.accumulate(model):
                        losses.append(acc.backward(_port_loss, mb))
                        norm = acc.clip_grad_norm_(None, 1.0)
                        opt.step()
                        opt.zero_grad()
                metrics.append((float(sum(losses) / ga), float(norm)))
            assert acc.train_state.step == len(batches)
        runs.append((metrics, {n: p.detach().clone() for n, p in
                               model.module.named_parameters()}))
    return runs


@pytest.mark.parametrize("ga", [1, 2, 4, 3])
def test_imperative_loop_matches_the_fused_step(flax_params, ga):
    """Bit for bit where 1/ga is a power of two (scaling the loss before the
    backward then commutes with every rounding); at 3 within rtol 1e-6 in
    the losses and grad norms, and the parameters within what AdamW makes
    of the last-bit differences of near-zero gradients (every entry within
    the three steps' 3·lr, the rest to rounding)."""
    rows = 12 if ga == 3 else 8
    batches = [{"ids": _tokens()[i * rows:(i + 1) * rows]} for i in range(3)]
    (fused, fused_params), (imp, imp_params) = _fused_and_imperative(flax_params, ga, batches)
    if ga != 3:
        assert imp == fused
        assert all(torch.equal(imp_params[n], fused_params[n]) for n in fused_params)
        return
    np.testing.assert_allclose(np.array(imp), np.array(fused), rtol=1e-6)
    for n, want in fused_params.items():
        diff = (imp_params[n] - want).abs()
        assert float(diff.max()) <= 3 * LR, n
        assert int((diff > 1e-6).sum()) <= max(2, diff.numel() // 100), n


def test_save_and_load_between_windows_resume_bit_equal(flax_params, tmp_path):
    """ga 2 over the loader: save_state after the second window, then a
    fresh Accelerator with other weights load_state()s it and runs the
    rest of the pass; it takes the uninterrupted run's microbatches."""
    acc, (model, opt, loader, sched) = _port_accelerator(flax_params, 2, True,
                                                         project_dir=str(tmp_path))
    rows, it = [], iter(loader)
    for i, batch in enumerate(it):
        rows.append(_port_microbatch(acc, model, opt, sched, batch, clip=True))
        if i == 3:
            acc.save_state()
    it.close()
    _reset()
    other = jax.tree.map(lambda a: a * 0.5, flax_params)
    acc, (model, opt, loader, sched) = _port_accelerator(other, 2, True,
                                                         project_dir=str(tmp_path))
    acc.load_state()
    assert acc.step == 4 and acc.train_state.step == 2
    resumed = [_port_microbatch(acc, model, opt, sched, b, clip=True) for b in loader]
    assert resumed == rows[4:]


def test_no_sync_skips_the_step_and_keeps_accumulating(flax_params):
    acc, (model, opt, loader) = _port_accelerator(flax_params, 1, False)
    batch = next(iter(loader))
    with acc.no_sync(model):
        acc.backward(_port_loss, batch)
        opt.step()
        opt.zero_grad()
        assert not acc.sync_gradients
    assert acc.sync_gradients and acc.train_state.step == 0
    grads = [p.grad.clone() for p in model.parameters()]
    acc.backward(_port_loss, batch)
    assert all(torch.allclose(p.grad, 2 * g) for p, g in zip(model.parameters(), grads))
    opt.step()
    assert acc.train_state.step == 1


def test_clip_stays_armed_for_later_steps(flax_params):
    """clip_grad_norm_ arms the clip for every later step, as the JAX
    package does: the second step clips without a second call."""
    acc, (model, opt, loader) = _port_accelerator(flax_params, 1, False)
    batches = iter(loader)
    acc.backward(_port_loss, next(batches))
    acc.clip_grad_norm_(None, max_norm=1e-3)
    opt.step()
    opt.zero_grad()
    acc.backward(_port_loss, next(batches))
    grads = [p.grad.clone() for p in model.parameters()]
    norm = float(torch.linalg.vector_norm(torch.stack([g.norm() for g in grads])))
    seen = {}
    inner = acc.train_state.optimizer.step

    def spy(*a, **k):
        seen["norm"] = float(torch.linalg.vector_norm(torch.stack(
            [p.grad.norm() for p in model.parameters()])))
        return inner(*a, **k)

    acc.train_state.optimizer.step = spy
    opt.step()
    assert norm > 1e-2 and seen["norm"] == pytest.approx(1e-3, rel=1e-4)


def test_accelerator_surface_properties(flax_params):
    acc, (model, opt, loader) = _port_accelerator(flax_params, 2, False)
    assert acc.gradient_accumulation_steps == 2 and acc.sync_gradients
    acc.gradient_accumulation_steps = 3
    assert acc.gradient_state.num_steps == 3
    assert not acc.optimizer_step_was_skipped and not opt.step_was_skipped
    assert acc.mixed_precision == "no" and not acc.use_distributed
    assert acc.distributed_type.value == "NO" and acc.is_last_process
    assert acc.split_batches is False and acc.even_batches is True
    assert opt.param_groups is acc.train_state.optimizer.param_groups
    assert opt.state_dict()["param_groups"] == acc.train_state.optimizer.state_dict()[
        "param_groups"]
    assert acc.unscale_gradients() is None
