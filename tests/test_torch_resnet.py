"""The port's ResNet (``accelerate_tpu_torch/models/resnet.py``: flax's
BatchNorm and ``"SAME"`` padding in ``models/layers.py``, the
``mutable_state`` train step, ``extra_state`` in checkpoints) against the
JAX package's, on the CPU.

Weights are drawn with numpy from a seed in the port's layout and carried
to the flax tree with ``resnet_params_to_flax``; the running statistics
start away from flax's zeros and ones, so that evaluation reads them.

Tolerances: fp32 logits within 1e-5 of the JAX module's in train and eval
mode, bf16 within 2e-2 relative (L2); the running statistics after a
train-mode forward and after three ``prepare_train_step(mutable_state=
True)`` steps (with and without gradient accumulation) within 1e-5, and
the steps' losses and grad norms within rtol 1e-4 of the JAX
Accelerator's; checkpoints carry the statistics across packages exactly.
The steps run SGD (``optax.sgd``, ``torch.optim.SGD``), whose update is
linear in the gradient: AdamW's m/√v moves an entry whose gradient is
near zero by up to a whole step either way on a rounding difference, and
the statistics of the next batch with it.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu import Model as JaxModel
from accelerate_tpu.models import resnet as jresnet
from accelerate_tpu.state import AcceleratorState as JaxAS
from accelerate_tpu.state import GradientState as JaxGS
from accelerate_tpu.state import PartialState as JaxPS
from accelerate_tpu_torch import Accelerator, Model, adamw
from accelerate_tpu_torch.models import ResNet, ResNetConfig, resnet_loss, resnet_params_to_flax
from accelerate_tpu_torch.models.layers import pad_same, same_padding
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState
from accelerate_tpu_torch.train_state import tree_items


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


def _images(n=8, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 4, n).astype(np.int32))


def _build(dtype=torch.float32, seed=0):
    """(port module, flax params, flax batch_stats) of one set of weights."""
    module = ResNet(ResNetConfig.tiny(dtype=dtype))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.dim() == 1:
                a = rng.standard_normal(p.shape) * 0.1 + (0.0 if name.endswith("bias") else 1.0)
            else:
                a = rng.standard_normal(p.shape) / np.sqrt(np.prod(p.shape[1:]))
            p.copy_(torch.from_numpy(a.astype(np.float32)))
        for name, b in module.named_buffers():
            a = (rng.standard_normal(b.shape) * 0.1 if name.endswith("mean")
                 else rng.uniform(0.5, 1.5, b.shape))
            b.copy_(torch.from_numpy(a.astype(np.float32)))
    params = jax.tree.map(lambda t: t.detach().numpy(),
                          resnet_params_to_flax(module.config, dict(module.named_parameters())))
    return module, params, _flax_stats(Model(module).extra_state)["batch_stats"]


def _flax_stats(tree):
    """A tree of tensors as numpy (a copy)."""
    if isinstance(tree, dict):
        return {k: _flax_stats(v) for k, v in tree.items()}
    return tree.detach().numpy().copy()


def _assert_stats_close(got, want, atol=1e-5):
    got, want = dict(tree_items(_flax_stats(got))), dict(tree_items(want))
    assert got.keys() == want.keys() and got
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=0, atol=atol, err_msg=k)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_forward_matches_jax(train):
    """fp32 logits within 1e-5 in both modes; in train mode the updated
    running statistics too (momentum 0.9 on the biased variance); bf16
    logits within 2e-2."""
    module, params, stats = _build()
    x, _ = _images()
    jmodule = jresnet.ResNet(jresnet.ResNetConfig.tiny(dtype=jnp.float32))
    variables = {"params": params, "batch_stats": stats}
    with torch.no_grad():
        if train:
            want, mutated = jmodule.apply(variables, x, train=True, mutable=["batch_stats"])
            got, new = module(torch.from_numpy(x), train=True)
            _assert_stats_close(new["batch_stats"], mutated["batch_stats"])
        else:
            want, got = jmodule.apply(variables, x), module(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    bf16, _, _ = _build(torch.bfloat16)
    jb16 = jresnet.ResNet(jresnet.ResNetConfig.tiny(dtype=jnp.bfloat16))
    want = jb16.apply(variables, x, train=train, mutable=["batch_stats"] if train else False)
    with torch.no_grad():
        got = bf16(torch.from_numpy(x), train=train)
    want, got = (want[0], got[0]) if train else (want, got)
    assert got.dtype == torch.float32
    rel = np.linalg.norm(got.numpy() - np.asarray(want)) / np.linalg.norm(np.asarray(want))
    assert rel < 2e-2


def test_same_padding_windows_at_an_even_size():
    """flax's SAME at stride 2 on an even size pads (k−1)//2 before and the
    rest after: (2, 3) for the 7×7 stem on 224, (0, 1) for the 3×3 pool
    and conv2 on 112 and 56; the stem's output is flax's, and a symmetric
    ``nn.Conv2d(padding=3)`` shifts its windows."""
    assert same_padding(224, 7, 2) == (2, 3)
    assert same_padding(112, 3, 2) == (0, 1) and same_padding(56, 3, 2) == (0, 1)
    assert same_padding(56, 3, 1) == (1, 1) and same_padding(56, 1, 2) == (0, 0)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(1, 16, 16, 3)).astype(np.float32)
    w = rng.normal(size=(7, 7, 3, 4)).astype(np.float32)
    import flax.linen as nn

    conv = nn.Conv(4, (7, 7), strides=(2, 2), use_bias=False)
    want = np.asarray(conv.apply({"params": {"kernel": w}}, x))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    wt = torch.from_numpy(w).permute(3, 2, 0, 1)
    got = torch.nn.functional.conv2d(pad_same(xt, 7, 2), wt, stride=2).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    symmetric = torch.nn.functional.conv2d(xt, wt, stride=2, padding=3).permute(0, 2, 3, 1)
    assert symmetric.shape == got.shape and not torch.allclose(symmetric, got, atol=1e-3)
    pooled = torch.nn.functional.max_pool2d(pad_same(-xt.abs(), 3, 2, float("-inf")), 3, 2)
    want = nn.max_pool(-np.abs(x), (3, 3), strides=(2, 2), padding="SAME")
    np.testing.assert_array_equal(pooled.permute(0, 2, 3, 1).numpy(), np.asarray(want))


LR = 0.1


def _jax_steps(params, stats, ga, x, y, steps=3):
    jmodule = jresnet.ResNet(jresnet.ResNetConfig.tiny(dtype=jnp.float32))
    acc = JaxAccelerator(gradient_accumulation_steps=ga)
    model = JaxModel(module=jmodule, params=jax.tree.map(jnp.array, params),
                     extra_state={"batch_stats": jax.tree.map(jnp.array, stats)})
    acc.prepare(model, optax.sgd(LR))
    step = acc.prepare_train_step(
        lambda p, extra, b: jresnet.resnet_loss(jmodule, p, extra, b["x"], b["y"]),
        mutable_state=True, max_grad_norm=1.0)
    state, metrics = acc.train_state, []
    for _ in range(steps):
        state, m = step(state, {"x": jnp.asarray(x), "y": jnp.asarray(y)})
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return metrics, jax.tree.map(np.asarray, state.extra_state["batch_stats"]), state


def _port_steps(module, ga, x, y, steps=3, optimizer=None, **acc_kw):
    acc = Accelerator(cpu=True, gradient_accumulation_steps=ga, **acc_kw)
    model = Model(module)
    acc.prepare(model, optimizer or torch.optim.SGD(module.parameters(), lr=LR))
    step = acc.prepare_train_step(
        lambda m, extra, b: resnet_loss(m, extra, b["x"], b["y"]), mutable_state=True,
        max_grad_norm=1.0)
    state, metrics = acc.train_state, []
    for _ in range(steps):
        state, m = step(state, {"x": torch.from_numpy(x), "y": torch.from_numpy(y).long()})
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return acc, state, metrics


@pytest.mark.parametrize("ga", [1, 2], ids=["ga1", "ga2"])
def test_batch_stats_after_three_mutable_steps_match_jax(ga):
    """``prepare_train_step(mutable_state=True)`` with ``resnet_loss``: the
    running statistics threaded through each microbatch in order (the JAX
    step's scan carry) and stored in ``state.extra_state``, the model's
    buffers; losses and grad norms within rtol 1e-4, statistics within
    1e-5; eval-mode logits then read the stored statistics."""
    module, params, stats = _build()
    x, y = _images()
    want, want_stats, _ = _jax_steps(params, stats, ga, x, y)
    _, state, got = _port_steps(module, ga, x, y)
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=1e-4)
    _assert_stats_close(state.extra_state["batch_stats"], want_stats)
    assert state.extra_state["batch_stats"]["stem_bn"]["mean"] is module.stem_bn.mean
    with torch.no_grad():
        eval_logits = module(torch.from_numpy(x))
        explicit = module(torch.from_numpy(x), batch_stats=_torch_tree(want_stats))
    torch.testing.assert_close(eval_logits, explicit, rtol=1e-4, atol=1e-4)


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree))


def test_model_extra_state_and_the_step_options():
    """``Model.extra_state`` is flax's ``{"batch_stats": ...}`` of the
    buffers (the JAX test's ``"batch_stats" in model.extra_state``); the
    option ``has_aux`` beside ``mutable_state`` is refused."""
    module, _, stats = _build()
    extra = Model(module).extra_state
    assert set(extra) == {"batch_stats"}
    assert set(extra["batch_stats"]) == set(stats)
    assert extra["batch_stats"]["stage0_block0"]["bn3"]["var"] is module.stage0_block0.bn3.var
    acc = Accelerator(cpu=True)
    acc.prepare(Model(module), adamw(1e-3))
    with pytest.raises(ValueError, match="mutually exclusive"):
        acc.prepare_train_step(lambda m, e, b: None, mutable_state=True, has_aux=True)


def test_resnet50_parameter_count():
    """The published architecture: the JAX module's 25.56M parameters."""
    module = ResNet(ResNetConfig.resnet50(), device="meta")
    n = sum(p.numel() for p in module.parameters())
    shapes = jax.eval_shape(lambda: jresnet.ResNet(jresnet.ResNetConfig.resnet50()).init(
        jax.random.key(0), jnp.zeros((1, 224, 224, 3))))
    assert n == sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes["params"]))
    assert 25.0e6 < n < 26.2e6
    assert sum(b.numel() for b in module.buffers()) == sum(
        int(np.prod(a.shape)) for a in jax.tree.leaves(shapes["batch_stats"]))


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_batch_stats_survive_save_load_across_packages(tmp_path, direction):
    """``optimizer.bin``'s ``extra_state`` carries the trained statistics:
    a port checkpoint loads into the JAX package's live state, and a JAX
    one into the port's buffers, exactly; parameters with them."""
    module, params, stats = _build()
    x, y = _images()
    if direction == "port_to_jax":
        acc, state, _ = _port_steps(module, 1, x, y, steps=1, optimizer=adamw(1e-3),
                                    project_dir=str(tmp_path))
        out = acc.save_state(str(tmp_path / "ckpt"))
        trained = _flax_stats(state.extra_state)["batch_stats"]
        jmodule = jresnet.ResNet(jresnet.ResNetConfig.tiny(dtype=jnp.float32))
        jacc = JaxAccelerator(project_dir=str(tmp_path))
        jacc.prepare(JaxModel(module=jmodule, params=params,
                              extra_state={"batch_stats": stats}), optax.adamw(1e-3))
        jacc.load_state(out)
        _assert_stats_close(_torch_tree(jax.tree.map(np.asarray, jacc.train_state.extra_state
                                                     ["batch_stats"])), trained, atol=0)
        return
    jmodule = jresnet.ResNet(jresnet.ResNetConfig.tiny(dtype=jnp.float32))
    jacc = JaxAccelerator(project_dir=str(tmp_path))
    jacc.prepare(JaxModel(module=jmodule, params=jax.tree.map(jnp.array, params),
                          extra_state={"batch_stats": jax.tree.map(jnp.array, stats)}),
                 optax.adamw(1e-3))
    jstep = jacc.prepare_train_step(
        lambda p, extra, b: jresnet.resnet_loss(jmodule, p, extra, b["x"], b["y"]),
        mutable_state=True)
    jstep(jacc.train_state, {"x": jnp.asarray(x), "y": jnp.asarray(y)})
    trained = jax.tree.map(np.asarray, jacc.train_state.extra_state["batch_stats"])
    out = jacc.save_state(str(tmp_path / "ckpt"))
    acc = Accelerator(cpu=True)
    acc.prepare(Model(module), adamw(1e-3))
    acc.load_state(out)
    _assert_stats_close(acc.train_state.extra_state["batch_stats"], trained, atol=0)
    _assert_stats_close(Model(module).extra_state["batch_stats"], trained, atol=0)


def test_converter_round_trip_bit_equal():
    """``resnet_params_to_flax`` gives the JAX module's tree (names and
    shapes of its own initialisation), and back, bit for bit."""
    from accelerate_tpu_torch.models import resnet_params_from_flax

    module, params, _ = _build()
    shapes = jax.eval_shape(lambda: jresnet.ResNet(jresnet.ResNetConfig.tiny()).init(
        jax.random.key(0), jnp.zeros((1, 32, 32, 3))))["params"]
    assert jax.tree.map(lambda a: a.shape, shapes) == jax.tree.map(np.shape, params)
    back = resnet_params_from_flax(module.config, params)
    named = dict(module.named_parameters())
    assert back.keys() == named.keys()
    assert all(torch.equal(back[k], named[k].detach()) for k in back)
