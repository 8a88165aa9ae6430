"""Pipeline parallelism of the encoders (BERT, ViT), the two-stack models
(CLIP, T5, Whisper) and ResNet in the port against the JAX package.

The JAX package splits the layer dim of every stacked leaf over ``pp`` when
it divides and leaves the rest whole, so its step under ``pp`` has the
numbers of the one-process step. Here each family's tiny fp32 model (from
numpy-seeded weights carried into both packages by ``models/convert.py``)
takes 2 ``prepare_train_step`` steps (adamw, ResNet SGD; clipping at 1.0)
at ``pp=2``
on a gloo gang of 2 CPU processes (``torch.multiprocessing`` spawn, a
``file://`` rendezvous, spawned once for the module, while the JAX
references run in two spawned processes of their own), BERT also at
``pp=2`` interleaved (``pp_virtual_stages=2``, 4 layers) and T5 also with
its ``rest`` blocks undivisible (``num_layers=2``: one ``rest`` block,
left whole on both stages). Losses and grad norms within 1e-5 relative of
the port's one-process steps and (each family's default config) of the
JAX Accelerator's, on both ranks.
ResNet has no stacked leaf: it stays whole on every stage, its BatchNorm
statistics through ``mutable_state``.

The spawned processes import this module: JAX is imported only inside the
functions that compute the references.
"""

from __future__ import annotations

import importlib
import pickle

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import accelerate_tpu_torch.models as M
from accelerate_tpu_torch import Accelerator, Model, ParallelismConfig, adamw
from accelerate_tpu_torch.models import convert
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

RTOL, STEPS, LR, SGD_LR = 1e-5, 2, 1e-3, 0.1
# name -> (port class, config class, the JAX module, config knobs)
FAMILIES = {
    "bert": ("BertForMaskedLM", "BertConfig", "bert", {}),
    "vit": ("ViTForImageClassification", "ViTConfig", "vit", {}),
    "clip": ("CLIPModel", "CLIPConfig", "clip", {}),
    "t5": ("T5ForConditionalGeneration", "T5Config", "t5", {"num_layers": 3}),
    "whisper": ("WhisperForConditionalGeneration", "WhisperConfig", "whisper", {}),
    "resnet": ("ResNet", "ResNetConfig", "resnet", {}),
}
# The gang's runs: name -> (family, ParallelismConfig kwargs, config knobs over the family's)
RUNS = {
    **{f: (f, {}, {}) for f in FAMILIES},
    "bert_interleaved": ("bert", {"pp_virtual_stages": 2}, {"num_hidden_layers": 4}),
    "t5_whole": ("t5", {}, {"num_layers": 2}),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs several test processes at once."""
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
    _, cfg_cls, _, knobs = FAMILIES[family]
    return getattr(M, cfg_cls).tiny(dtype=torch.float32, **{**knobs, **kw})


def _module(family, **kw):
    return getattr(M, FAMILIES[family][0])(_config(family, **kw))


def _weights(family, **kw) -> dict:
    """numpy-seeded fp32 parameters and buffers of the family's tiny module."""
    rng = np.random.default_rng(0)
    cfg = _config(family, **kw)
    out = {}
    for name, p in _module(family, **kw).state_dict().items():
        if name == "encoder.embed_positions":  # Whisper's fixed sinusoids
            out[name] = p.clone()
            continue
        if p.dim() == 0:  # CLIP's logit_scale
            a = np.full((), 2.6592)
        elif name.endswith(("running_mean", "mean")) and "bn" in name:
            a = rng.standard_normal(p.shape) * 0.1
        elif name.endswith(("running_var", "var")) and "bn" in name:
            a = rng.uniform(0.5, 1.5, p.shape)
        elif p.dim() == 1:
            a = rng.standard_normal(p.shape) * 0.1 + (0.0 if name.endswith("bias") else 1.0)
        else:
            a = rng.standard_normal(p.shape) / np.sqrt(np.prod(p.shape[1:]))
            if name.endswith(".q.weight"):  # T5 scales no query
                a = a / np.sqrt(cfg.d_kv)
        out[name] = torch.from_numpy(np.asarray(a, np.float32))
    return out


def _batch(family, step: int) -> dict:
    """4 rows of the family's training inputs, as numpy."""
    rng = np.random.default_rng(10 + step)
    ids = rng.integers(1, 250, (4, 12)).astype(np.int64)
    pixels = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    if family == "bert":
        mask = np.ones_like(ids)
        mask[1:, 8:] = 0
        return {"ids": ids, "mask": mask,
                "labels": np.where(rng.random(ids.shape) < 0.3, ids, -100)}
    if family == "vit":
        return {"pixels": pixels, "labels": rng.integers(0, 4, 4).astype(np.int64)}
    if family == "clip":
        ids[:, -1] = 511
        return {"ids": ids, "pixels": pixels}
    if family == "t5":
        return {"ids": ids[:, :10], "dec": rng.integers(2, 250, (4, 6)).astype(np.int64),
                "labels": rng.integers(2, 250, (4, 6)).astype(np.int64)}
    if family == "whisper":
        return {"feats": rng.standard_normal((4, 20, 16)).astype(np.float32),
                "dec": rng.integers(2, 250, (4, 6)).astype(np.int64),
                "labels": rng.integers(2, 250, (4, 6)).astype(np.int64)}
    return {"x": pixels, "y": rng.integers(0, 4, 4).astype(np.int64)}


def _port_loss(family):
    """The family's training loss ``loss_fn(model, batch)`` (ResNet's with
    ``mutable_state``)."""
    from accelerate_tpu_torch.models import (clip_contrastive_loss, cross_entropy_loss,
                                             masked_lm_loss, resnet_loss,
                                             t5_cross_entropy_loss)

    def ce(logits, labels):
        return -torch.log_softmax(logits.float(), -1).gather(1, labels[:, None]).mean()

    return {
        "bert": lambda m, b: masked_lm_loss(m(b["ids"], b["mask"]), b["labels"]),
        "vit": lambda m, b: ce(m(b["pixels"]), b["labels"]),
        "clip": lambda m, b: clip_contrastive_loss(m, b["ids"], b["pixels"]),
        "t5": lambda m, b: t5_cross_entropy_loss(m(b["ids"], b["dec"]), b["labels"]),
        "whisper": lambda m, b: cross_entropy_loss(m(b["feats"], b["dec"]), b["labels"]),
        "resnet": lambda m, extra, b: resnet_loss(m, extra, b["x"], b["y"]),
    }[family]


def _port_steps(family, pc=None, **kw) -> list:
    """STEPS port steps; (loss, grad norm) of each."""
    acc = Accelerator(cpu=True, parallelism_config=pc)
    module = _module(family, **kw)
    module.load_state_dict(_weights(family, **kw))
    # ResNet with SGD, as tests/test_torch_resnet.py holds it to the JAX step:
    # AdamW's first update is about sign(g), which turns its near-zero
    # gradients' last bits into whole steps.
    opt = (torch.optim.SGD(module.parameters(), lr=SGD_LR) if family == "resnet"
           else adamw(LR))
    acc.prepare(Model(module), opt)
    step = acc.prepare_train_step(_port_loss(family), max_grad_norm=1.0,
                                  mutable_state=family == "resnet")
    state, out = acc.train_state, []
    for i in range(STEPS):
        batch = {k: torch.from_numpy(v) for k, v in _batch(family, i).items()}
        state, m = step(state, batch)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out


# ---------------------------------------------------------------------------
# The gang
# ---------------------------------------------------------------------------


def _worker(rank, world, init_file, out_path):
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    torch.set_num_threads(1)
    results = {}
    try:
        for name, (family, pc_kw, kw) in RUNS.items():
            _reset_port()
            results[name] = _port_steps(family, ParallelismConfig(pp_size=2, **pc_kw), **kw)
        dist.barrier()
    finally:
        with open(f"{out_path}.{rank}", "wb") as f:
            pickle.dump(results, f)
        dist.destroy_process_group()


# The JAX references run in two spawned processes of their own, beside the
# gang and the port's one-process steps.
JAX_SHARES = (("bert", "clip", "resnet"), ("t5", "vit", "whisper"))


def _jax_references(families, out_path):
    with open(out_path, "wb") as f:
        pickle.dump({family: _jax_steps(family) for family in families}, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """By rank, the gang's pp=2 steps; the port's one-process steps of each
    run; the JAX steps of each family."""
    tmp = tmp_path_factory.mktemp("pp_encoders")
    out = str(tmp / "out")
    ctx = mp.get_context("spawn")
    refs = [ctx.Process(target=_jax_references, args=(share, str(tmp / f"jax{i}.pkl")))
            for i, share in enumerate(JAX_SHARES)]
    for proc in refs:
        proc.start()
    gang = mp.start_processes(_worker, args=(2, str(tmp / "init"), out), nprocs=2, join=False,
                              start_method="spawn")
    one = {}
    for name, (family, _, kw) in RUNS.items():
        _reset_port()
        one[name] = _port_steps(family, **kw)
    while not gang.join():
        pass
    jax_steps = {}
    for i, proc in enumerate(refs):
        proc.join()
        assert proc.exitcode == 0
        with open(tmp / f"jax{i}.pkl", "rb") as f:
            jax_steps.update(pickle.load(f))
    results = []
    for rank in range(2):
        with open(f"{out}.{rank}", "rb") as f:
            results.append(pickle.load(f))
    return results, one, jax_steps


# ---------------------------------------------------------------------------
# The JAX references
# ---------------------------------------------------------------------------


def _jax_steps(family, **kw) -> list:
    import jax
    import jax.numpy as jnp
    import optax

    from accelerate_tpu import Accelerator as JaxAccelerator
    from accelerate_tpu import Model as JaxModel
    from accelerate_tpu.state import AcceleratorState as JS
    from accelerate_tpu.state import GradientState as JG

    JS._reset_state()
    JG._reset_state()
    cls, cfg_cls, mod, knobs = FAMILIES[family]
    jm = importlib.import_module(f"accelerate_tpu.models.{mod}")
    jmodule = getattr(jm, cls)(getattr(jm, cfg_cls).tiny(dtype=jnp.float32, **{**knobs, **kw}))
    cfg = _config(family, **kw)
    port = _module(family, **kw)
    sd = _weights(family, **kw)
    port.load_state_dict(sd)
    if family == "resnet":
        params = jax.tree.map(lambda t: jnp.asarray(t.detach().numpy()), M.resnet_params_to_flax(
            cfg, dict(port.named_parameters())))
        stats = jax.tree.map(lambda t: jnp.asarray(t.detach().numpy()),
                             Model(port).extra_state)
        model = JaxModel(module=jmodule, params=params, extra_state=stats)
    else:
        tree = convert.flax_converter(port).to_flax(cfg, dict(port.named_parameters()))
        model = JaxModel(module=jmodule,
                         params=jax.tree.map(lambda t: jnp.asarray(t.detach().numpy()), tree))
    acc = JaxAccelerator()
    acc.prepare(model, optax.sgd(SGD_LR) if family == "resnet" else optax.adamw(LR))

    def ce(logits, labels):
        return -jnp.mean(jnp.take_along_axis(jax.nn.log_softmax(logits), labels[:, None], 1))

    def apply(p, *args):
        return jmodule.apply({"params": p}, *args)

    losses = {
        "bert": lambda p, b: jm.masked_lm_loss(apply(p, b["ids"], b["mask"]), b["labels"]),
        "vit": lambda p, b: ce(apply(p, b["pixels"]), b["labels"]),
        "clip": lambda p, b: jm.clip_contrastive_loss(jmodule, p, b["ids"], b["pixels"]),
        "t5": lambda p, b: jm.t5_cross_entropy_loss(apply(p, b["ids"], b["dec"]), b["labels"]),
        "whisper": lambda p, b: _jax_ce(apply(p, b["feats"], b["dec"]), b["labels"]),
    }
    if family == "resnet":
        step = acc.prepare_train_step(
            lambda p, extra, b: jm.resnet_loss(jmodule, p, extra, b["x"], b["y"]),
            mutable_state=True, max_grad_norm=1.0)
    else:
        step = acc.prepare_train_step(losses[family], max_grad_norm=1.0)
    state, out = acc.train_state, []
    for i in range(STEPS):
        state, m = step(state, {k: jnp.asarray(v) for k, v in _batch(family, i).items()})
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out


def _jax_ce(logits, labels):
    from accelerate_tpu.models import cross_entropy_loss

    return cross_entropy_loss(logits, labels)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_pp2_steps_match_one_process_and_jax(runs, name):
    """Each family's pp=2 steps against the port's one-process steps and
    the JAX step; the interleaved BERT and the whole-stack T5 against the
    port's one-process steps of their configs (the JAX step of each family
    is held at its default config)."""
    ranks, one, jax_steps = runs
    got0, got1 = ranks[0][name], ranks[1][name]
    assert got0 == got1  # the last stage's loss and the global norm on every rank
    np.testing.assert_allclose(np.array(got0), np.array(one[name]), rtol=RTOL)
    if name in FAMILIES:
        np.testing.assert_allclose(np.array(got0), np.array(jax_steps[name]), rtol=RTOL)


def test_stage_specs_cut_the_divisible_stacks():
    """``keep_stage`` at pp=2: each stack that divides keeps its stage's half
    (the others' blocks become ``nn.Identity``); T5's one ``rest`` block and
    ResNet stay whole; the shared names are every parameter outside a cut
    stack."""
    from accelerate_tpu_torch.parallel.pp import keep_stage

    bert = _module("bert")
    shared = keep_stage(bert, 2, 1)
    assert isinstance(bert.bert.layers[0], torch.nn.Identity)
    assert not isinstance(bert.bert.layers[1], torch.nn.Identity)
    assert bert.bert.layers._pp_plan == (2, 1, [[1]])
    assert not any(n.startswith("bert.layers.") for n in shared)
    assert "bert.word_embeddings.weight" in shared
    t5 = _module("t5", num_layers=2)
    keep_stage(t5, 2, 0)
    assert getattr(t5.encoder, "_pp_plan", None) is None and not t5._pp_pipelined
    resnet = _module("resnet")
    assert keep_stage(resnet, 2, 1) == [n for n, _ in resnet.named_parameters()]
