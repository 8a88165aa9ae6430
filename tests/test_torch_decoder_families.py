"""The port's GPT-2, OPT and GPT-NeoX (``accelerate_tpu_torch/models/gpt2.py``,
``opt.py``, ``neox.py``, their generation plans and flax converters)
against the JAX package's, on the CPU. NeoX runs with
``use_parallel_residual`` both ways.

Weights are drawn with numpy from a seed in the port's layout (matrices
of std 1/sqrt(fan-in), norm scales around one, biases around zero) and
carried to the flax tree with the family's ``*_params_to_flax``.

Tolerances: logits within 1e-4 relative (L2) in fp32 and 1e-2 in bf16,
for the stacked and the unrolled flax layouts; converters bit for bit
both ways; 3 steps of ``prepare_train_step`` (losses and grad norms)
within rtol 1e-4 of the JAX Accelerator's, as tests/test_torch_train.py
holds Llama; greedy tokens equal to the JAX ``generate``'s, with every
step's top-2 logit gap above 1e-4 so that equal tokens are not luck at a
near-tie; the engine's rows equal to ``generate``'s; GPT-2 with fp8 (QDQ)
within 3e-2 relative of the JAX module's logits: a one-ulp fp32
difference in a tensor's amax moves its scale and with it codes all over
the tensor (tests/test_torch_fp8.py allows the fp8 Llama 5e-3 on losses for
the same reason). Observed 1.6e-2 here, where the fp8 and the
full-precision logits lie 8.1e-2 apart.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu import Model as JaxModel
from accelerate_tpu import generate as jax_generate
from accelerate_tpu.models import cross_entropy_loss as jax_cross_entropy
from accelerate_tpu.models import gpt2 as jgpt2
from accelerate_tpu.models import neox as jneox
from accelerate_tpu.models import opt as jopt
from accelerate_tpu_torch import Accelerator, Model, ServingConfig, ServingEngine, adamw, generate
from accelerate_tpu_torch import generation as gen
from accelerate_tpu_torch.models import convert, cross_entropy_loss, gpt2, neox, opt
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

MIN_GAP = 1e-4

# name -> (JAX module, JAX config, port module, port config, converter prefix, config knobs)
FAMILIES = {
    "gpt2": (jgpt2.GPT2LMHeadModel, jgpt2.GPT2Config, gpt2.GPT2LMHeadModel, gpt2.GPT2Config,
             "gpt2", {}),
    "opt": (jopt.OPTForCausalLM, jopt.OPTConfig, opt.OPTForCausalLM, opt.OPTConfig, "opt", {}),
    "neox": (jneox.GPTNeoXForCausalLM, jneox.GPTNeoXConfig, neox.GPTNeoXForCausalLM,
             neox.GPTNeoXConfig, "neox", {}),
    "neox_sequential": (jneox.GPTNeoXForCausalLM, jneox.GPTNeoXConfig, neox.GPTNeoXForCausalLM,
                        neox.GPTNeoXConfig, "neox", {"use_parallel_residual": False}),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def reset_port_state():
    yield
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()


def _ids(b, s, seed, vocab=256):
    return np.random.default_rng(seed).integers(1, vocab, (b, s), dtype=np.int32)


def _weights(module, seed=0) -> dict:
    rng = np.random.default_rng(seed)
    out = {}
    for name, p in module.state_dict().items():
        if p.dim() == 1:
            a = rng.standard_normal(p.shape) * 0.1 + (0.0 if name.endswith("bias") else 1.0)
        else:
            a = rng.standard_normal(p.shape) / np.sqrt(p.shape[1])
        out[name] = torch.from_numpy(a.astype(np.float32))
    return out


def _build(family, dtype="float32", seed=0, port_kw=None, **kw):
    """(JAX module, flax params, port config, port module) on one set of
    weights; ``port_kw`` goes to the port's config only."""
    jm, jc, pm, pc, prefix, knobs = FAMILIES[family]
    knobs = {**knobs, **kw}
    cfg = pc.tiny(dtype=getattr(torch, dtype), **knobs, **(port_kw or {}))
    module = pm(cfg)
    sd = _weights(module, seed)
    module.load_state_dict(sd)
    tree = getattr(convert, f"{prefix}_params_to_flax")(cfg, sd)
    params = jax.tree.map(lambda t: t.numpy(), tree)
    return jm(jc.tiny(dtype=getattr(jnp, dtype), **knobs)), params, cfg, module


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


LOGITS = [("float32", True, 1e-4), ("float32", False, 1e-4), ("bfloat16", True, 1e-2)]


@pytest.mark.parametrize("dtype,scan_layers,tol", LOGITS,
                         ids=[f"{d}-{'stacked' if s else 'unrolled'}" for d, s, _ in LOGITS])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_logits_match_jax(family, dtype, scan_layers, tol):
    """The module's logits against the JAX module's on the converted tree
    (the unrolled layout in fp32, the stacked one in fp32 and bf16)."""
    jmodule, params, cfg, module = _build(family, dtype, scan_layers=scan_layers)
    ids = _ids(2, 12, seed=1)
    want = np.asarray(jmodule.apply({"params": params}, jnp.asarray(ids)), np.float32)
    with torch.no_grad():
        got = module(torch.from_numpy(ids).long())
    assert got.dtype == torch.float32
    assert _rel(got, want) < tol


@pytest.mark.parametrize("scan_layers", [True, False], ids=["stacked", "unrolled"])
@pytest.mark.parametrize("family", ["gpt2", "opt", "neox"])
def test_converters_round_trip(family, scan_layers):
    """state dict → flax tree → state dict, and flax tree → state dict →
    flax tree, bit for bit; the checkpoint registry holds the family, and
    its flax names are the unrolled tree's."""
    _, _, pm, pc, prefix, _ = FAMILIES[family]
    cfg = pc.tiny(dtype=torch.float32, scan_layers=scan_layers)
    module = pm(cfg)
    sd = _weights(module, seed=3)
    to_flax = getattr(convert, f"{prefix}_params_to_flax")
    from_flax = getattr(convert, f"{prefix}_params_from_flax")
    tree = to_flax(cfg, sd)
    back = from_flax(cfg, tree)
    assert back.keys() == sd.keys()
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    again = dict(jax.tree_util.tree_flatten_with_path(to_flax(cfg, back))[0])
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        assert torch.equal(again[path], leaf)
    conv = convert.flax_converter(module)
    assert conv.to_flax is to_flax
    unrolled = pc.tiny(dtype=torch.float32, scan_layers=False)
    names = {"/".join(k.key for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(to_flax(unrolled, sd))[0]}
    assert {conv.flax_name(cfg, k) for k in sd} == names


def _jax_steps(jmodule, params, batches):
    jacc = JaxAccelerator()
    jacc.prepare(JaxModel(module=jmodule, params=params), optax.adamw(1e-3))
    jstep = jacc.prepare_train_step(
        lambda p, b: jax_cross_entropy(jmodule.apply({"params": p}, b["x"]), b["y"]),
        max_grad_norm=1.0)
    state, out = jacc.train_state, []
    for ids in batches:
        state, m = jstep(state, {"x": jnp.asarray(ids[:, :-1]), "y": jnp.asarray(ids[:, 1:])})
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_three_steps_match_jax_accelerator(family):
    """``prepare_train_step`` with ``cross_entropy_loss`` (the port's
    blocks under remat, which changes no number) against the JAX
    Accelerator's step (adamw, clipping)."""
    rng = np.random.default_rng(4)
    batches = [rng.integers(0, 256, (4, 17), dtype=np.int32) for _ in range(3)]
    jmodule, params, cfg, module = _build(family, seed=1, port_kw={"remat": True})
    want = _jax_steps(jmodule, params, batches)
    acc = Accelerator(cpu=True)
    acc.prepare(Model(module), adamw(1e-3))
    step = acc.prepare_train_step(lambda m, b: cross_entropy_loss(m(b["x"]), b["y"]),
                                  max_grad_norm=1.0)
    state, got = acc.train_state, []
    for ids in batches:
        state, m = step(state, {"x": ids[:, :-1].astype(np.int64),
                                "y": ids[:, 1:].astype(np.int64)})
        got.append((float(m["loss"]), float(m["grad_norm"])))
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=1e-4)


def _min_greedy_gap(cfg, module, rows, prompt_len, mask=None):
    rows = torch.as_tensor(np.asarray(rows)).long()
    b, t = rows.shape
    kwargs = {}
    if mask is not None:
        valid = np.concatenate([mask.astype(bool), np.ones((b, t - prompt_len), bool)], 1)
        kwargs = {"pad_offset": torch.from_numpy(np.argmax(mask, 1)),
                  "kv_valid": torch.from_numpy(valid)}
    fwd = gen.GENERATION_PLANS[type(module).__name__]
    logits, _ = fwd(cfg, module, rows, gen.init_cache(cfg, b, t), return_all=True, **kwargs)
    top2 = torch.topk(logits[:, prompt_len - 1:t - 1], 2, dim=-1).values
    return float((top2[..., 0] - top2[..., 1]).min())


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_generate_and_engine_match_jax(family):
    """Greedy ``generate`` on a plain and a left-padded batch against the
    JAX package's tokens; the cached forward's logits against the module's;
    the engine's rows against ``generate``'s."""
    jmodule, params, cfg, module = _build(family, seed=5)
    jmodel = JaxModel(module=jmodule, params=params)
    ids = _ids(2, 6, seed=6)
    got = generate(module, ids, max_new_tokens=8)
    assert _min_greedy_gap(cfg, module, got, 6) > MIN_GAP
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_generate(jmodel, ids, 8)))
    mask = np.ones_like(ids)
    mask[1, :2] = 0
    got = generate(module, ids * mask, max_new_tokens=6, attention_mask=mask)
    assert _min_greedy_gap(cfg, module, got, 6, mask) > MIN_GAP
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_generate(jmodel, ids * mask, 6, attention_mask=mask)))

    rows = torch.from_numpy(ids).long()
    fwd = gen.GENERATION_PLANS[type(module).__name__]
    cached, _ = fwd(cfg, module, rows, gen.init_cache(cfg, 2, 6), return_all=True)
    with torch.no_grad():
        np.testing.assert_allclose(cached.numpy(), module(rows).numpy(), rtol=1e-5, atol=1e-5)

    prompts = [_ids(1, n, seed=7 + n)[0] for n in (3, 7, 5)]
    budgets = [5, 3, 6]
    engine = ServingEngine(module, ServingConfig(n_slots=2, max_len=32, prefill_chunks=[4, 8]))
    for prompt, budget, row in zip(prompts, budgets, engine.run(prompts,
                                                                max_new_tokens=budgets)):
        want = generate(module, prompt[None], max_new_tokens=budget)[0]
        np.testing.assert_array_equal(np.asarray(row), want.numpy())


def test_gpt2_fp8_matches_jax():
    """``GPT2Config(fp8=True, fp8_backend="QDQ")``: the four block
    projections through the fp8 linear's plain version in both packages
    (fp32 compute), logits within 3e-2 relative (module docstring); without
    fp8 they differ by more."""
    jmodule, params, cfg, module = _build("gpt2", fp8=True, fp8_backend="QDQ")
    ids = _ids(2, 12, seed=9)
    want = np.asarray(jmodule.apply({"params": params}, jnp.asarray(ids)), np.float32)
    with torch.no_grad():
        got = module(torch.from_numpy(ids).long())
    assert module.transformer.h[0].c_fc.linear is not torch.nn.functional.linear
    plain = gpt2.GPT2LMHeadModel(gpt2.GPT2Config.tiny(dtype=torch.float32))
    plain.load_state_dict(module.state_dict())
    with torch.no_grad():
        exact = plain(torch.from_numpy(ids).long())
    assert _rel(got, want) < 3e-2 < _rel(exact, want)


def test_tp_rules_refused():
    """The TP rule tables are ported (ROADMAP.md Queue A item 6's TP half):
    each equals the JAX package's, pattern for pattern and spec for spec
    (tests/test_torch_tensor_parallel.py runs them)."""
    for fn, jfn in ((gpt2.gpt2_tp_rules, jgpt2.gpt2_tp_rules), (opt.opt_tp_rules, jopt.opt_tp_rules),
                    (neox.neox_tp_rules, jneox.neox_tp_rules)):
        for scan in (True, False):
            assert fn(scan) == [(p, tuple(s)) for p, s in jfn(scan)]
