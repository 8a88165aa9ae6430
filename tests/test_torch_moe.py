"""The port's Mixtral family (``accelerate_tpu_torch/models/moe.py``, its
generation plan, hub row and converters) against the JAX package's.

Weights are drawn with numpy from a seed in the port's layout (matrices,
expert stacks and the router of std 1/sqrt(fan-in), norm weights around
one) and carried to the flax tree with ``llama_params_to_flax`` (which maps a
Mixtral config's ``moe`` subtree too). Both
packages run on the CPU, the JAX attention native.

Tolerances: dispatch tensors and drops equal, ties included; combine
weights and the aux loss within rtol 1e-6; logits within 1e-5 relative
(L2) in fp32 and 2e-2 in bf16; gradients within 1e-4 relative per
tensor; 3-step trajectories (loss and grad norm) within rtol 1e-4, as
tests/test_torch_train.py holds plain Llama; greedy tokens equal, with
every step's top-2 logit gap above 1e-4 so that equal tokens are not luck
at a near-tie; a transformers checkpoint's logits within 1e-5 of the JAX
hub's and 3e-4 of transformers' own.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu import Model as JaxModel
from accelerate_tpu import ServingConfig as JaxServingConfig
from accelerate_tpu import ServingEngine as JaxServingEngine
from accelerate_tpu import generate as jax_generate
from accelerate_tpu import generation as jax_gen
from accelerate_tpu.models import moe as jax_moe
from accelerate_tpu.models import model_from_pretrained as jax_model_from_pretrained
from accelerate_tpu_torch import (
    Accelerator,
    MixtralConfig,
    MixtralForCausalLM,
    Model,
    ParallelismConfig,
    ServingConfig,
    ServingEngine,
    adamw,
    compute_dispatch,
    cp_generate,
    generate,
    load_balance_loss,
    moe_cross_entropy_loss,
)
from accelerate_tpu_torch import generation as gen
from accelerate_tpu_torch.models import (
    load_pretrained,
    llama_params_from_flax,
    llama_params_to_flax,
    mixtral_params_from_hf,
    mixtral_params_to_hf,
    mixtral_tp_rules,
    model_from_pretrained,
)
from accelerate_tpu_torch.models import moe as port_moe
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

MIN_GAP = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def reset_port_state():
    yield
    AcceleratorState._reset_state()
    GradientState._reset_state()
    PartialState._reset_state()


def _ids(b, s, seed, vocab=256):
    return np.random.default_rng(seed).integers(1, vocab, (b, s), dtype=np.int32)


def _weights(cfg, seed=0) -> dict:
    rng = np.random.default_rng(seed)
    out = {}
    for name, p in MixtralForCausalLM(cfg, device="meta").state_dict().items():
        if p.dim() == 1:
            a = rng.standard_normal(p.shape) * 0.1 + 1.0
        else:  # (out, in) Linears and the embedding: dim 1; stacks and router: dim -2
            fan_in = p.shape[1] if p.dim() == 2 and not name.endswith("router") else p.shape[-2]
            a = rng.standard_normal(p.shape) / np.sqrt(fan_in)
        out[name] = torch.from_numpy(a.astype(np.float32))
    return out


def _build(seed=0, dtype="float32", **kw):
    """(JAX module, flax params, port config, port module) on one set of
    weights."""
    jcfg = jax_moe.MixtralConfig.tiny(dtype=getattr(jnp, dtype), attention_impl="native", **kw)
    cfg = MixtralConfig.tiny(dtype=getattr(torch, dtype), **kw)
    sd = _weights(cfg, seed)
    module = MixtralForCausalLM(cfg)
    module.load_state_dict(sd)
    params = jax.tree.map(lambda t: t.numpy(), llama_params_to_flax(cfg, sd))
    return jax_moe.MixtralForCausalLM(jcfg), params, cfg, module


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------

DISPATCH = [(16, 4, 2, 0.5), (40, 8, 2, 1.0), (33, 4, 1, 2.0), (64, 8, 2, 0.5)]


@pytest.mark.parametrize("t,e,k,cf", DISPATCH, ids=[f"T{c[0]}E{c[1]}k{c[2]}cf{c[3]}"
                                                     for c in DISPATCH])
def test_dispatch_and_combine_match_jax(t, e, k, cf):
    """Dense dispatch and combine of random router probabilities, with
    capacity in the JAX layer's float order: the same slots (the drops
    past capacity included), the same weights; and the aux loss."""
    logits = np.random.default_rng(t).standard_normal((t, e)).astype(np.float32)
    probs = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    capacity = max(1, min(int(np.ceil(k * t / e * cf)), t))
    cfg = MixtralConfig.tiny(num_local_experts=e, num_experts_per_tok=k, capacity_factor=cf)
    assert port_moe.expert_capacity(cfg, t) == capacity
    jd, jc = jax_moe.compute_dispatch(probs, k, capacity)
    tprobs = torch.from_numpy(np.array(probs))
    d, c = compute_dispatch(tprobs, k, capacity)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-6, atol=1e-7)
    if cf < 1:
        assert d.sum() < t * k  # tokens dropped
    np.testing.assert_allclose(float(load_balance_loss(tprobs, d)),
                               float(jax_moe.load_balance_loss(probs, jd)), rtol=1e-6)


def test_equal_probabilities_route_to_the_lowest_experts():
    """A zero router gives every token equal probabilities: both packages
    pick experts 0 and 1, in index order, and fill their slots in token
    order (capacity 3 of 6 tokens: the last three drop)."""
    probs = np.full((6, 4), 0.25, np.float32)
    jd, _ = jax_moe.compute_dispatch(jnp.asarray(probs), 2, 3)
    d, _ = compute_dispatch(torch.from_numpy(probs), 2, 3)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(d.sum((0, 2)).numpy(), [3, 3, 0, 0])
    np.testing.assert_array_equal(d[:3].sum((1, 2)).numpy(), [2, 2, 2])
    layer = port_moe.MoeLayer(MixtralConfig.tiny(dtype=torch.float32))
    with torch.no_grad():
        for p in layer.parameters():
            p.normal_()
        layer.router.zero_()
        layer(torch.randn(2, 5, 128))
    assert (layer.stats["experts"] == torch.tensor([0, 1])).all()


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


LOGITS = [("float32", 1e-5, 0.5), ("bfloat16", 2e-2, 0.5)]


@pytest.mark.parametrize("dtype,tol,cf", LOGITS, ids=[f"{c[0]}-cf{c[2]}" for c in LOGITS])
def test_logits_and_aux_loss_match_jax(dtype, tol, cf):
    """Logits and the sown aux losses at a capacity factor that drops
    tokens and at one that drops none."""
    jmodule, params, cfg, module = _build(dtype=dtype, capacity_factor=cf)
    ids = _ids(2, 16, seed=1)
    want, col = jmodule.apply({"params": params}, jnp.asarray(ids), mutable=["losses"])
    want_aux = float(sum(jnp.sum(v) for v in jax.tree.leaves(col["losses"])))
    with torch.no_grad():
        got, aux = module(torch.from_numpy(ids).long(), return_aux=True)
    assert _rel(got.float(), np.asarray(want, np.float32)) < tol
    np.testing.assert_allclose(float(aux), want_aux, rtol=1e-5 if dtype == "float32" else 1e-3)
    assert (int(module.router_stats()["dropped"]) > 0) == (cf < 1)


def test_loss_gradient_matches_jax_grad():
    """``moe_cross_entropy_loss``'s value and gradient (the router's through
    the combine weights and the aux loss) against ``jax.grad`` of the JAX
    one, tokens dropping at capacity factor 0.5."""
    jmodule, params, cfg, module = _build(capacity_factor=0.5)
    ids = _ids(2, 17, seed=2)
    x, y = ids[:, :-1], ids[:, 1:]
    want, grads = jax.value_and_grad(
        lambda p: jax_moe.moe_cross_entropy_loss(jmodule, p, x, y))(params)
    loss = moe_cross_entropy_loss(module, torch.from_numpy(x).long(), torch.from_numpy(y).long())
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-6)
    got = llama_params_to_flax(cfg, {n: p.grad for n, p in module.named_parameters()})
    flat_want = dict(jax.tree_util.tree_flatten_with_path(grads)[0])
    for path, g in jax.tree_util.tree_flatten_with_path(got)[0]:
        assert _rel(g.numpy(), flat_want[path]) < 1e-4, jax.tree_util.keystr(path)


def test_remat_policies_keep_the_gradients():
    """Remat ``dots``, ``flash`` and ``minimal`` recompute the routing in
    the backward: loss and gradients equal to the plain forward's."""
    _, _, cfg, module = _build(capacity_factor=0.5)
    ids = torch.from_numpy(_ids(2, 17, seed=3)).long()

    def grads(m):
        moe_cross_entropy_loss(m, ids[:, :-1], ids[:, 1:]).backward()
        return {n: p.grad for n, p in m.named_parameters()}

    want = grads(module)
    for policy in ("dots", "flash", "minimal"):
        cfg_r = MixtralConfig.tiny(dtype=torch.float32, capacity_factor=0.5, remat=True,
                                   remat_policy=policy)
        m = MixtralForCausalLM(cfg_r)
        m.load_state_dict(module.state_dict())
        for n, g in grads(m).items():
            torch.testing.assert_close(g, want[n], rtol=1e-6, atol=1e-7, msg=policy + n)


def test_three_steps_match_jax_accelerator():
    """``prepare_train_step`` with ``moe_cross_entropy_loss`` against the
    JAX Accelerator's step, tokens dropping at capacity factor 0.5."""
    rng = np.random.default_rng(4)
    batches = [rng.integers(0, 256, (8, 17), dtype=np.int32) for _ in range(3)]
    jmodule, params, cfg, module = _build(seed=1, capacity_factor=0.5)
    jacc = JaxAccelerator()
    jacc.prepare(JaxModel(module=jmodule, params=params), optax.adamw(1e-3))
    jstep = jacc.prepare_train_step(
        lambda p, b: jax_moe.moe_cross_entropy_loss(jmodule, p, b["x"], b["y"]),
        max_grad_norm=1.0)
    jstate, want = jacc.train_state, []
    for ids in batches:
        jstate, m = jstep(jstate, {"x": jnp.asarray(ids[:, :-1]), "y": jnp.asarray(ids[:, 1:])})
        want.append((float(m["loss"]), float(m["grad_norm"])))

    acc = Accelerator(cpu=True)
    acc.prepare(Model(module), adamw(1e-3))
    step = acc.prepare_train_step(lambda m, b: moe_cross_entropy_loss(m, b["x"], b["y"]),
                                  max_grad_norm=1.0)
    state, got = acc.train_state, []
    for ids in batches:
        state, m = step(state, {"x": ids[:, :-1].astype(np.int64),
                                "y": ids[:, 1:].astype(np.int64)})
        got.append((float(m["loss"]), float(m["grad_norm"])))
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=1e-4)


def test_imperative_loop_matches_the_fused_step():
    """``moe_cross_entropy_loss`` in the imperative loop (``backward``,
    ``clip_grad_norm_``, ``optimizer.step()``) gives the fused step's
    losses and grad norms."""
    _, _, cfg, module = _build(seed=3, capacity_factor=0.5)
    batches = [_ids(4, 17, seed=20 + i).astype(np.int64) for i in range(2)]
    runs = []
    for imperative in (False, True):
        m = MixtralForCausalLM(cfg)
        m.load_state_dict(module.state_dict())
        acc = Accelerator(cpu=True)
        model, opt = acc.prepare(Model(m), adamw(1e-3))
        out = []
        for ids in batches:
            b = {"x": ids[:, :-1], "y": ids[:, 1:]}
            if imperative:
                loss = acc.backward(lambda mm, bb: moe_cross_entropy_loss(mm, bb["x"], bb["y"]),
                                    b)
                norm = acc.clip_grad_norm_(None, 1.0)
                opt.step()
                opt.zero_grad()
            else:
                step = acc.prepare_train_step(
                    lambda mm, bb: moe_cross_entropy_loss(mm, bb["x"], bb["y"]),
                    max_grad_norm=1.0)
                _, metrics = step(acc.train_state, b)
                loss, norm = metrics["loss"], metrics["grad_norm"]
            out.append((float(loss), float(norm)))
        runs.append(out)
        AcceleratorState._reset_state()
        GradientState._reset_state()
    np.testing.assert_allclose(np.array(runs[1]), np.array(runs[0]), rtol=1e-6)


@pytest.mark.parametrize("scan_layers", [True, False])
def test_converters_round_trip(scan_layers):
    """flax tree ↔ state dict (either flax layer layout) and Hugging Face
    ↔ state dict, bit for bit."""
    cfg = MixtralConfig.tiny(dtype=torch.float32, scan_layers=scan_layers)
    sd = _weights(cfg)
    tree = llama_params_to_flax(cfg, sd)
    assert ("layers" in tree["model"]) == scan_layers
    for back in (llama_params_from_flax(cfg, tree),
                 mixtral_params_from_hf(cfg, mixtral_params_to_hf(cfg, sd))):
        assert back.keys() == sd.keys()
        for k in sd:
            assert torch.equal(back[k], sd[k]), k


# ---------------------------------------------------------------------------
# Generation and serving
# ---------------------------------------------------------------------------


def _min_greedy_gap(cfg, model, rows, prompt_len):
    rows = torch.as_tensor(np.asarray(rows)).long()
    b, t = rows.shape
    logits, _ = gen._llama_forward_cached(cfg, model, rows, gen.init_cache(cfg, b, t),
                                          return_all=True)
    top2 = torch.topk(logits[:, prompt_len - 1:t - 1], 2, dim=-1).values
    return float((top2[..., 0] - top2[..., 1]).min())


def test_generate_and_engine_match_jax():
    """Greedy ``generate`` (a plain and a left-padded batch), ``beam_search``
    and the engine (bf16 and int8 KV pages) against the JAX package's
    tokens; ``speculative_generate`` against greedy."""
    jmodule, params, cfg, module = _build(seed=5)
    jmodel = JaxModel(module=jmodule, params=params)
    ids = _ids(2, 6, seed=6)
    want = np.asarray(jax_generate(jmodel, ids, max_new_tokens=8))
    got = generate(module, ids, max_new_tokens=8)
    assert _min_greedy_gap(cfg, module, got, 6) > MIN_GAP
    np.testing.assert_array_equal(got.numpy(), want)
    mask = np.ones_like(ids)
    mask[1, :2] = 0
    np.testing.assert_array_equal(
        generate(module, ids * mask, max_new_tokens=6, attention_mask=mask).numpy(),
        np.asarray(jax_generate(jmodel, ids * mask, max_new_tokens=6, attention_mask=mask)))

    np.testing.assert_array_equal(
        gen.beam_search(module, ids, 5, num_beams=3).numpy(),
        np.asarray(jax_gen.beam_search(jmodel, ids, 5, num_beams=3)))
    # The target as its own draft accepts every proposal: greedy's tokens.
    np.testing.assert_array_equal(
        gen.speculative_generate(module, module, ids[:1], 8, num_draft_tokens=3).numpy(),
        got[:1].numpy())

    prompts = [_ids(1, n, seed=7 + n)[0] for n in (3, 7, 5)]
    budgets = [5, 3, 6]
    for cache_dtype in (None, torch.int8):
        kw = dict(n_slots=2, max_len=32, prefill_chunks=[4, 8])
        rows = ServingEngine(module, ServingConfig(**kw, cache_dtype=cache_dtype)).run(
            prompts, max_new_tokens=budgets)
        jrows = JaxServingEngine(jmodel, JaxServingConfig(
            **kw, cache_dtype=None if cache_dtype is None else jnp.int8)).run(
                prompts, max_new_tokens=budgets)
        for r, j in zip(rows, jrows):
            np.testing.assert_array_equal(np.asarray(r), np.asarray(j))


def test_overflowing_prefill_drops_in_training_but_not_in_decode():
    """At capacity factor 0.5 a 24-token prompt overflows the experts: the
    training forward drops tokens and the dropless decode plan does not,
    so their last logits differ, in the JAX package as in the port; each
    path matches its JAX counterpart. At a factor that drops nothing the
    port's two paths agree."""
    ids = _ids(1, 24, seed=8)
    for cf in (0.5, 8.0):
        jmodule, params, cfg, module = _build(seed=2, capacity_factor=cf)
        with torch.no_grad():
            train = module(torch.from_numpy(ids).long())[:, -1].numpy()
        decode, _ = gen._llama_forward_cached(cfg, module, torch.from_numpy(ids).long(),
                                              gen.init_cache(cfg, 1, 24))
        if cf > 1:
            np.testing.assert_allclose(train, decode.numpy(), rtol=1e-5, atol=1e-5)
            continue
        assert int(module.router_stats()["dropped"]) > 0
        jtrain = np.asarray(jmodule.apply({"params": params}, jnp.asarray(ids)))[:, -1]
        jcache = jax_gen.init_cache(jmodule.config, 1, 24)
        jdecode = np.asarray(jax_gen._mixtral_forward_cached(
            jmodule.config, params, jnp.asarray(ids), jcache)[0])
        np.testing.assert_allclose(train, jtrain, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(decode.numpy(), jdecode, rtol=1e-5, atol=1e-5)
        assert _rel(train, decode.numpy()) > 1e-3 and _rel(jtrain, jdecode) > 1e-3


# ---------------------------------------------------------------------------
# Hub, and what is refused
# ---------------------------------------------------------------------------


def test_transformers_checkpoint_loads_like_the_jax_hub(tmp_path, monkeypatch):
    """A tiny transformers Mixtral saved as a checkpoint directory: the
    port's ``load_pretrained`` and ``model_from_pretrained`` against the
    JAX hub's logits, and transformers' own (capacity factor 2 drops
    nothing at 4 experts, top 2). transformers is imported without its
    TensorFlow half, which halves the import."""
    monkeypatch.setenv("USE_TF", "0")
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    hf = transformers.MixtralForCausalLM(transformers.MixtralConfig(
        vocab_size=128, hidden_size=64, intermediate_size=96, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
        num_local_experts=4, num_experts_per_tok=2, tie_word_embeddings=False)).eval()
    hf.save_pretrained(tmp_path)
    ids = _ids(2, 10, seed=9, vocab=128)
    cfg, sd, cls = load_pretrained(tmp_path, dtype=torch.float32)
    assert cls is MixtralForCausalLM and cfg.num_local_experts == 4
    model = model_from_pretrained(tmp_path, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long()).numpy()
        ref = hf(torch.from_numpy(ids).long()).logits.numpy()
    jmodel = jax_model_from_pretrained(str(tmp_path), dtype=jnp.float32)
    want = np.asarray(jmodel(jnp.asarray(ids)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, ref, rtol=3e-4, atol=3e-4)
    with open(tmp_path / "config.json") as f:
        assert json.load(f)["model_type"] == "mixtral"


# A tiny config of each family that has a row of its own since GPT-2, OPT,
# GPT-NeoX, T5 and Whisper were ported.
_ROW_CONFIGS = {
    "gpt2": dict(vocab_size=64, n_positions=16, n_embd=16, n_layer=1, n_head=2),
    "opt": dict(vocab_size=64, hidden_size=16, ffn_dim=32, num_hidden_layers=1,
                num_attention_heads=2, max_position_embeddings=16),
    "gpt_neox": dict(vocab_size=64, hidden_size=16, num_hidden_layers=1, num_attention_heads=2,
                     intermediate_size=32),
    "t5": dict(vocab_size=64, d_model=16, d_kv=8, d_ff=32, num_layers=1, num_heads=2),
    "whisper": dict(vocab_size=64, num_mel_bins=8, d_model=16, encoder_layers=1,
                    decoder_layers=1, encoder_attention_heads=2, decoder_attention_heads=2,
                    encoder_ffn_dim=32, decoder_ffn_dim=32),
    "bert": dict(vocab_size=64, hidden_size=16, num_hidden_layers=1, num_attention_heads=2,
                 intermediate_size=32),
    "vit": dict(image_size=16, patch_size=8, hidden_size=16, num_hidden_layers=1,
                num_attention_heads=2, intermediate_size=32),
    "clip": dict(text_config=dict(vocab_size=64, hidden_size=16, num_hidden_layers=1,
                                  num_attention_heads=2, intermediate_size=32),
                 vision_config=dict(image_size=16, patch_size=8, hidden_size=16,
                                    num_hidden_layers=1, num_attention_heads=2,
                                    intermediate_size=32)),
}


@pytest.mark.parametrize("family", ["gpt2", "opt", "gpt_neox", "t5", "whisper", "bert", "vit",
                                    "clip"])
def test_other_families_still_raise(family):
    """Every family, BERT, ViT and CLIP too since they are ported, reaches
    its own row, which asks for the checkpoint's tensors."""
    with pytest.raises(KeyError, match="checkpoint lacks"):
        load_pretrained(({"model_type": family, **_ROW_CONFIGS[family]}, {}))


def test_parallel_moe_is_refused(monkeypatch):
    """Expert parallelism, its TP rule table and Mixtral over a cp or sp
    axis are ported (tests/test_torch_expert_parallel.py): ep outside
    whole axes raises as the JAX constructor does, the ep table is the JAX
    one, and over a sequence axis each slice takes its global positions.
    cp_generate of a Mixtral stays refused, as the JAX cp_generate fails
    on it (it reads each layer's ``mlp``)."""
    from accelerate_tpu.cp_generation import cp_generate as jax_cp_generate
    from accelerate_tpu.state import AcceleratorState as JaxState
    from accelerate_tpu import ParallelismConfig as JaxPC

    with pytest.raises(ValueError, match="ep_size must divide"):
        ParallelismConfig(ep_size=2)
    assert mixtral_tp_rules(ep_axes=("dp_shard",)) == [
        (p, tuple(s)) for p, s in jax_moe.mixtral_tp_rules(ep_axes=("dp_shard",))]
    jmodule, params, _, module = _build()
    ids = torch.from_numpy(_ids(1, 8, seed=10)).long()
    with pytest.raises(NotImplementedError, match="JAX cp_generate has no MoE path"):
        cp_generate(module, ids, 2)
    mesh = JaxState(parallelism_config=JaxPC(cp_size=2, dp_shard_size=4)).mesh
    try:
        with pytest.raises(KeyError, match="mlp"):
            jax_cp_generate(JaxModel(module=jmodule, params=params), ids.numpy(), 2, mesh=mesh)
    finally:
        JaxState._reset_state()
    with torch.no_grad():
        whole = module(ids)
        monkeypatch.setattr(port_moe, "current_sequence_shard", lambda: (2, 0))
        assert torch.equal(module(ids), whole)
        monkeypatch.setattr(port_moe, "current_sequence_shard", lambda: (2, 1))
        assert not torch.equal(module(ids), whole)  # positions 8-15
