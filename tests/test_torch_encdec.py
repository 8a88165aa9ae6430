"""The port's T5 and Whisper encoder-decoders (``accelerate_tpu_torch/models/
t5.py``, ``whisper.py``, their flax converters) and encoder-decoder
generation (``generation.py``: ``EncDecState``, the encode/decode plans,
``generate(decoder_input_ids=)``, ``beam_search``) against the JAX
package's, on the CPU.

Weights are drawn with numpy from a seed in the port's layout (matrices
of std 1/sqrt(fan-in), T5's q projections a further 1/sqrt(d_kv) as T5's
initialiser scales them, norm scales around one, biases around zero;
Whisper's sinusoid table as the module makes it) and carried to the flax
tree with ``t5_params_to_flax``/``whisper_params_to_flax``.

Tolerances: logits within 1e-4 relative (L2) in fp32 and 1e-2 in bf16;
the cached decoder's logits within 1e-5 of the full forward's; converters
bit for bit; greedy and beam tokens equal to the JAX package's, with
every greedy step's top-2 logit gap above 1e-4; T5's 3-step trajectory
within rtol 1e-4.
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
from accelerate_tpu import generation as jax_gen
from accelerate_tpu.models import t5 as jt5
from accelerate_tpu.models import whisper as jwhisper
from accelerate_tpu_torch import Accelerator, Model, ServingEngine, adamw, generate
from accelerate_tpu_torch import generation as gen
from accelerate_tpu_torch.models import convert, t5, whisper
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

MIN_GAP = 1e-4
WHISPER_FEATURES = (2, 20, 16)  # (B, T, mel): 10 encoder frames

# name -> (JAX module, JAX config, port module, port config, converter prefix, knobs)
FAMILIES = {
    "t5": (jt5.T5ForConditionalGeneration, jt5.T5Config, t5.T5ForConditionalGeneration,
           t5.T5Config, "t5", {"num_layers": 3}),
    "whisper": (jwhisper.WhisperForConditionalGeneration, jwhisper.WhisperConfig,
                whisper.WhisperForConditionalGeneration, whisper.WhisperConfig, "whisper", {}),
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
    return np.random.default_rng(seed).integers(2, vocab, (b, s)).astype(np.int64)


def _weights(module, d_kv=None, seed=0) -> dict:
    rng = np.random.default_rng(seed)
    out = {}
    for name, p in module.state_dict().items():
        if name == "encoder.embed_positions":  # Whisper's fixed sinusoids
            out[name] = p.clone()
            continue
        if p.dim() == 1:
            a = rng.standard_normal(p.shape) * 0.1 + (0.0 if name.endswith("bias") else 1.0)
        else:
            a = rng.standard_normal(p.shape) / np.sqrt(np.prod(p.shape[1:]))
            if d_kv and name.endswith(".q.weight"):
                a = a / np.sqrt(d_kv)
        out[name] = torch.from_numpy(a.astype(np.float32))
    return out


def _build(family, dtype="float32", seed=0, **kw):
    jm, jc, pm, pc, prefix, knobs = FAMILIES[family]
    knobs = {**knobs, **kw}
    cfg = pc.tiny(dtype=getattr(torch, dtype), **knobs)
    module = pm(cfg)
    sd = _weights(module, getattr(cfg, "d_kv", None), seed)
    module.load_state_dict(sd)
    params = jax.tree.map(lambda t: t.numpy(),
                          getattr(convert, f"{prefix}_params_to_flax")(cfg, sd))
    return jm(jc.tiny(dtype=getattr(jnp, dtype), **knobs)), params, cfg, module


def _inputs(family, seed=1):
    """Encoder inputs: token ids (T5, pads at the end of row 1) or
    (B, T, mel) features (Whisper)."""
    if family == "whisper":
        return np.random.default_rng(seed).standard_normal(WHISPER_FEATURES).astype(np.float32)
    ids = _ids(2, 10, seed)
    ids[1, -3:] = 0  # pad_token_id: the encoder's mask hides them
    return ids


def _torch(x):
    return torch.from_numpy(x)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


LOGITS = [("float32", True, 1e-4), ("float32", False, 1e-4), ("bfloat16", True, 1e-2)]


@pytest.mark.parametrize("dtype,scan_layers,tol", LOGITS,
                         ids=[f"{d}-{'stacked' if s else 'unrolled'}" for d, s, _ in LOGITS])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_logits_match_jax(family, dtype, scan_layers, tol):
    """Teacher-forced logits against the JAX module's on the converted tree
    (T5's ``block_0`` apart from the scanned rest)."""
    jmodule, params, cfg, module = _build(family, dtype, scan_layers=scan_layers)
    x, dec = _inputs(family), _ids(2, 5, seed=2)
    want = np.asarray(jmodule.apply({"params": params}, jnp.asarray(x), jnp.asarray(dec)),
                      np.float32)
    with torch.no_grad():
        got = module(_torch(x), _torch(dec)).float()
    assert _rel(got, want) < tol


@pytest.mark.parametrize("scan_layers", [True, False], ids=["stacked", "unrolled"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_converters_round_trip(family, scan_layers):
    _, _, pm, pc, prefix, knobs = FAMILIES[family]
    cfg = pc.tiny(dtype=torch.float32, scan_layers=scan_layers, **knobs)
    module = pm(cfg)
    sd = _weights(module, seed=3)
    tree = getattr(convert, f"{prefix}_params_to_flax")(cfg, sd)
    back = getattr(convert, f"{prefix}_params_from_flax")(cfg, tree)
    assert back.keys() == sd.keys()
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    assert convert.flax_converter(module) is not None


def _decode_logits(cfg, module, x, dec):
    """Every decoder position's logits through the encode plan and the
    cached decoder, the prompt in one call then a token at a time."""
    encode, decode = gen.ENCDEC_GENERATION_PLANS[type(module).__name__]
    enc = encode(cfg, module, _torch(x))
    cache = gen.init_cache(cfg, dec.shape[0], dec.shape[1])
    first, cache = decode(cfg, module, _torch(dec[:, :2]), cache, enc, return_all=True)
    out = [first]
    for j in range(2, dec.shape[1]):
        logits, cache = decode(cfg, module, _torch(dec[:, j:j + 1]), cache, enc)
        out.append(logits[:, None])
    return torch.cat(out, dim=1)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_cached_decode_matches_the_full_forward(family):
    _, _, cfg, module = _build(family, seed=4)
    x, dec = _inputs(family, seed=5), _ids(2, 6, seed=6)
    with torch.no_grad():
        full = module(_torch(x), _torch(dec))
    np.testing.assert_allclose(_decode_logits(cfg, module, x, dec).numpy(), full.numpy(),
                               rtol=1e-5, atol=1e-5)


def _min_gap(cfg, module, x, rows, prompt_len):
    with torch.no_grad():
        logits = module(_torch(x), torch.as_tensor(rows).long())
    top2 = torch.topk(logits[:, prompt_len - 1:-1], 2, dim=-1).values
    return float((top2[..., 0] - top2[..., 1]).min())


# Whisper's style: the start token's prompt, then a language, a task and a
# no-timestamps token forced at decoder positions 1-3.
FORCED = ((1, 7), (2, 11), (3, 13))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_generate_matches_jax(family):
    """Greedy ``generate`` without and with ``decoder_input_ids``, with
    ``forced_decoder_ids`` (Whisper's style), ``suppress_tokens`` and
    ``begin_suppress_tokens``, against the JAX package's tokens."""
    jmodule, params, cfg, module = _build(family, seed=7)
    jmodel = JaxModel(module=jmodule, params=params)
    x = _inputs(family, seed=8)
    got = generate(module, _torch(x), max_new_tokens=6)
    assert got.shape == (2, 7) and (got[:, 0] == 0).all()
    assert _min_gap(cfg, module, x, got, 1) > MIN_GAP
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_generate(jmodel, x, 6)))

    dec = _ids(2, 3, seed=9)
    dec[:, 0] = 0
    got = generate(module, _torch(x), max_new_tokens=5, decoder_input_ids=_torch(dec))
    assert _min_gap(cfg, module, x, got, 3) > MIN_GAP
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_generate(jmodel, x, 5, decoder_input_ids=dec)))

    kw = dict(forced_decoder_ids=FORCED, suppress_tokens=tuple(int(t) for t in got[0, 3:5]),
              begin_suppress_tokens=(int(got[1, 3]),))
    start = np.zeros((2, 1), np.int64)
    got = generate(module, _torch(x), max_new_tokens=6, decoder_input_ids=_torch(start), **kw)
    assert [tuple(got[0, p:p + 1].tolist()) for p, _ in FORCED] == [(t,) for _, t in FORCED]
    assert not np.isin(got[:, 1:].numpy(), kw["suppress_tokens"]).any()
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_generate(jmodel, x, 6, decoder_input_ids=start, **kw)))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_beam_search_matches_jax(family):
    """One beam gives greedy's tokens; three beams the JAX package's
    (the encoded state tiled along the beams), with and without a decoder
    prompt."""
    jmodule, params, cfg, module = _build(family, seed=10)
    jmodel = JaxModel(module=jmodule, params=params)
    x = _inputs(family, seed=11)
    np.testing.assert_array_equal(gen.beam_search(module, _torch(x), 5, num_beams=1).numpy(),
                                  generate(module, _torch(x), max_new_tokens=5).numpy())
    dec = np.zeros((2, 2), np.int64)
    dec[:, 1] = 5
    for kw in ({}, {"decoder_input_ids": dec}):
        got = gen.beam_search(module, _torch(x), 4, num_beams=3,
                              **{k: _torch(v) for k, v in kw.items()})
        want = jax_gen.beam_search(jmodel, x, 4, num_beams=3, **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_t5_three_steps_match_jax_accelerator():
    """``shift_tokens_right`` teacher forcing and ``t5_cross_entropy_loss``
    (label padding -100) through ``prepare_train_step`` against the JAX
    Accelerator's step."""
    rng = np.random.default_rng(12)
    batches = []
    for _ in range(3):
        labels = rng.integers(2, 256, (4, 6)).astype(np.int32)
        labels[1, -2:] = -100
        batches.append({"x": rng.integers(2, 256, (4, 10)).astype(np.int32), "y": labels})
    jmodule, params, cfg, module = _build("t5", seed=13, num_layers=2)
    np.testing.assert_array_equal(t5.shift_tokens_right(batches[0]["y"]).numpy(),
                                  np.asarray(jt5.shift_tokens_right(jnp.asarray(batches[0]["y"]))))

    jacc = JaxAccelerator()
    jacc.prepare(JaxModel(module=jmodule, params=params), optax.adamw(1e-3))
    jstep = jacc.prepare_train_step(lambda p, b: jt5.t5_cross_entropy_loss(
        jmodule.apply({"params": p}, b["x"], jt5.shift_tokens_right(b["y"])), b["y"]),
        max_grad_norm=1.0)
    state, want = jacc.train_state, []
    for b in batches:
        state, m = jstep(state, {k: jnp.asarray(v) for k, v in b.items()})
        want.append((float(m["loss"]), float(m["grad_norm"])))

    acc = Accelerator(cpu=True)
    acc.prepare(Model(module), adamw(1e-3))
    step = acc.prepare_train_step(lambda m, b: t5.t5_cross_entropy_loss(
        m(b["x"], t5.shift_tokens_right(b["y"])), b["y"]), max_grad_norm=1.0)
    state, got = acc.train_state, []
    for b in batches:
        state, m = step(state, {k: v.astype(np.int64) for k, v in b.items()})
        got.append((float(m["loss"]), float(m["grad_norm"])))
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=1e-4)


def test_relative_position_buckets_match_jax():
    rel = np.arange(-300, 300, dtype=np.int32)[None, :] - np.arange(0, 40, dtype=np.int32)[:, None]
    for bidirectional in (True, False):
        for buckets, dist in ((32, 128), (8, 32)):
            want = jt5.relative_position_bucket(jnp.asarray(rel), bidirectional=bidirectional,
                                                num_buckets=buckets, max_distance=dist)
            got = t5.relative_position_bucket(_torch(rel), bidirectional=bidirectional,
                                              num_buckets=buckets, max_distance=dist)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_engine_and_tp_rules_refuse_encoder_decoders(family):
    """The engine serves causal-LM plans and refuses an encoder-decoder
    module with the JAX engine's ValueError; the TP rule tables (ported)
    equal the JAX package's."""
    _, _, cfg, module = _build(family)
    with pytest.raises(ValueError, match="encoder-decoder"):
        ServingEngine(module)
    with pytest.raises(ValueError, match="attention_mask"):
        generate(module, _torch(_inputs(family)), 2, attention_mask=np.ones((2, 10)))
    rules = t5.t5_tp_rules if family == "t5" else whisper.whisper_tp_rules
    jrules = jt5.t5_tp_rules if family == "t5" else jwhisper.whisper_tp_rules
    for scan in (True, False):
        assert rules(scan) == [(p, tuple(s)) for p, s in jrules(scan)]
