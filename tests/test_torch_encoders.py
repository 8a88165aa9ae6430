"""The port's BERT, ViT and CLIP (``accelerate_tpu_torch/models/bert.py``,
``vit.py``, ``clip.py``, their flax converters and hub rows) against the
JAX package's, on the CPU.

Weights are drawn with numpy from a seed in the port's layout (matrices
of std 1/sqrt(fan-in), norm scales around one, biases around zero) and
carried to the flax tree with the family's converter, whose tree has the
names and shapes of the JAX module's own initialisation; inputs are drawn
with numpy from a seed.

Tolerances: fp32 logits within 1e-5 (absolute and relative) of the JAX
module's on the stacked and the unrolled flax trees, bf16 within 2e-2
relative (L2) (CLIP's logits, ``exp(logit_scale)`` times the cosines of
near-orthogonal random embeddings, within 2e-2 of that scale); the
converters bit for bit both ways; 3 steps of
``prepare_train_step`` (losses and grad norms) within rtol 1e-4 of the JAX
Accelerator's; transformers checkpoints loaded by the hub rows within 1e-5
of the JAX hub's logits and 3e-4 of transformers' own. BERT with fp8
(QDQ) projections within 3e-2 relative of the JAX module's logits, for
the reason tests/test_torch_decoder_families.py gives for GPT-2's.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu import Model as JaxModel
from accelerate_tpu.models import bert as jbert
from accelerate_tpu.models import clip as jclip
from accelerate_tpu.models import model_from_pretrained as jax_model_from_pretrained
from accelerate_tpu.models import vit as jvit
from accelerate_tpu_torch import Accelerator, Model, adamw
from accelerate_tpu_torch.models import (
    bert,
    clip,
    clip_contrastive_loss,
    convert,
    masked_lm_loss,
    model_from_pretrained,
    vit,
)
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

# name -> (JAX module, JAX config, port module, port config)
FAMILIES = {
    "bert_mlm": (jbert.BertForMaskedLM, jbert.BertConfig, bert.BertForMaskedLM, bert.BertConfig),
    "bert_cls": (jbert.BertForSequenceClassification, jbert.BertConfig,
                 bert.BertForSequenceClassification, bert.BertConfig),
    "vit": (jvit.ViTForImageClassification, jvit.ViTConfig, vit.ViTForImageClassification,
            vit.ViTConfig),
    "clip": (jclip.CLIPModel, jclip.CLIPConfig, clip.CLIPModel, clip.CLIPConfig),
}
LAYOUTS = {"stacked": True, "unrolled": False}


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


def _inputs(family, seed=1, batch=2):
    """The family's forward inputs as numpy: BERT's ids and a padding mask
    (row 1's last four keys hidden), NHWC pixels, CLIP's ids (the largest
    id last: the EOT of ``eos_token_id=2``) and pixels."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 250, (batch, 12)).astype(np.int32)
    pixels = rng.normal(size=(batch, 32, 32, 3)).astype(np.float32)
    if family.startswith("bert"):
        mask = np.ones_like(ids)
        mask[1:, 8:] = 0
        return ids, mask
    if family == "vit":
        return (pixels,)
    ids[:, -1] = 511
    return ids, pixels


def _torch(args):
    return [torch.from_numpy(a).long() if a.dtype == np.int32 else torch.from_numpy(a)
            for a in args]


def _outputs(out):
    """The arrays a forward returns (CLIP's four, else the logits)."""
    return [np.asarray(o, np.float32) for o in (out if isinstance(out, tuple) else (out,))]


def _weights(module, seed=0) -> dict:
    rng = np.random.default_rng(seed)
    out = {}
    for name, p in module.state_dict().items():
        if p.dim() == 0:  # CLIP's logit_scale
            a = np.full((), 2.6592)
        elif p.dim() == 1:
            a = rng.standard_normal(p.shape) * 0.1 + (0.0 if name.endswith("bias") else 1.0)
        else:
            a = rng.standard_normal(p.shape) / np.sqrt(np.prod(p.shape[1:]))
        out[name] = torch.from_numpy(a.astype(np.float32))
    return out


@pytest.fixture(scope="module")
def trees():
    """Per family and layout: the JAX module and the flax params (fp32
    numpy) of one set of weights."""
    out = {}
    for family, (jm, jc, pm, pc) in FAMILIES.items():
        sd = _weights(pm(pc.tiny(dtype=torch.float32)), seed=3)
        for layout, scan in LAYOUTS.items():
            cfg = pc.tiny(dtype=torch.float32, scan_layers=scan)
            tree = convert.flax_converter(pm(cfg, device="meta")).to_flax(cfg, sd)
            out[family, layout] = (jm(jc.tiny(dtype=jnp.float32, scan_layers=scan)),
                                   jax.tree.map(lambda t: t.numpy(), tree))
    return out


def _port(family, params, dtype=torch.float32, **kw):
    _, _, pm, pc = FAMILIES[family]
    cfg = pc.tiny(dtype=dtype, **kw)
    module = pm(cfg)
    sd = convert.flax_converter(module).views_from_flax(cfg, params)
    module.load_state_dict({k: v.float() for k, v in sd.items()})
    return cfg, module


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_fp32_logits_match_jax(trees, family, layout):
    """Every output of the forward (CLIP's logits both ways and its two
    normalised embeddings) within 1e-5 of the JAX module's, fp32."""
    jmodule, params = trees[family, layout]
    args = _inputs(family)
    want = _outputs(jmodule.apply({"params": params}, *args))
    _, module = _port(family, params, scan_layers=LAYOUTS[layout])
    with torch.no_grad():
        got = _outputs(module(*_torch(args)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_bf16_logits_match_jax(trees, family):
    """The bf16 modules (fp32 masters) within 2e-2 relative of each other;
    CLIP's logits within 2e-2 of their scale."""
    jmodule, params = trees[family, "stacked"]
    jm, jc, _, _ = FAMILIES[family]
    args = _inputs(family)
    want = _outputs(jm(jc.tiny(dtype=jnp.bfloat16)).apply({"params": params}, *args))
    _, module = _port(family, params, dtype=torch.bfloat16)
    with torch.no_grad():
        got = _outputs(module(*_torch(args)))
    if family == "clip":
        scale = float(np.exp(params["logit_scale"]))
        for g, w in zip(got[:2], want[:2]):
            assert np.abs(g - w).max() < 2e-2 * scale
        got, want = got[2:], want[2:]
    for g, w in zip(got, want):
        assert _rel(g, w) < 2e-2


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_flax_trees_round_trip_bit_equal(trees, family, layout):
    """The converted tree has the names and shapes of the JAX module's own
    initialisation; flax tree → state dict → flax tree, and the state dict
    back, bit for bit; the registry's flax names are the unrolled tree's."""
    jmodule, params = trees[family, layout]
    shapes = jax.eval_shape(jmodule.init, jax.random.key(0),
                            *(jnp.asarray(a) for a in _inputs(family)))["params"]
    assert jax.tree.map(lambda a: a.shape, shapes) == jax.tree.map(np.shape, params)
    cfg, module = _port(family, params, scan_layers=LAYOUTS[layout])
    conv = convert.flax_converter(module)
    sd = {k: v.detach() for k, v in module.state_dict().items()}
    tree = conv.to_flax(cfg, sd)
    got = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    want = jax.tree_util.tree_flatten_with_path(params)[0]
    assert len(got) == len(want)
    for path, leaf in want:
        assert torch.equal(got[path], torch.from_numpy(np.asarray(leaf))), path
    back = conv.views_from_flax(cfg, tree)
    assert back.keys() == sd.keys() and all(torch.equal(back[k], sd[k]) for k in sd)
    ucfg, unrolled = _port(family, trees[family, "unrolled"][1], scan_layers=False)
    names = {"/".join(k.key for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(
                 conv.to_flax(ucfg, unrolled.state_dict()))[0]}
    assert {conv.flax_name(cfg, k) for k in sd} == names


def _losses(family):
    """(JAX loss of (module, params, batch), port loss of (model, batch),
    the batch as numpy) of each family's training objective."""
    rng = np.random.default_rng(7)
    if family == "bert_mlm":
        ids, mask = _inputs(family, seed=5, batch=4)
        labels = np.where(rng.random(ids.shape) < 0.3, ids, -100).astype(np.int32)
        return (lambda m, p, b: jbert.masked_lm_loss(
                    m.apply({"params": p}, b["ids"], b["mask"]), b["labels"]),
                lambda m, b: masked_lm_loss(m(b["ids"], b["mask"]), b["labels"]),
                {"ids": ids, "mask": mask, "labels": labels})
    if family == "clip":
        ids, pixels = _inputs(family, seed=5, batch=4)
        return (lambda m, p, b: jclip.clip_contrastive_loss(m, p, b["ids"], b["pixels"]),
                lambda m, b: clip_contrastive_loss(m, b["ids"], b["pixels"]),
                {"ids": ids, "pixels": pixels})

    def ce(logits, labels):
        return -jnp.mean(jnp.take_along_axis(jax.nn.log_softmax(logits), labels[:, None], 1))

    def port_ce(logits, labels):
        return -torch.log_softmax(logits, -1).gather(1, labels[:, None]).mean()

    labels = rng.integers(0, 2 if family == "bert_cls" else 4, 4).astype(np.int32)
    if family == "bert_cls":
        ids, mask = _inputs(family, seed=5, batch=4)
        return (lambda m, p, b: ce(m.apply({"params": p}, b["ids"], b["mask"]), b["labels"]),
                lambda m, b: port_ce(m(b["ids"], b["mask"]), b["labels"]),
                {"ids": ids, "mask": mask, "labels": labels})
    (pixels,) = _inputs(family, seed=5, batch=4)
    return (lambda m, p, b: ce(m.apply({"params": p}, b["pixels"]), b["labels"]),
            lambda m, b: port_ce(m(b["pixels"]), b["labels"]),
            {"pixels": pixels, "labels": labels})


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_three_steps_match_jax_accelerator(trees, family):
    """Three fp32 steps of the family's loss (adamw, clipping at 1.0; the
    port's blocks under remat, which changes no number): losses and grad
    norms within rtol 1e-4 of the JAX Accelerator's."""
    jmodule, params = trees[family, "stacked"]
    jloss, loss, batch = _losses(family)
    jacc = JaxAccelerator()
    jacc.prepare(JaxModel(module=jmodule, params=jax.tree.map(jnp.array, params)),
                 optax.adamw(1e-3))
    jstep = jacc.prepare_train_step(lambda p, b: jloss(jmodule, p, b), max_grad_norm=1.0)
    state, want = jacc.train_state, []
    for _ in range(3):
        state, m = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()})
        want.append((float(m["loss"]), float(m["grad_norm"])))
    _, module = _port(family, params, remat=True)
    acc = Accelerator(cpu=True)
    acc.prepare(Model(module), adamw(1e-3))
    step = acc.prepare_train_step(loss, max_grad_norm=1.0)
    state, got = acc.train_state, []
    for _ in range(3):
        state, m = step(state, {k: torch.from_numpy(v).long() if v.dtype == np.int32
                                else torch.from_numpy(v) for k, v in batch.items()})
        got.append((float(m["loss"]), float(m["grad_norm"])))
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=1e-4)


def test_bert_padding_mask_and_tied_head(trees):
    """Hidden keys change nothing: row 1's logits at its seen positions stay
    when the ids under its mask change. The MLM head is the word embedding:
    the logits are the transform's output times its transpose plus
    ``decoder_bias``, and the head's gradient reaches the embedding."""
    _, params = trees["bert_mlm", "stacked"]
    _, module = _port("bert_mlm", params)
    ids, mask = _torch(_inputs("bert_mlm"))
    other = ids.clone()
    other[1, 8:] = (other[1, 8:] + 7) % 250 + 1
    with torch.no_grad():
        a, b = module(ids, mask), module(other, mask)
    torch.testing.assert_close(a[1, :8], b[1, :8], rtol=1e-6, atol=1e-6)
    assert not torch.allclose(a[1, 8:], b[1, 8:])
    x, _ = module.bert(ids, mask)
    h = module.transform_norm(torch.nn.functional.gelu(module.transform(x)))
    tied = h @ module.bert.word_embeddings.weight.T + module.decoder_bias
    torch.testing.assert_close(module(ids, mask), tied, rtol=1e-6, atol=1e-6)
    assert "decoder.weight" not in dict(module.named_parameters())
    module(ids, mask)[..., :5].sum().backward()
    assert module.bert.word_embeddings.weight.grad[:5].abs().sum() > 0


@pytest.mark.parametrize("eos", [2, 97], ids=["argmax", "first_eos"])
def test_clip_pooling_conventions(eos):
    """``eos_token_id == 2`` pools the text tower at the arg-max of the ids;
    any other value at the first position holding it (a later repeat of
    the id is not the pooled one), as the JAX module does."""
    jcfg = jclip.CLIPConfig.tiny(dtype=jnp.float32, eos_token_id=eos, text_num_layers=1,
                                 vision_num_layers=1)
    rng = np.random.default_rng(2)
    ids = rng.integers(3, 90, (2, 10)).astype(np.int32)
    ids[0, 4], ids[0, 7], ids[1, 9] = 97, 97, 97
    jm = jclip.CLIPModel(jcfg)
    pixels = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    params = jm.init(jax.random.key(4), ids, pixels)["params"]
    want = np.asarray(jm.apply({"params": params}, ids, method=jm.encode_text))
    _, module = _port("clip", params, eos_token_id=eos, text_num_layers=1,
                      vision_num_layers=1)
    with torch.no_grad():
        got = module.encode_text(torch.from_numpy(ids).long())
        x, pooled = module.text(torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    at = ids.argmax(-1) if eos == 2 else np.array([4, 9])
    torch.testing.assert_close(pooled, x[torch.arange(2), torch.from_numpy(at)])


def test_bert_fp8_logits_near_jax(trees):
    """``fp8=True`` (QDQ on the CPU) through the port's fp8 linear, against
    the JAX module's fp8 projections on the same tree."""
    _, params = trees["bert_mlm", "stacked"]
    args = _inputs("bert_mlm")
    jm = jbert.BertForMaskedLM(jbert.BertConfig.tiny(dtype=jnp.float32, fp8=True,
                                                     fp8_backend="QDQ"))
    want = np.asarray(jm.apply({"params": params}, *args))
    _, module = _port("bert_mlm", params, fp8=True, fp8_backend="QDQ")
    with torch.no_grad():
        got = module(*_torch(args))
    assert _rel(got, want) < 3e-2


def test_tp_rules_raise_naming_item_6():
    """The TP rule tables are ported (ROADMAP.md Queue A item 6's TP half):
    each equals the JAX package's (tests/test_torch_tensor_parallel.py runs
    them)."""
    for fn, jfn in ((bert.bert_tp_rules, jbert.bert_tp_rules), (vit.vit_tp_rules, jvit.vit_tp_rules),
                    (clip.clip_tp_rules, jclip.clip_tp_rules)):
        for scan in (True, False):
            assert fn(scan) == [(p, tuple(s)) for p, s in jfn(scan)]


HF_ROWS = {
    "bert": ("BertConfig", "BertForSequenceClassification",
             dict(vocab_size=128, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                  intermediate_size=128, max_position_embeddings=64, num_labels=3,
                  hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)),
    "vit": ("ViTConfig", "ViTForImageClassification",
            dict(image_size=32, patch_size=8, hidden_size=64, num_hidden_layers=2,
                 num_attention_heads=4, intermediate_size=128, num_labels=5)),
    "clip": ("CLIPConfig", "CLIPModel",
             dict(text_config=dict(vocab_size=99, hidden_size=32, num_hidden_layers=2,
                                   num_attention_heads=2, intermediate_size=64,
                                   max_position_embeddings=16, eos_token_id=98),
                  vision_config=dict(image_size=32, patch_size=8, hidden_size=48,
                                     num_hidden_layers=2, num_attention_heads=2,
                                     intermediate_size=96),
                  projection_dim=24)),
}


@pytest.mark.parametrize("family", sorted(HF_ROWS))
def test_hub_rows_load_like_the_jax_hub(family, tmp_path, monkeypatch):
    """A transformers checkpoint directory read by the port's
    ``model_from_pretrained`` and the transformers model read by the JAX
    package's give the same fp32 outputs (1e-5), and transformers' own
    (3e-4). (The JAX hub takes ``num_labels`` from the config, which a
    ``config.json`` holds only as ``id2label``: it cannot read a
    classifier's directory.)"""
    monkeypatch.setenv("USE_TF", "0")
    transformers = pytest.importorskip("transformers")
    cfg_cls, model_cls, kw = HF_ROWS[family]
    torch.manual_seed(0)
    hf = getattr(transformers, model_cls)(getattr(transformers, cfg_cls)(**kw)).eval()
    hf.save_pretrained(tmp_path, safe_serialization=True)
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 98, (2, 12))
    ids[:, -1] = 98
    pixels = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    nchw = torch.from_numpy(np.ascontiguousarray(pixels.transpose(0, 3, 1, 2)))
    ours = {"bert": (ids,), "vit": (pixels,), "clip": (ids, pixels)}[family]
    with torch.no_grad():
        if family == "bert":
            out = hf(input_ids=torch.from_numpy(ids)).logits
        elif family == "vit":
            out = hf(pixel_values=nchw).logits
        else:
            out = hf(input_ids=torch.from_numpy(ids), pixel_values=nchw)
            out = (out.logits_per_image, out.logits_per_text, out.image_embeds, out.text_embeds)
    ref = _outputs(tuple(o.numpy() for o in out) if family == "clip" else out.numpy())
    model = model_from_pretrained(str(tmp_path), dtype=torch.float32, device="cpu")
    with torch.no_grad():
        got = _outputs(model(*_torch([a.astype(np.int32) if a.dtype == np.int64 else a
                                      for a in ours])))
    jmodel = jax_model_from_pretrained(hf, dtype=jnp.float32)
    want = _outputs(jmodel(*(a.astype(np.int32) if a.dtype == np.int64 else a for a in ours)))
    for g, w, r in zip(got, want, ref):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(g, r, rtol=3e-4, atol=3e-4)
