"""The port's Hugging Face loading (accelerate_tpu_torch/models/hub.py and
generic_hub.py) against the JAX package's.

Each family's tiny checkpoint is built locally: a randomly initialised
transformers model saved under ``tmp_path`` (InternLM2, which transformers
does not ship, as renamed tensors with a fused wqkv written by the port's
safetensors writer). Both packages load the same directory with
``model_from_pretrained``; fp32 logits agree within rtol 1e-5 and atol
1e-5, and with transformers' own within the JAX tests' 3e-4.
"""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import accelerate_tpu_torch
from accelerate_tpu.models import model_from_pretrained as jax_model_from_pretrained
from accelerate_tpu_torch import generate
from accelerate_tpu_torch.models import (
    LlamaConfig,
    LlamaForCausalLM,
    llama_params_from_hf,
    llama_params_to_hf,
    load_pretrained,
    model_from_pretrained,
)
from accelerate_tpu_torch.models.generic_hub import (
    _LLAMA_STYLE_CONFIG,
    ArchSpec,
    WeightRule,
    register_arch_spec,
)
from accelerate_tpu_torch.utils.other import save_safetensors

transformers = pytest.importorskip("transformers")

SMALL = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64)
FAMILIES = {
    "llama": ("LlamaConfig", "LlamaForCausalLM", dict(tie_word_embeddings=False)),
    "mistral": ("MistralConfig", "MistralForCausalLM", dict(sliding_window=None)),
    "qwen2": ("Qwen2Config", "Qwen2ForCausalLM", dict(tie_word_embeddings=False)),
    "gemma": ("GemmaConfig", "GemmaForCausalLM", dict(head_dim=16)),
    "phi3": ("Phi3Config", "Phi3ForCausalLM", dict(pad_token_id=0)),
    "starcoder2": ("Starcoder2Config", "Starcoder2ForCausalLM",
                   dict(sliding_window=None, use_bias=True)),
    "stablelm": ("StableLmConfig", "StableLmForCausalLM",
                 dict(num_key_value_heads=4, partial_rotary_factor=0.25,
                      tie_word_embeddings=False)),
    "granite": ("GraniteConfig", "GraniteForCausalLM",
                dict(tie_word_embeddings=False, attention_bias=True, mlp_bias=True,
                     embedding_multiplier=3.0, residual_multiplier=0.5,
                     attention_multiplier=0.08, logits_scaling=2.0)),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ids(shape=(2, 10), seed=0, vocab=128):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _hf_model(family, seed=0, **kw):
    cfg_cls, model_cls, extra = FAMILIES[family]
    torch.manual_seed(seed)
    model = getattr(transformers, model_cls)(getattr(transformers, cfg_cls)(
        **{**SMALL, **extra, **kw}))
    return model.eval()


def _hf_logits(model, ids):
    with torch.no_grad():
        return model(torch.from_numpy(ids).long()).logits.numpy()


def _port_logits(src, ids):
    model = model_from_pretrained(src, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        return model(torch.from_numpy(ids).long()).numpy()


def _fuse_qkv_grouped(sd, n_layers, nh, nkv, d):
    """Llama-named state dict → InternLM2's KV-grouped fused wqkv."""
    ratio, out = nh // nkv, dict(sd)
    for i in range(n_layers):
        p = f"model.layers.{i}.self_attn."
        q, k, v = (out.pop(p + f"{n}_proj.weight") for n in "qkv")
        groups = []
        for g in range(nkv):
            groups += [q[g * ratio * d:(g + 1) * ratio * d], k[g * d:(g + 1) * d],
                       v[g * d:(g + 1) * d]]
        out[f"model.layers.{i}.attention.wqkv.weight"] = torch.cat(groups, 0)
    return out


def _internlm2_dir(tmp_path):
    """An InternLM2 checkpoint from a seeded port Llama: renamed tensors, a
    fused wqkv, a config.json."""
    cfg = LlamaConfig(**SMALL, dtype=torch.float32)
    module = LlamaForCausalLM(cfg)
    module.init_weights(torch.Generator().manual_seed(3), std=0.2)
    sd = _fuse_qkv_grouped(llama_params_to_hf(cfg, module.state_dict()), 2, 4, 2, 16)
    renames = {"model.embed_tokens.weight": "model.tok_embeddings.weight",
               "lm_head.weight": "output.weight"}
    per_layer = {"self_attn.o_proj.weight": "attention.wo.weight",
                 "mlp.gate_proj.weight": "feed_forward.w1.weight",
                 "mlp.up_proj.weight": "feed_forward.w3.weight",
                 "mlp.down_proj.weight": "feed_forward.w2.weight",
                 "input_layernorm.weight": "attention_norm.weight",
                 "post_attention_layernorm.weight": "ffn_norm.weight"}
    out = {}
    for key, v in sd.items():
        new = renames.get(key, key)
        for old, repl in per_layer.items():
            if key.endswith(old):
                new = key[: -len(old)] + repl
        out[new] = v
    save_safetensors(out, str(tmp_path / "model.safetensors"))
    (tmp_path / "config.json").write_text(json.dumps(
        {"model_type": "internlm2", **SMALL, "rope_theta": 10000.0,
         "tie_word_embeddings": False}))
    return module


@pytest.mark.parametrize("family", sorted(FAMILIES) + ["internlm2"])
def test_checkpoint_directory_logits_match_jax(family, tmp_path):
    ids = _ids(seed=1)
    if family == "internlm2":
        module = _internlm2_dir(tmp_path)
        with torch.no_grad():
            ref = module(torch.from_numpy(ids).long()).numpy()
    else:
        hf = _hf_model(family)
        hf.save_pretrained(tmp_path, safe_serialization=True)
        ref = _hf_logits(hf, ids)
    got = _port_logits(str(tmp_path), ids)
    want = np.asarray(jax_model_from_pretrained(str(tmp_path), dtype=jnp.float32)(ids))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, ref, rtol=3e-4, atol=3e-4)


# The five families with rows of their own (GPT-2, OPT, GPT-NeoX, T5,
# Whisper): tiny transformers models from config objects, and the inputs
# of their forward (Whisper's features in transformers' (B, mel, T)).
OTHER_FAMILIES = {
    "gpt2": ("GPT2Config", "GPT2LMHeadModel",
             dict(vocab_size=128, n_positions=64, n_embd=64, n_layer=2, n_head=4)),
    "opt": ("OPTConfig", "OPTForCausalLM",
            dict(vocab_size=128, hidden_size=64, ffn_dim=128, num_hidden_layers=2,
                 num_attention_heads=4, max_position_embeddings=64)),
    "gpt_neox": ("GPTNeoXConfig", "GPTNeoXForCausalLM",
                 dict(vocab_size=128, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                      intermediate_size=128, rotary_pct=0.25, max_position_embeddings=64)),
    "t5": ("T5Config", "T5ForConditionalGeneration",
           dict(vocab_size=96, d_model=32, d_kv=8, d_ff=64, num_layers=2, num_heads=4,
                relative_attention_num_buckets=8, relative_attention_max_distance=16,
                decoder_start_token_id=0, pad_token_id=0, eos_token_id=1)),
    "whisper": ("WhisperConfig", "WhisperForConditionalGeneration",
                dict(vocab_size=96, num_mel_bins=16, d_model=32, encoder_layers=2,
                     decoder_layers=2, encoder_attention_heads=4, decoder_attention_heads=4,
                     encoder_ffn_dim=64, decoder_ffn_dim=64, max_source_positions=24,
                     max_target_positions=32, pad_token_id=0, bos_token_id=1, eos_token_id=2,
                     decoder_start_token_id=1)),
}


def _other_model(family, seed=0):
    cfg_cls, model_cls, kw = OTHER_FAMILIES[family]
    torch.manual_seed(seed)
    return getattr(transformers, model_cls)(getattr(transformers, cfg_cls)(**kw)).eval()


def _other_inputs(family):
    """(transformers' inputs, the packages' inputs): ids, or (encoder
    input, decoder ids); Whisper's features transposed to (B, T, mel)."""
    rng = np.random.default_rng(4)
    if family == "t5":
        ids = rng.integers(2, 96, (2, 8))
        dec = rng.integers(2, 96, (2, 5))
        return (ids, dec), (ids, dec)
    if family == "whisper":
        feats = rng.normal(size=(2, 16, 48)).astype(np.float32)
        dec = rng.integers(2, 96, (2, 5))
        return (feats, dec), (np.ascontiguousarray(feats.transpose(0, 2, 1)), dec)
    ids = rng.integers(0, 128, (2, 12))
    return (ids,), (ids,)


@pytest.mark.parametrize("family", sorted(OTHER_FAMILIES))
def test_other_families_load_like_the_jax_hub(family, tmp_path):
    """A transformers checkpoint directory of each family: the port's and
    the JAX package's ``model_from_pretrained`` give the same fp32 logits
    (1e-5), and transformers' own (3e-4)."""
    hf = _other_model(family)
    hf.save_pretrained(tmp_path, safe_serialization=True)
    theirs, ours = _other_inputs(family)
    names = {"t5": ("input_ids", "decoder_input_ids"),
             "whisper": ("input_features", "decoder_input_ids")}.get(family, ("input_ids",))
    with torch.no_grad():
        ref = hf(**{n: torch.from_numpy(x) for n, x in zip(names, theirs)}).logits.numpy()
    model = model_from_pretrained(str(tmp_path), dtype=torch.float32, device="cpu")
    with torch.no_grad():
        got = model(*(torch.from_numpy(x) for x in ours)).float().numpy()
    jmodel = jax_model_from_pretrained(str(tmp_path), dtype=jnp.float32)
    want = np.asarray(jmodel(*(x.astype(np.float32 if x.dtype == np.float32 else np.int32)
                               for x in ours)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, ref, rtol=3e-4, atol=3e-4)


def test_t5_and_whisper_generate_like_transformers():
    """T5's greedy tokens equal transformers' ``generate``; Whisper's equal
    transformers' greedy loop over its own forward (its ``generate`` adds
    task-token logic), as tests/test_generation.py holds the JAX package."""
    hf = _other_model("t5")
    ids = np.random.default_rng(3).integers(2, 96, (2, 8)).astype(np.int64)
    with torch.no_grad():
        want = hf.generate(torch.from_numpy(ids), max_new_tokens=5, do_sample=False,
                           min_length=0).numpy()
    got = generate(model_from_pretrained(hf, dtype=torch.float32, device="cpu"),
                   torch.from_numpy(ids), max_new_tokens=5, eos_token_id=1)
    np.testing.assert_array_equal(got.numpy()[:, :want.shape[1]], want)

    hf = _other_model("whisper")
    feats = np.random.default_rng(5).normal(size=(1, 16, 48)).astype(np.float32)
    dec = np.asarray([[50]], np.int64)
    with torch.no_grad():
        for _ in range(5):
            logits = hf(input_features=torch.from_numpy(feats),
                        decoder_input_ids=torch.from_numpy(dec)).logits
            dec = np.concatenate([dec, logits[:, -1].argmax(-1, keepdim=True).numpy()], axis=1)
    got = generate(model_from_pretrained(hf, dtype=torch.float32, device="cpu"),
                   torch.from_numpy(np.ascontiguousarray(feats.transpose(0, 2, 1))),
                   max_new_tokens=5, decoder_input_ids=torch.from_numpy(dec[:, :1]))
    np.testing.assert_array_equal(got.numpy(), dec)


def test_transformers_model_and_pytorch_bin_load(tmp_path):
    """A transformers model object, and a pytorch_model.bin directory; the
    loaded masters are copies, so the source's weights stay as they were."""
    hf = _hf_model("qwen2", seed=2)
    cfg, sd, cls = load_pretrained(hf, dtype=torch.float32)
    assert cfg.attention_bias and cls is LlamaForCausalLM
    assert sd["model.layers.0.self_attn.q_proj.bias"].shape == (64,)
    sd["model.norm.weight"].add_(1.0)
    assert not torch.equal(sd["model.norm.weight"], hf.model.norm.weight)
    ids = _ids(seed=2)
    torch.save(hf.state_dict(), tmp_path / "pytorch_model.bin")
    hf.config.to_json_file(tmp_path / "config.json")
    np.testing.assert_allclose(_port_logits(str(tmp_path), ids), _port_logits(hf, ids),
                               rtol=0, atol=0)


def test_llama_params_round_trip_to_hf():
    hf = _hf_model("llama", seed=1)
    sd = hf.state_dict()
    cfg, _, _ = load_pretrained(hf, dtype=torch.float32)
    back = llama_params_to_hf(cfg, llama_params_from_hf(cfg, sd))
    assert back.keys() == {k for k in sd if "rotary" not in k}
    for k, v in back.items():
        assert torch.equal(v, sd[k]), k


def test_register_arch_spec_user_extension():
    """A user's spec for an arbitrary model_type (Llama tensors under a
    renamed prefix) loads with no change to the package."""
    cfg = LlamaConfig(**SMALL, dtype=torch.float32)
    module = LlamaForCausalLM(cfg)
    module.init_weights(torch.Generator().manual_seed(1), std=0.2)
    sd = {k.replace("model.", "backbone.", 1): v
          for k, v in llama_params_to_hf(cfg, module.state_dict()).items()}
    b = r"backbone\.layers\.(?P<i>\d+)\."
    register_arch_spec("examplelm", ArchSpec(
        config_map=_LLAMA_STYLE_CONFIG,
        rules=[WeightRule(r"backbone\.embed_tokens\.weight", "model.embed_tokens.weight"),
               WeightRule(r"backbone\.norm\.weight", "model.norm.weight"),
               WeightRule(r"lm_head\.weight", "lm_head.weight")]
        + [WeightRule(b + name.replace(".", r"\."), name)
           for name in ("self_attn.q_proj.weight", "self_attn.k_proj.weight",
                        "self_attn.v_proj.weight", "self_attn.o_proj.weight",
                        "mlp.gate_proj.weight", "mlp.up_proj.weight", "mlp.down_proj.weight",
                        "input_layernorm.weight", "post_attention_layernorm.weight")]))
    ids = _ids(seed=3)
    got = _port_logits(({"model_type": "examplelm", **SMALL}, sd), ids)
    with torch.no_grad():
        np.testing.assert_allclose(got, module(torch.from_numpy(ids).long()).numpy(),
                                   rtol=1e-5, atol=1e-5)


def _starcoder2_sd(**kw):
    hf = _hf_model("starcoder2", num_hidden_layers=kw.pop("layers", 1), **kw)
    return hf, {k: v.numpy() for k, v in hf.state_dict().items()}


def test_refusals_of_the_jax_tests_raise():
    """tests/test_hub.py:197 and tests/test_generic_hub.py:125, 320, 334,
    393 and 407, and a BERT checkpoint without the model's tensors."""
    with pytest.raises(ValueError, match="longrope"):
        load_pretrained(_hf_model("phi3", original_max_position_embeddings=32, rope_scaling={
            "type": "longrope", "short_factor": [1.0] * 8, "long_factor": [2.0] * 8}))
    with pytest.raises(ValueError, match="parallel_residual"):
        load_pretrained(_hf_model("stablelm", num_hidden_layers=1, use_parallel_residual=True))
    with pytest.raises(ValueError, match="sliding_window"):
        load_pretrained(_hf_model("starcoder2", num_hidden_layers=1, sliding_window=4096))
    hf, sd = _starcoder2_sd(layers=2)
    bad = hf.config.to_dict()
    bad["num_hidden_layers"] = 1
    with pytest.raises(ValueError, match="num_hidden_layers=1"):
        load_pretrained((bad, sd))
    hf, sd = _starcoder2_sd()
    sd["model.layers.0.mystery.weight"] = np.zeros((4, 4), np.float32)
    with pytest.raises(ValueError, match="mystery"):
        load_pretrained((hf.config.to_dict(), sd))
    with pytest.raises(ValueError, match="starcoder2"):
        load_pretrained(({"model_type": "definitely_not_a_model"}, {}))
    with pytest.raises(ValueError, match="Unsupported model family"):
        load_pretrained(({"model_type": "umbrellanet"}, {}))
    with pytest.raises(KeyError, match="checkpoint lacks"):
        load_pretrained(({"model_type": "bert", "vocab_size": 64, "hidden_size": 16,
                          "num_hidden_layers": 1, "num_attention_heads": 2,
                          "intermediate_size": 32}, {}))


def test_the_port_imports_neither_transformers_nor_safetensors():
    package = Path(accelerate_tpu_torch.__file__).parent
    for path in package.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in ("transformers", "safetensors"), (path, name)
