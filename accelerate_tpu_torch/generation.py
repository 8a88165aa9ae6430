"""Autoregressive generation with a KV cache (counterpart of
``accelerate_tpu/generation.py``).

- The cache is ``KVCache(k, v, length)``: k and v preallocated as
  ``(L, B, T_max, Hkv, D)`` and written in place, ``length`` a device
  tensor, ``()`` for a batch-global cache (``generate``) or ``(B,)`` for a
  slot cache whose rows advance independently (``serving.py``). A write
  at a per-row offset drops the rows that fall past ``T_max``, as the JAX
  scatter does.
- int8 KV pages: ``init_cache(dtype=torch.int8)`` keeps k and v as
  ``QuantPages`` (int8 codes and one fp32 absmax scale per row of the
  head dim). Each new row is quantized where it is written and the pages
  dequantize next to the attention products.
- The cached forward runs the Llama block math on the port's
  ``LlamaForCausalLM`` parameters layer by layer, with the JAX plan's
  numerics: RoPE at absolute cache positions (shifted down by each row's
  left padding), attention over the whole cache with a position mask,
  ``finfo(dtype).min`` on masked scores and the softmax in fp32. It runs
  every knob of the decoder chassis (``models/llama.py``): layernorm or
  RMSNorm with Gemma's plus one, biases, an ungated MLP and its
  activation, partial rotary, Gemma's and Granite's constants.
- ``generate`` runs the prompt once and then ``max_new_tokens`` decode
  steps in a loop that reads nothing back to the host: every shape of a
  decode step is static and ``done`` stays on the device.
- Sampling: greedy, temperature, top-k, top-p, drawn with an explicit
  ``torch.Generator`` (the JAX ``rng`` key).
- ``speculative_generate`` (greedy, batch 1, a draft model) and
  ``beam_search`` (length-normalised) over the same cached forward.
- The plan comes from the module's class (``GENERATION_PLANS``,
  ``register_generation_plan``) unless ``forward_cached=`` names one.

- Mixtral's plan is the same forward: a layer with a router runs the
  JAX plan's dropless expert layer (``_moe_dropless``) in place of the
  MLP, and its other knobs are the chassis defaults.
- GPT-2, OPT and GPT-NeoX have plans of their own with the JAX plans'
  numerics (``_gpt2_forward_cached``, ``_opt_forward_cached``,
  ``_neox_forward_cached``): learned positions (OPT's offset of 2) or
  partial rotary, the JAX plans' LayerNorm (``_layer_norm``: statistics
  rounded to the activations' type), fused projections split by view.
- Encoder-decoder families (T5, Whisper; ``ENCDEC_GENERATION_PLANS``,
  ``register_encdec_generation_plan``): ``generate``'s and
  ``beam_search``'s ``input_ids`` feed the encoder, which runs once
  through the module's own encoder; each decoder layer's cross-attention
  K and V are computed from its output once (``EncDecState``) and the
  decoder keeps the self-attention cache of the causal plans. The
  decoder prompt defaults to one ``decoder_start_token_id`` a row; beam
  search tiles the encoded state along the beams. As in the JAX plans,
  the cross K/V keep the encoder output's type, and the decoder's
  activations take the type that the products promote to (fp32 after the
  first cross-attention for a bf16 config over fp32 masters).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Shard

from .models.llama import (
    activation_fn,
    apply_partial_rope,
    as_dtype,
    embed_tokens,
    layer_norm,
    rms_norm,
    rotary_embedding,
    scale_logits,
    scale_residual,
)
from .models.moe import router_probs, top_k_experts
from .models.t5 import MASKED, relative_position_bucket, t5_rms
from .parallel import tp
from .utils import operations
from .utils.operations import gather_shards
from .utils.quantization import DecodeQuant, dequantize_decode_kernel

_COMPILE_MANAGER_ITEM = "ROADMAP.md Queue A item 12 (control plane: compile_manager.py)"


@dataclasses.dataclass
class QuantPages:
    """int8 KV pages with one absmax scale per row of the head dim: the
    pair that stands in for a float ``KVCache.k``/``.v``. Indexing takes
    the same view of both leaves, so a layer's or a slot's slice is
    written in place like a float cache's."""

    data: torch.Tensor   # int8, the float cache's layout
    scale: torch.Tensor  # fp32, data.shape[:-1] + (1,)

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def shape(self) -> torch.Size:
        return self.data.shape

    @property
    def nbytes(self) -> int:
        return self.data.nbytes + self.scale.nbytes

    def __getitem__(self, index) -> "QuantPages":
        return QuantPages(self.data[index], self.scale[index])


def quantize_kv_page(x: torch.Tensor) -> QuantPages:
    """Symmetric int8 quantization over the last (head dim) axis:
    ``scale = max(amax, tiny) / 127`` in fp32, codes
    ``clip(round(x / scale), -127, 127)`` with round-half-to-even. Both
    divisions are by a tensor, which is a true division on the card too.
    A scale below fp32's smallest normal (a zero row's) is flushed to 0,
    as XLA flushes subnormals."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    tiny = torch.finfo(torch.float32).tiny
    scale = amax.clamp_min(tiny) / torch.full_like(amax, 127.0)
    data = torch.clamp(torch.round(xf / scale), -127, 127)
    scale = torch.where(scale < tiny, torch.zeros_like(scale), scale)
    return QuantPages(data.to(torch.int8), scale)


def dequantize_kv_page(pages: QuantPages, dtype) -> torch.Tensor:
    return pages.data.to(dtype) * pages.scale.to(dtype)


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor | QuantPages  # (L, B, T_max, Hkv, D)
    v: torch.Tensor | QuantPages  # (L, B, T_max, Hkv, D)
    # Tokens written so far: a () tensor (batch-global) or (B,) for a slot
    # cache where every row advances on its own.
    length: torch.Tensor


def _cache_dims(cfg) -> tuple[int, int, int, int]:
    """(layers, kv_heads, head_dim, max_positions) of any ported config. For
    an encoder-decoder config these describe the decoder's self-attention
    cache; T5's relative positions are unbounded (max 2**30)."""
    if hasattr(cfg, "n_dec"):  # T5
        return cfg.n_dec, cfg.num_heads, cfg.d_kv, 2**30
    if hasattr(cfg, "decoder_layers"):  # Whisper
        return (cfg.decoder_layers, cfg.decoder_attention_heads, cfg.decoder_head_dim,
                cfg.max_target_positions)
    layers = getattr(cfg, "num_hidden_layers", None) or cfg.n_layer
    kv_heads = (getattr(cfg, "num_key_value_heads", None)
                or getattr(cfg, "num_attention_heads", None) or cfg.n_head)
    max_pos = getattr(cfg, "max_position_embeddings", None) or cfg.n_positions
    return layers, kv_heads, cfg.head_dim, max_pos


def init_cache(cfg, batch: int, max_len: int, dtype=None, device=None,
               kv_heads: Optional[int] = None) -> KVCache:
    """Zeroed k and v of ``(L, batch, max_len, Hkv, D)``; ``kv_heads``
    replaces the config's Hkv (a rank's own heads under ``tp``).
    ``torch.int8`` gives ``QuantPages`` whose scales start at one, so an
    unwritten row dequantizes to zero as the float cache's does."""
    layers, cfg_kv_heads, head_dim, _ = _cache_dims(cfg)
    kv_heads = kv_heads or cfg_kv_heads
    dtype = dtype or cfg.dtype
    shape = (layers, batch, max_len, kv_heads, head_dim)

    def side():
        if dtype == torch.int8:
            return QuantPages(torch.zeros(shape, dtype=torch.int8, device=device),
                              torch.ones(shape[:-1] + (1,), dtype=torch.float32, device=device))
        return torch.zeros(shape, dtype=dtype, device=device)

    return KVCache(k=side(), v=side(), length=torch.zeros((), dtype=torch.long, device=device))


def init_slot_cache(cfg, n_slots: int, max_len: int, dtype=None, device=None) -> KVCache:
    """Slot cache (serving.py): :func:`init_cache`'s buffers with a per-slot
    ``(n_slots,)`` length."""
    cache = init_cache(cfg, n_slots, max_len, dtype, device)
    cache.length = torch.zeros((n_slots,), dtype=torch.long, device=device)
    return cache


def _row_positions(start: torch.Tensor, b: int, s: int) -> torch.Tensor:
    """(B, S) absolute cache positions of ``s`` tokens appended at ``start``,
    a () tensor or a (B,) per-row vector."""
    offs = torch.arange(s, dtype=torch.long, device=start.device)
    if start.dim() == 1:
        return start[:, None] + offs[None, :]
    return (start + offs).expand(b, s)


def _write_plan(start: torch.Tensor, s: int, t: int):
    """Where a window of ``s`` rows written at per-row offsets ``start``
    (B,) lands in a cache of ``t`` rows: ``(rows (B, 1), target (B, S),
    source (B, S))``. A row below ``t`` writes at its position; a row past
    it writes at ``t - 1`` instead, carrying the value that position ends
    with, so every write there agrees: the window's own row at ``t - 1``
    (a source below ``s``), else the cache's old row (source ``s``). The
    rows past ``t`` are thus dropped, with no mask and no host read."""
    j = torch.arange(s, device=start.device)
    pos = start[:, None] + j
    at_last = (t - 1 - start)[:, None]  # window index of position t - 1
    past = torch.where((at_last >= 0) & (at_last < s), at_last, s)
    rows = torch.arange(start.shape[0], device=start.device)[:, None]
    return rows, pos.clamp(max=t - 1), torch.where(pos < t, j, past)


def _cache_write(ck, k_new: torch.Tensor, start: torch.Tensor, plan=None):
    """Write ``k_new`` (B, S, Hkv, D) into the cache slice ``ck``
    (B, T, Hkv, D) in place, at row offset ``start``: a () tensor (the same
    offset for every row) or a (B,) vector (each row at its own offset,
    where rows at positions >= T are dropped; ``plan`` is
    ``_write_plan``'s, made once for every layer). A ``QuantPages`` slice
    quantizes the new rows and writes codes and scales at the same
    offsets. The offsets stay on the device. Returns ``ck``."""
    if start.dim() == 1 and plan is None:
        plan = _write_plan(start, k_new.shape[1], ck.shape[1])
    if isinstance(ck, QuantPages):
        q = quantize_kv_page(k_new)
        _cache_write(ck.data, q.data, start, plan)
        _cache_write(ck.scale, q.scale, start, plan)
        return ck
    k_new = k_new.to(ck.dtype)
    if start.dim() == 0:
        return ck.index_copy_(1, start + torch.arange(k_new.shape[1], device=ck.device), k_new)
    rows, target, source = plan
    ck[rows, target] = torch.cat([k_new, ck[:, -1:]], dim=1)[rows, source]
    return ck


# ---------------------------------------------------------------------------
# Llama block math on the model's parameters
# ---------------------------------------------------------------------------


def _kernel(w, dtype) -> torch.Tensor:
    """A weight in the compute dtype; an int8 ``DecodeQuant`` dequantizes
    here, next to its matmul."""
    if isinstance(w, DecodeQuant):
        return dequantize_decode_kernel(w, dtype)
    return w.to(dtype)


def _dense(p: dict, name: str, x) -> torch.Tensor:
    """x @ W for the ``(out, in)`` weight ``name.weight`` (q/k/v, o_proj and
    the MLP alike), plus ``name.bias`` when the model has one; a weight
    split over ``tp`` as ``parallel/tp.linear`` computes it."""
    w, bias = p[name + ".weight"], p.get(name + ".bias")
    if tp.is_split(w):
        return tp.linear(x, w, bias, x.dtype)
    y = F.linear(x, _kernel(w, x.dtype))
    return y if bias is None else y + bias.to(y.dtype)


def _proj(p: dict, name: str, x, heads: int) -> torch.Tensor:
    """(B, S, H) → (B, S, heads, D); this rank's heads under ``tp``."""
    b, s, _ = x.shape
    w = p[name + ".weight"]
    if tp.is_split(w):
        return _dense(p, name, x).view(b, s, -1, w.shape[0] // heads)
    return _dense(p, name, x).view(b, s, heads, -1)


def _moe_dropless(cfg, p: dict, pre: str, x) -> torch.Tensor:
    """Mixtral's expert layer as the JAX decode plan computes it: fp32
    routing, every expert on every token (dropless: no capacity), the top-k
    expert outputs mixed with their weights rounded to the compute dtype.
    With the experts split over ep (every rank of the ep slice decoding the
    same tokens) each rank runs its own experts on every token, and the
    picked rows, zero where another rank owns the expert, are summed over
    the ep slice before the same mix."""
    b, s, d = x.shape
    tokens = x.reshape(b * s, d)
    weights, experts = top_k_experts(router_probs(tokens, p[pre + "moe.router"]),
                                     cfg.num_experts_per_tok)
    w_gate = p[pre + "moe.w_gate"]
    token = torch.arange(b * s, device=x.device)[:, None]
    if tp.is_expert_split(w_gate):
        local, mesh = w_gate.to_local().shape[0], w_gate.device_mesh
        start = mesh.get_local_rank() * local
        ye = tp.expert_products(tokens.expand(local, -1, -1), w_gate, p[pre + "moe.w_up"],
                                p[pre + "moe.w_down"], x.dtype)  # (E/ep, T, d)
        mine = (experts >= start) & (experts < start + local)
        picked = ye[(experts - start).clamp(0, local - 1), token] * mine[..., None]
        picked = operations.all_reduce(picked.contiguous(), group=mesh.get_group())
        mixed = picked * weights.to(x.dtype)[..., None]
        return mixed.float().sum(1).to(x.dtype).reshape(b, s, d)
    xe = tokens.expand(cfg.num_local_experts, -1, -1)
    if tp.is_split(w_gate):  # each expert's ffn dim split over tp
        ye = tp.expert_products(xe, w_gate, p[pre + "moe.w_up"], p[pre + "moe.w_down"],
                                x.dtype)
    else:
        h = F.silu(torch.bmm(xe, _kernel(w_gate, x.dtype)))
        h = h * torch.bmm(xe, _kernel(p[pre + "moe.w_up"], x.dtype))
        ye = torch.bmm(h, _kernel(p[pre + "moe.w_down"], x.dtype))  # (E, T, d)
    picked = ye[experts, token]  # (T, k, d)
    mixed = picked * weights.to(x.dtype)[..., None]
    return mixed.float().sum(1).to(x.dtype).reshape(b, s, d)


def _mlp(cfg, p: dict, pre: str, x) -> torch.Tensor:
    """A layer's feed-forward: the chassis MLP, or Mixtral's expert layer
    where the layer has a router."""
    if pre + "moe.router" in p:
        return _moe_dropless(cfg, p, pre, x)
    act = activation_fn(cfg.hidden_act)
    up = _dense(p, pre + "mlp.up_proj", x)
    hidden = act(_dense(p, pre + "mlp.gate_proj", x)) * up if cfg.mlp_gated else act(up)
    return _dense(p, pre + "mlp.down_proj", hidden)


def _chassis_norm(cfg, p: dict, name: str, x) -> torch.Tensor:
    """The norm ``name`` by the chassis knob: layernorm with its bias, or
    RMSNorm, whose weight w computes as w + 1 for Gemma (added in the
    weight's dtype, then cast, as the module does)."""
    w = p[name + ".weight"]
    if cfg.norm_type == "layernorm":
        return layer_norm(x, w, p[name + ".bias"], cfg.rms_norm_eps)
    if cfg.rms_norm_plus_one:
        w = w + 1.0
    return rms_norm(x, w.to(x.dtype), cfg.rms_norm_eps)


def _qkv_proj(cfg, p: dict, pre: str, hn, cos, sin):
    """Roped q and k, and v, of one layer: biases when the model has them,
    RoPE on ``cfg.rotary_dim`` dims, and the attention multiplier folded
    into q after RoPE, where the JAX plan folds it."""
    q = _proj(p, pre + "self_attn.q_proj", hn, cfg.num_attention_heads)
    k = _proj(p, pre + "self_attn.k_proj", hn, cfg.num_key_value_heads)
    v = _proj(p, pre + "self_attn.v_proj", hn, cfg.num_key_value_heads)
    k, v = tp.heads_for_local_q(q, k, v, cfg.num_attention_heads, cfg.num_key_value_heads,
                                p[pre + "self_attn.q_proj.weight"])
    q = apply_partial_rope(q, cos, sin, cfg.rotary_dim)
    k = apply_partial_rope(k, cos, sin, cfg.rotary_dim)
    if cfg.attention_multiplier is not None:
        q = q * as_dtype(cfg.attention_multiplier * np.sqrt(cfg.head_dim), q.dtype)
    return q, k, v


def _attend_mask(q_positions, t: int, kv_valid=None) -> torch.Tensor:
    """(B, Sq, T) bool: cache slot ``kv`` is visible to a query at absolute
    position ``p`` when ``kv <= p`` (which also hides unwritten slots) and,
    with ``kv_valid`` (B, T), when the slot holds no left padding."""
    kv_pos = torch.arange(t, device=q_positions.device)
    visible = kv_pos[None, None, :] <= q_positions[:, :, None]
    if kv_valid is not None:
        visible = visible & kv_valid[:, None, :].bool()
    return visible


def _attend_masked(q, k, v, visible) -> torch.Tensor:
    """q (B, Sq, Hq, D) against cached k/v (B, T, Hkv, D) under ``visible``
    (B, Sq, T). ``QuantPages`` k/v dequantize to ``q.dtype`` here, next to
    the products."""
    if isinstance(k, QuantPages):
        k = dequantize_kv_page(k, q.dtype)
    if isinstance(v, QuantPages):
        v = dequantize_kv_page(v, q.dtype)
    if k.dtype != q.dtype:  # fp32 activations over a 16-bit cache: the promoted type
        dt = torch.promote_types(q.dtype, k.dtype)
        q, k, v = q.to(dt), k.to(dt), v.to(dt)
    hq, hkv = q.shape[2], k.shape[2]
    if hq != hkv:
        k = k.repeat_interleave(hq // hkv, dim=2)
        v = v.repeat_interleave(hq // hkv, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * (1.0 / np.sqrt(q.shape[-1]))
    logits = logits.masked_fill(~visible[:, None], torch.finfo(logits.dtype).min)
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _attend(q, k, v, q_positions, kv_valid=None) -> torch.Tensor:
    """Causal attention of q against the cache at absolute positions
    ``q_positions`` (B, Sq); ``kv_valid`` (B, T) masks left-padding slots."""
    return _attend_masked(q, k, v, _attend_mask(q_positions, k.shape[1], kv_valid))


# The first self-attention projection of each family's decoder, whose
# split says whether the cache holds each rank's heads under ``tp``.
_TP_ATTENTION_WEIGHT = ("transformer.h.0.attn.c_attn.weight",                  # GPT-2
                        "gpt_neox.layers.0.attention.query_key_value.weight",   # NeoX
                        "decoder.block_0.self_attn.q.weight",                   # T5
                        "decoder.layers.0.self_attn.q_proj.weight",             # Whisper
                        "model.layers.0.self_attn.q_proj.weight")               # the rest


def _tp_kv_heads(cfg, params: dict) -> Optional[int]:
    """The kv heads this rank's cache holds when the model is split over
    ``tp`` (None otherwise): its share of the kv heads, or, where the
    Llama chassis keeps them whole (fewer than ``tp``), those its q heads
    read (``parallel/tp.heads_for_local_q``). Every other family splits
    its heads as its q projection."""
    if not any(isinstance(t, DTensor) for t in params.values()):
        return None
    name = next((n for n in _TP_ATTENTION_WEIGHT if n in params), None)
    if name is None or not tp.is_split(params[name]):
        return None
    q = params[name]
    size = q.device_mesh.size()
    _, hkv, _, _ = _cache_dims(cfg)
    if not name.startswith("model.layers.0.self_attn"):
        return hkv // size
    h = cfg.num_attention_heads
    hq = h // size
    if tp.is_split(params["model.layers.0.self_attn.k_proj.weight"]):
        return hkv // size
    return 1 if (h // hkv) % hq == 0 else hq


def _decode_params(model_or_params) -> dict:
    """State-dict names → tensor (or ``DecodeQuant``): a dict as it is, a
    decode-quantized model's ``params``, or a module's (or ``Model``'s)
    parameters, without copies."""
    if isinstance(model_or_params, dict):
        return model_or_params
    params = getattr(model_or_params, "params", None)
    if params is not None:
        return params
    module = getattr(model_or_params, "module", model_or_params)
    params = dict(module.named_parameters())
    if getattr(model_or_params, "sharded", False):
        return _gathered_fsdp_params(model_or_params, params)
    return params


def _gathered_fsdp_params(model, params: dict) -> dict:
    """The decode's parameters of a ``Model`` FSDP2 shards: each sharded
    one gathered over FSDP2's mesh dims only (``utils/operations.
    gather_shards`` of a ``DTensor`` over them; every process of the group
    decodes together), the ``tp`` split and the expert stacks split over
    ep left where they lie, for the decode's tp plan."""
    experts = set(model.expert_params)
    plan = model.tp_plan or {}
    out = {}
    for n, p in params.items():
        if not isinstance(p, DTensor) or n in experts:
            out[n] = p
        elif plan.get(n) is not None and plan[n].tp is not None:
            out[n] = _keep_tp_split(p)
        else:
            out[n] = gather_shards(p)
    return out


def _keep_tp_split(t: DTensor) -> DTensor:
    """A 2-D FSDP2 × ``tp`` parameter as the ``tp`` plan holds it: this
    rank's ``tp`` shard, gathered whole over the data-parallel dims, as a
    ``DTensor`` over the ``tp`` slice with its ``tp`` placement."""
    mesh = t.device_mesh
    names = mesh.mesh_dim_names
    tp_dim = names.index("tp")
    placement = t.placements[tp_dim]
    dp = [m for m in range(mesh.ndim) if m != tp_dim]
    dp_mesh = mesh[tuple(names[m] for m in dp)] if len(dp) > 1 else mesh[names[dp[0]]]
    # This rank's tp shard, still split over the data-parallel dims: gather
    # those. Within the tp shard FSDP2's split is a plain one (its
    # ``_StridedShard`` says only that it was taken inside the tp chunk).
    within = [Shard(pl.dim) if getattr(pl, "dim", None) is not None else pl
              for pl in (t.placements[m] for m in dp)]
    shape = list(t.shape)
    shape[placement.dim] //= mesh.size(tp_dim)
    shape = torch.Size(shape)
    local = DTensor.from_local(t.to_local(), dp_mesh, within, run_check=False, shape=shape,
                               stride=torch.empty(shape, device="meta").stride())
    return DTensor.from_local(gather_shards(local), mesh["tp"], [placement], run_check=False,
                              shape=t.shape, stride=t.stride())


@torch.no_grad()
def _llama_forward_cached(cfg, model_or_params, input_ids, cache: KVCache, return_all=False,
                          pad_offset=None, kv_valid=None):
    """Run ``input_ids`` (B, S), appended at ``cache.length``, through every
    layer: returns (fp32 logits of the last position, or of every position
    with ``return_all``; the cache with its length advanced by S). K and V
    are written into ``cache`` in place.

    Left-padded batches: ``pad_offset`` (B,) counts each row's leading pads
    (RoPE positions shift down by it, so content starts at position 0) and
    ``kv_valid`` (B, T_max) masks the pad slots out of attention."""
    p = _decode_params(model_or_params)
    b, s = input_ids.shape
    start = cache.length
    positions = _row_positions(start, b, s)
    x = embed_tokens(cfg, p["model.embed_tokens.weight"], input_ids.long())
    rope_positions = positions
    if pad_offset is not None:
        rope_positions = torch.clamp(positions - pad_offset[:, None], min=0)
    cos, sin = rotary_embedding(rope_positions, cfg.rotary_dim, cfg.rope_theta, x.dtype)
    visible = _attend_mask(positions, cache.k.shape[2], kv_valid)
    plan = _write_plan(start, s, cache.k.shape[2]) if start.dim() == 1 else None
    rm = cfg.residual_multiplier
    for i in range(cfg.num_hidden_layers):
        pre = f"model.layers.{i}."
        hn = _chassis_norm(cfg, p, pre + "input_layernorm", x)
        q, k_new, v_new = _qkv_proj(cfg, p, pre, hn, cos, sin)
        ck = _cache_write(cache.k[i], k_new, start, plan)
        cv = _cache_write(cache.v[i], v_new, start, plan)
        out = _attend_masked(q, ck, cv, visible)
        out = _dense(p, pre + "self_attn.o_proj", out.reshape(b, s, -1))
        x = x + scale_residual(out, rm)
        hn = _chassis_norm(cfg, p, pre + "post_attention_layernorm", x)
        x = x + scale_residual(_mlp(cfg, p, pre, hn), rm)
    x = _chassis_norm(cfg, p, "model.norm", x)
    h_out = x if return_all else x[:, -1]
    head = p["model.embed_tokens.weight"] if cfg.tie_word_embeddings else p["lm_head.weight"]
    logits = tp.gather_vocab(tp.vocab_logits(h_out, head.to(cfg.dtype)))
    logits = scale_logits(logits, cfg.logits_scaling)
    return logits.float(), KVCache(cache.k, cache.v, start + s)


# ---------------------------------------------------------------------------
# GPT-2, OPT and GPT-NeoX on the model's parameters
# ---------------------------------------------------------------------------


def _layer_norm(x, p: dict, name: str, eps: float) -> torch.Tensor:
    """The JAX plans' LayerNorm (``jnp.mean``/``jnp.var``): mean and
    variance taken in fp32 and rounded to ``x``'s type, the rest in that
    type, with ``name.weight`` (flax's scale) and ``name.bias``."""
    dt = x.dtype
    mean = x.float().mean(-1, keepdim=True)
    var = x.float().var(-1, unbiased=False, keepdim=True)
    y = (x - mean.to(dt)) * torch.rsqrt(var.to(dt) + eps)
    return y * p[name + ".weight"].to(dt) + p[name + ".bias"].to(dt)


def _positions(cache: KVCache, b: int, s: int, pad_offset):
    """(cache positions (B, S), the positions a row's content sits at: the
    cache's shifted down by its left padding)."""
    positions = _row_positions(cache.length, b, s)
    if pad_offset is None:
        return positions, positions
    return positions, torch.clamp(positions - pad_offset[:, None], min=0)


def _cached_layers(x, cache: KVCache, positions, kv_valid, n_layers: int, block):
    """``x`` through ``n_layers`` layers of ``block(i, x, attend)``, where
    ``attend(i, q, k_new, v_new)`` writes layer i's new K/V into ``cache``
    and attends q against it."""
    start = cache.length
    visible = _attend_mask(positions, cache.k.shape[2], kv_valid)
    plan = _write_plan(start, x.shape[1], cache.k.shape[2]) if start.dim() == 1 else None

    def attend(i, q, k_new, v_new):
        ck = _cache_write(cache.k[i], k_new, start, plan)
        cv = _cache_write(cache.v[i], v_new, start, plan)
        return _attend_masked(q, ck, cv, visible)

    for i in range(n_layers):
        x = block(i, x, attend)
    return x


def _head(x, weight, dtype, return_all: bool) -> torch.Tensor:
    """fp32 logits of the last position (every position with
    ``return_all``) through ``weight`` rounded to ``dtype``, in the type the
    two promote to; a head split over ``tp`` on the vocab gives each rank's
    slice, gathered whole (``parallel/tp.gather_vocab``)."""
    h = x if return_all else x[:, -1]
    w = weight.to(dtype)
    dt = torch.promote_types(h.dtype, w.dtype)
    if tp.is_split(w):
        return tp.gather_vocab(tp.vocab_logits(h.to(dt), w.to(dt))).float()
    return F.linear(h.to(dt), w.to(dt)).float()


@torch.no_grad()
def _gpt2_forward_cached(cfg, model_or_params, input_ids, cache: KVCache, return_all=False,
                         pad_offset=None, kv_valid=None):
    """GPT-2 under ``_llama_forward_cached``'s contract: learned positions
    (shifted by left padding), the fused ``c_attn`` split by view, the
    tanh-GELU MLP and the head tied to ``wte``. Under ``tp`` each rank runs
    its heads (``c_attn`` split by heads, ``c_proj`` row-parallel) and the
    vocab-split ``wte`` looks up and gives whole logits."""
    p = _decode_params(model_or_params)
    b, s = input_ids.shape
    eps = cfg.layer_norm_epsilon
    positions, pos_ids = _positions(cache, b, s, pad_offset)
    ids = input_ids.long()
    x = (tp.embedding(ids, p["transformer.wte.weight"]).to(cfg.dtype)
         + F.embedding(pos_ids, p["transformer.wpe.weight"]).to(cfg.dtype))

    def block(i, x, attend):
        pre = f"transformer.h.{i}."
        hn = _layer_norm(x, p, pre + "ln_1", eps)
        # (3, heads, D) rows; under tp this rank's heads of each (a strided split).
        q, k, v = _dense(p, pre + "attn.c_attn", hn).view(b, s, 3, -1, cfg.head_dim).unbind(2)
        x = x + _dense(p, pre + "attn.c_proj", attend(i, q, k, v).reshape(b, s, -1))
        hn = _layer_norm(x, p, pre + "ln_2", eps)
        return x + _dense(p, pre + "c_proj",
                          F.gelu(_dense(p, pre + "c_fc", hn), approximate="tanh"))

    x = _cached_layers(x, cache, positions, kv_valid, cfg.n_layer, block)
    x = _layer_norm(x, p, "transformer.ln_f", eps)
    logits = _head(x, p["transformer.wte.weight"], cfg.dtype, return_all)
    return logits, KVCache(cache.k, cache.v, cache.length + s)


@torch.no_grad()
def _opt_forward_cached(cfg, model_or_params, input_ids, cache: KVCache, return_all=False,
                        pad_offset=None, kv_valid=None):
    """OPT under ``_llama_forward_cached``'s contract: learned positions
    with the offset of 2, biased q/k/v/out projections, the ReLU MLP, the
    head tied to ``embed_tokens``."""
    p = _decode_params(model_or_params)
    b, s = input_ids.shape
    eps, nh = cfg.layer_norm_eps, cfg.num_attention_heads
    positions, pos_ids = _positions(cache, b, s, pad_offset)
    ids = input_ids.long()
    x = (tp.embedding(ids, p["model.embed_tokens.weight"]).to(cfg.dtype)
         + F.embedding(pos_ids + cfg.POSITION_OFFSET,
                       p["model.embed_positions.weight"]).to(cfg.dtype))

    def block(i, x, attend):
        pre = f"model.layers.{i}."
        hn = _layer_norm(x, p, pre + "self_attn_layer_norm", eps)
        q, k, v = (_proj(p, f"{pre}self_attn.{n}_proj", hn, nh) for n in "qkv")
        x = x + _dense(p, pre + "self_attn.out_proj", attend(i, q, k, v).reshape(b, s, -1))
        hn = _layer_norm(x, p, pre + "final_layer_norm", eps)
        return x + _dense(p, pre + "fc2", F.relu(_dense(p, pre + "fc1", hn)))

    x = _cached_layers(x, cache, positions, kv_valid, cfg.num_hidden_layers, block)
    x = _layer_norm(x, p, "model.final_layer_norm", eps)
    logits = _head(x, p["model.embed_tokens.weight"], cfg.dtype, return_all)
    return logits, KVCache(cache.k, cache.v, cache.length + s)


@torch.no_grad()
def _neox_forward_cached(cfg, model_or_params, input_ids, cache: KVCache, return_all=False,
                         pad_offset=None, kv_valid=None):
    """GPT-NeoX under ``_llama_forward_cached``'s contract: the fused
    per-head ``[q|k|v]``, rotary tables in the compute dtype on the leading
    ``rotary_ndims`` dims, the exact-GELU MLP, the parallel (or sequential)
    residual and the untied ``embed_out``."""
    p = _decode_params(model_or_params)
    b, s = input_ids.shape
    eps, rnd = cfg.layer_norm_eps, cfg.rotary_ndims
    positions, rope_positions = _positions(cache, b, s, pad_offset)
    x = tp.embedding(input_ids.long(), p["gpt_neox.embed_in.weight"]).to(cfg.dtype)
    cos, sin = rotary_embedding(rope_positions, rnd, cfg.rotary_emb_base, x.dtype)

    def block(i, x, attend):
        pre = f"gpt_neox.layers.{i}."
        hn = _layer_norm(x, p, pre + "input_layernorm", eps)
        qkv = _dense(p, pre + "attention.query_key_value", hn).view(b, s, -1, 3, cfg.head_dim)
        q, k, v = qkv.unbind(3)
        q = apply_partial_rope(q, cos, sin, rnd)
        k = apply_partial_rope(k, cos, sin, rnd)
        attn = _dense(p, pre + "attention.dense", attend(i, q, k, v).reshape(b, s, -1))

        def mlp(h):
            h = _layer_norm(h, p, pre + "post_attention_layernorm", eps)
            return _dense(p, pre + "dense_4h_to_h", F.gelu(_dense(p, pre + "dense_h_to_4h", h)))

        if cfg.use_parallel_residual:  # the MLP sees the layer's input
            return x + attn + mlp(x)
        x = x + attn
        return x + mlp(x)

    x = _cached_layers(x, cache, positions, kv_valid, cfg.num_hidden_layers, block)
    x = _layer_norm(x, p, "gpt_neox.final_layer_norm", eps)
    logits = _head(x, p["embed_out.weight"], cfg.dtype, return_all)
    return logits, KVCache(cache.k, cache.v, cache.length + s)


# ---------------------------------------------------------------------------
# Encoder-decoder plans (T5, Whisper)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class EncDecState:
    """What the encoder leaves for the decode loop: every decoder layer's
    cross-attention K and V, ``(L_dec, B, S_enc, H, D)`` in the encoder
    output's type, and the encoder's ``(B, S_enc)`` key mask (None for
    Whisper)."""

    cross_k: torch.Tensor
    cross_v: torch.Tensor
    enc_mask: Optional[torch.Tensor]

    def tile(self, beams: int) -> "EncDecState":
        """The state of ``beams`` copies of each row, row-major."""
        return EncDecState(self.cross_k.repeat_interleave(beams, dim=1),
                           self.cross_v.repeat_interleave(beams, dim=1),
                           None if self.enc_mask is None
                           else self.enc_mask.repeat_interleave(beams, dim=0))


def _promoted(*xs):
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return [x.to(dt) for x in xs]


def _cross_attend(q, k, v, mask, scale: Optional[float]) -> torch.Tensor:
    """q (B, Sq, H, D) against the encoder's k/v (B, Sk, H, D), no
    causality: fp32 scores (times ``scale`` when given), ``-1e9`` where
    ``mask`` hides a key, probabilities in q's type, products in the type
    the operands promote to."""
    qq, kk = _promoted(q, k)
    scores = torch.einsum("bqhd,bkhd->bhqk", qq, kk).float()
    if scale is not None:
        scores = scores * float(np.float32(scale))
    if mask is not None:
        scores = scores.masked_fill(~mask[:, None, None, :].bool(), MASKED)
    probs, vv = _promoted(torch.softmax(scores, dim=-1).to(q.dtype), v)
    return torch.einsum("bhqk,bkhd->bqhd", probs, vv)


def _module_of(model):
    return getattr(model, "module", model)


def _cross_kv(p: dict, names: list[str], enc, heads: int):
    """Stacked (L, B, S, H, D) projections of ``enc`` by the weights (and
    biases, where a layer has one) ``names``, in ``enc``'s type; this
    rank's heads under ``tp``, as the rule tables split them."""
    return torch.stack([_proj(p, n, enc, heads) for n in names])


@torch.no_grad()
def _t5_encode(cfg, model, input_ids) -> EncDecState:
    """The module's encoder (``T5ForConditionalGeneration.encode``: the key
    mask from ``pad_token_id``), then every decoder layer's cross K/V."""
    module = _module_of(model)
    ids = torch.as_tensor(input_ids).to(module.shared.weight.device).long()
    enc, mask = module.encode(ids)
    p = dict(module.named_parameters())
    layers = [f"decoder.block_{i}.cross_attn." for i in range(cfg.n_dec)]
    return EncDecState(_cross_kv(p, [n + "k" for n in layers], enc, cfg.num_heads),
                       _cross_kv(p, [n + "v" for n in layers], enc, cfg.num_heads), mask)


def _t5_self_bias(cfg, table, q_positions, t_max: int) -> torch.Tensor:
    """Causal relative-position bias of the queries against the whole cache
    axis: (B, H, Sq, T) fp32 from the (buckets, H) table."""
    kv_pos = torch.arange(t_max, device=q_positions.device)
    buckets = relative_position_bucket(
        kv_pos[None, None, :] - q_positions[:, :, None], bidirectional=False,
        num_buckets=cfg.relative_attention_num_buckets,
        max_distance=cfg.relative_attention_max_distance)
    return F.embedding(buckets, table).permute(0, 3, 1, 2).float()


@torch.no_grad()
def _t5_decode(cfg, model_or_params, input_ids, cache: KVCache, enc: EncDecState,
               return_all=False):
    """The cached T5 decoder: ``block_0``'s relative bias for every layer,
    no 1/sqrt(d) scale, scores and softmax in fp32, the tied head with the
    ``d_model ** -0.5`` scale."""
    p = _decode_params(model_or_params)
    b, s = input_ids.shape
    eps, nh, t_max = cfg.layer_norm_epsilon, cfg.num_heads, cache.k.shape[2]
    start = cache.length
    positions = _row_positions(start, b, s)
    y = tp.embedding(input_ids.long(), p["shared.weight"]).to(cfg.dtype)
    self_bias = _t5_self_bias(
        cfg, p["decoder.block_0.self_attn.relative_attention_bias.weight"], positions, t_max)
    q0 = p["decoder.block_0.self_attn.q.weight"]
    if tp.is_split(q0):  # the bias table is whole: this rank's heads of it
        local = nh // q0.device_mesh.size()
        first = q0.device_mesh.get_local_rank() * local
        self_bias = self_bias[:, first:first + local]
    visible = _attend_mask(positions, t_max)

    def rms(h, name):
        return t5_rms(h, p[name + ".weight"].to(h.dtype), eps)

    for i in range(cfg.n_dec):
        pre = f"decoder.block_{i}."
        hn = rms(y, pre + "ln0")
        q, k_new, v_new = (_proj(p, f"{pre}self_attn.{n}", hn, nh) for n in "qkv")
        ck = _cache_write(cache.k[i], k_new, start)
        cv = _cache_write(cache.v[i], v_new, start)
        qq, kk, vv = _promoted(q, ck, cv)
        scores = torch.einsum("bqhd,bkhd->bhqk", qq, kk).float() + self_bias
        probs = torch.softmax(scores.masked_fill(~visible[:, None], MASKED), dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", probs.to(qq.dtype), vv)
        y = y + _dense(p, pre + "self_attn.o", out.reshape(b, s, -1))
        hn = rms(y, pre + "ln1")
        q = _proj(p, pre + "cross_attn.q", hn, nh)
        out = _cross_attend(q, enc.cross_k[i], enc.cross_v[i], enc.enc_mask, None)
        y = y + _dense(p, pre + "cross_attn.o", out.reshape(b, s, -1))
        hn = rms(y, pre + "ln2")
        y = y + _dense(p, pre + "ffn.wo", F.relu(_dense(p, pre + "ffn.wi", hn)))
    y = rms(y, "decoder.final_ln")
    y = y * as_dtype(cfg.d_model ** -0.5, y.dtype)
    logits = _head(y, p["shared.weight"], cfg.dtype, return_all)
    return logits, KVCache(cache.k, cache.v, start + s)


@torch.no_grad()
def _whisper_encode(cfg, model, input_features) -> EncDecState:
    """The module's encoder on (B, T, mel) features, then every decoder
    layer's cross K (no bias) and V (with its bias)."""
    module = _module_of(model)
    weight = module.encoder.conv1.weight
    enc = module.encoder(torch.as_tensor(input_features).to(weight.device))
    p = dict(module.named_parameters())
    layers = [f"decoder.layers.{i}.encoder_attn." for i in range(cfg.decoder_layers)]
    heads = cfg.decoder_attention_heads
    return EncDecState(_cross_kv(p, [n + "k_proj" for n in layers], enc, heads),
                       _cross_kv(p, [n + "v_proj" for n in layers], enc, heads), None)


@torch.no_grad()
def _whisper_decode(cfg, model_or_params, input_ids, cache: KVCache, enc: EncDecState,
                    return_all=False):
    """The cached Whisper decoder: pre-LN blocks (the JAX plans'
    ``_layer_norm``), learned positions, biased q/v and unbiased k
    projections, 1/sqrt(d) in both attentions, the tied head."""
    p = _decode_params(model_or_params)
    b, s = input_ids.shape
    eps, nh = cfg.layer_norm_eps, cfg.decoder_attention_heads
    start = cache.length
    positions = _row_positions(start, b, s)
    y = (tp.embedding(input_ids.long(), p["decoder.embed_tokens.weight"]).to(cfg.dtype)
         + F.embedding(positions, p["decoder.embed_positions.weight"]).to(cfg.dtype))
    scale = 1.0 / np.sqrt(cfg.decoder_head_dim)

    def block(i, y, attend):
        pre = f"decoder.layers.{i}."
        hn = _layer_norm(y, p, pre + "self_attn_layer_norm", eps)
        q, k, v = (_proj(p, f"{pre}self_attn.{n}_proj", hn, nh) for n in "qkv")
        y = y + _dense(p, pre + "self_attn.out_proj", attend(i, q, k, v).reshape(b, s, -1))
        hn = _layer_norm(y, p, pre + "encoder_attn_layer_norm", eps)
        q = _proj(p, pre + "encoder_attn.q_proj", hn, nh)
        out = _cross_attend(q, enc.cross_k[i], enc.cross_v[i], None, scale)
        y = y + _dense(p, pre + "encoder_attn.out_proj", out.reshape(b, s, -1))
        hn = _layer_norm(y, p, pre + "final_layer_norm", eps)
        return y + _dense(p, pre + "fc2", F.gelu(_dense(p, pre + "fc1", hn)))

    y = _cached_layers(y, cache, positions, None, cfg.decoder_layers, block)
    y = _layer_norm(y, p, "decoder.layer_norm", eps)
    logits = _head(y, p["decoder.embed_tokens.weight"], cfg.dtype, return_all)
    return logits, KVCache(cache.k, cache.v, start + s)


# module class name -> (encode(cfg, model, encoder inputs) -> EncDecState,
#                       decode(cfg, params, ids, cache, enc_state, return_all=False))
ENCDEC_GENERATION_PLANS: dict[str, tuple] = {
    "T5ForConditionalGeneration": (_t5_encode, _t5_decode),
    "WhisperForConditionalGeneration": (_whisper_encode, _whisper_decode),
}


def register_encdec_generation_plan(module_class_name: str, encode_fn, decode_fn) -> None:
    """Make ``(encode_fn, decode_fn)`` the plan of every module of that
    class name (the signatures of ``ENCDEC_GENERATION_PLANS``' entries)."""
    ENCDEC_GENERATION_PLANS[module_class_name] = (encode_fn, decode_fn)


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------


def _filter_logits(logits, *, temperature, top_k: Optional[int] = None,
                   top_p: Optional[float] = None):
    """Temperature, then top-k (ties with the k-th logit stay), then top-p
    (the smallest prefix whose mass reaches ``top_p``, at least one token)."""
    logits = logits / temperature
    if top_k is not None:
        top_k = min(top_k, logits.shape[-1])
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = logits.masked_fill(logits < kth, -float("inf"))
    if top_p is not None:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        cutoff_idx = (cum < top_p).sum(dim=-1).clamp(max=logits.shape[-1] - 1)
        cutoff = sorted_logits.gather(-1, cutoff_idx[:, None])
        logits = logits.masked_fill(logits < cutoff, -float("inf"))
    return logits


def sample_logits(logits, generator: Optional[torch.Generator] = None, *, temperature=1.0,
                  top_k: Optional[int] = None, top_p: Optional[float] = None):
    """(B, V) fp32 logits → (B,) token ids. ``temperature`` <= 0 (or None)
    is greedy argmax; otherwise a Gumbel-max draw from the filtered
    distribution with ``generator`` (default: seeded 0 on the logits'
    device)."""
    if temperature is None or temperature <= 0:
        return torch.argmax(logits, dim=-1)
    logits = _filter_logits(logits, temperature=temperature, top_k=top_k, top_p=top_p)
    if generator is None:
        generator = torch.Generator(device=logits.device).manual_seed(0)
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    return torch.argmax(logits + gumbel, dim=-1)


# ---------------------------------------------------------------------------
# generate
# ---------------------------------------------------------------------------

# module class name -> forward_cached(cfg, params, ids, cache, ...)
GENERATION_PLANS: dict[str, Callable] = {
    "LlamaForCausalLM": _llama_forward_cached,
    "MixtralForCausalLM": _llama_forward_cached,
    "GPT2LMHeadModel": _gpt2_forward_cached,
    "OPTForCausalLM": _opt_forward_cached,
    "GPTNeoXForCausalLM": _neox_forward_cached,
}


def register_generation_plan(module_class_name: str, fn: Callable) -> None:
    """Make ``fn(cfg, params, input_ids, cache, return_all=False,
    pad_offset=None, kv_valid=None) -> (fp32 logits, cache)`` the plan of
    every module of that class name (``params``: state-dict names →
    tensors)."""
    GENERATION_PLANS[module_class_name] = fn


def _generation_plan(module, forward_cached: Optional[Callable] = None) -> Callable:
    """``forward_cached`` when given (it outranks the registry, as in the
    JAX package), else the plan of the module's class."""
    if forward_cached is not None:
        return forward_cached
    # FSDP2 gives a sharded module a subclass of its own class.
    fwd = next((GENERATION_PLANS[c.__name__] for c in type(module).__mro__
                if c.__name__ in GENERATION_PLANS), None)
    if fwd is None:
        known = ", ".join(sorted(GENERATION_PLANS) + sorted(ENCDEC_GENERATION_PLANS))
        raise ValueError(f"No generation plan for {type(module).__name__!r}; built-in: {known}")
    return fwd


def _is_encdec(module, forward_cached=None) -> bool:
    return forward_cached is None and type(module).__name__ in ENCDEC_GENERATION_PLANS


def _resolve_plan(model, inputs, decoder_input_ids=None, forward_cached=None, beams=1):
    """``(prompt ids, forward)``. An encoder-decoder module runs its encoder
    once on ``inputs``; the prompt is ``decoder_input_ids`` (default: one
    ``decoder_start_token_id`` a row) and the forward is its decoder with
    the encoded state bound in, picked by the call's batch size (beam
    search sees B rows at the prefill and B × ``beams`` after it). Any
    other module: ``inputs`` and its causal plan (``forward_cached`` when
    given, which outranks the registries, as in the JAX package)."""
    module = _module_of(model)
    if not _is_encdec(module, forward_cached):
        if decoder_input_ids is not None:
            raise ValueError(f"decoder_input_ids is for encoder-decoder modules "
                             f"({', '.join(sorted(ENCDEC_GENERATION_PLANS))}), not "
                             f"{type(module).__name__!r}")
        return inputs, _generation_plan(module, forward_cached)
    encode_fn, decode_fn = ENCDEC_GENERATION_PLANS[type(module).__name__]
    cfg = module.config
    enc = encode_fn(cfg, model, inputs)
    rows, device = enc.cross_k.shape[1], enc.cross_k.device
    if decoder_input_ids is None:
        decoder_input_ids = torch.full((rows, 1), getattr(cfg, "decoder_start_token_id", 0),
                                       dtype=torch.long, device=device)
    states = {rows: enc}
    if beams > 1:
        states[rows * beams] = enc.tile(beams)

    def fwd(cfg, params, ids, cache, return_all=False):
        return decode_fn(cfg, params, ids, cache, states[ids.shape[0]], return_all)

    return torch.as_tensor(decoder_input_ids).to(device), fwd


def _params_device(params: dict) -> torch.device:
    return next(v.device for v in params.values() if torch.is_tensor(v))


@dataclasses.dataclass
class GenerationConfig:
    """Bundled sampling settings; ``generate(..., config=GenerationConfig(...))``
    uses these as defaults, explicit keyword arguments win."""

    max_new_tokens: int = 32
    temperature: float = 0.0        # 0 → greedy
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    eos_token_id: Optional[int] = None
    pad_token_id: Optional[int] = None  # finished rows get this (default: eos)
    suppress_tokens: Optional[tuple] = None        # never sampled
    begin_suppress_tokens: Optional[tuple] = None  # not at the first new token
    forced_decoder_ids: Optional[tuple] = None     # ((position, token), ...)


def ladder_bucket(n: int, ladder) -> Optional[int]:
    """Smallest ladder rung >= ``n``, or ``None`` when ``n`` overshoots the
    ladder (``accelerate_tpu/compile_manager.py:ladder_bucket``)."""
    for b in sorted(int(x) for x in ladder):
        if n <= b:
            return b
    return None


def _bucketed_prompt_len(s: int, seq_buckets) -> int:
    """Prompt length rounded up the ``seq_buckets`` ladder; a length past
    the ladder keeps its size."""
    if seq_buckets:
        bucketed = ladder_bucket(s, seq_buckets)
        return int(bucketed) if bucketed is not None else s
    return s


def clear_generation_cache() -> None:
    """Kept for the JAX package's name: eager generation memoizes no
    compiled loop, so there is nothing to drop."""


def _pick(explicit, default):
    return explicit if explicit is not None else default


@torch.no_grad()
def generate(
    model,
    input_ids,
    max_new_tokens: Optional[int] = None,
    *,
    temperature: Optional[float] = None,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    eos_token_id: Optional[int] = None,
    pad_token_id: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    forward_cached: Optional[Callable] = None,
    config: Optional[GenerationConfig] = None,
    decoder_input_ids=None,
    attention_mask=None,
    suppress_tokens=None,
    begin_suppress_tokens=None,
    forced_decoder_ids=None,
    seq_buckets=None,
    compile_manager=None,
) -> torch.Tensor:
    """Generate ``max_new_tokens`` continuations of ``input_ids`` (B, S)
    with ``model`` (a ``Model``, a module with a generation plan or a
    decode-quantized model) on the device that holds its parameters.
    Returns (B, S + max_new_tokens) on that device.

    Encoder-decoder modules (T5, Whisper): ``input_ids`` feed the encoder
    (token ids, or Whisper's (B, T, mel) features), which runs once, and
    the loop continues ``decoder_input_ids`` (default: one
    ``decoder_start_token_id`` a row); the result is the decoder's
    sequence.

    ``attention_mask`` (B, S): left-padded rows (zeros, then ones); RoPE
    positions shift per row so content starts at 0 and pad slots never
    enter attention. After a row emits ``eos_token_id`` it is padded with
    ``pad_token_id`` (default: the EOS id). ``suppress_tokens`` are never
    sampled, ``begin_suppress_tokens`` not as the first new token, and
    ``forced_decoder_ids`` ((position, token), ...) force a token at an
    absolute position. ``seq_buckets`` left-pads the prompt up a ladder of
    lengths; the output keeps the caller's prompt columns.

    The decode loop runs all ``max_new_tokens`` steps and reads nothing
    back to the host."""
    if compile_manager is not None:
        raise NotImplementedError(f"generate(compile_manager=...) is not ported yet "
                                  f"({_COMPILE_MANAGER_ITEM})")
    gc = config or GenerationConfig()
    max_new_tokens = _pick(max_new_tokens, gc.max_new_tokens)
    temperature = _pick(temperature, gc.temperature)
    top_k, top_p = _pick(top_k, gc.top_k), _pick(top_p, gc.top_p)
    eos_token_id = _pick(eos_token_id, gc.eos_token_id)
    pad_token_id = _pick(_pick(pad_token_id, gc.pad_token_id), eos_token_id)
    suppress_tokens = _pick(suppress_tokens, gc.suppress_tokens)
    begin_suppress_tokens = _pick(begin_suppress_tokens, gc.begin_suppress_tokens)
    forced_decoder_ids = _pick(forced_decoder_ids, gc.forced_decoder_ids)

    module = _module_of(model)
    cfg = module.config
    encdec = _is_encdec(module, forward_cached)
    if encdec and attention_mask is not None:
        raise ValueError("encoder-decoder generation takes no attention_mask: the encoder's "
                         "mask comes from pad_token_id")
    input_ids, fwd = _resolve_plan(model, input_ids, decoder_input_ids, forward_cached)
    params = _decode_params(model)
    device = _params_device(params)

    orig_input_ids = torch.as_tensor(input_ids).to(device)
    ids = orig_input_ids.long()
    b, s = ids.shape
    mask_np = None if attention_mask is None else np.asarray(
        attention_mask.cpu() if torch.is_tensor(attention_mask) else attention_mask, np.int32)

    s_b = s if encdec else _bucketed_prompt_len(s, seq_buckets)
    if s_b > s:
        fill = pad_token_id if pad_token_id is not None else 0
        ids = torch.cat([torch.full((b, s_b - s), fill, dtype=ids.dtype, device=device), ids], 1)
        if mask_np is None:
            mask_np = np.ones((b, s), np.int32)
        mask_np = np.concatenate([np.zeros((b, s_b - s), np.int32), mask_np], axis=1)
        s = s_b

    t_max = s + max_new_tokens
    max_pos = _cache_dims(cfg)[3]
    if t_max > max_pos:
        raise ValueError(f"{t_max} tokens exceeds max_position_embeddings={max_pos}")
    if generator is None and temperature is not None and temperature > 0:
        generator = torch.Generator(device=device).manual_seed(0)

    kwargs = {}
    if mask_np is not None:
        off_np = np.argmax(mask_np, axis=1).astype(np.int64)  # leading pads per row
        if not np.all(off_np + mask_np.sum(axis=1) == s):
            raise ValueError(
                "attention_mask must be left-padded (zeros then ones per row) for "
                "decoder-only generation; got a right-padded or non-contiguous mask.")
        kv_valid = np.concatenate([mask_np.astype(bool), np.ones((b, t_max - s), bool)], 1)
        kwargs = {"pad_offset": torch.from_numpy(off_np).to(device),
                  "kv_valid": torch.from_numpy(kv_valid).to(device)}

    forced = None
    if forced_decoder_ids:
        forced = {pos - s: int(tok) for pos, tok in forced_decoder_ids
                  if s <= pos < s + max_new_tokens}
    neg_inf = float(np.finfo(np.float32).min)

    cache = init_cache(cfg, b, t_max, device=device, kv_heads=_tp_kv_heads(cfg, params))
    logits, cache = fwd(cfg, params, ids, cache, **kwargs)
    if begin_suppress_tokens:
        logits[:, list(begin_suppress_tokens)] = neg_inf
    done = torch.zeros((b,), dtype=torch.bool, device=device)
    toks = torch.empty((max_new_tokens, b), dtype=torch.long, device=device)
    for t in range(max_new_tokens):
        if suppress_tokens:
            logits[:, list(suppress_tokens)] = neg_inf
        tok = sample_logits(logits, generator, temperature=temperature, top_k=top_k,
                            top_p=top_p)
        if forced and t in forced:
            tok = torch.full_like(tok, forced[t])
        if eos_token_id is not None:
            tok = torch.where(done, pad_token_id, tok)
            done = done | (tok == eos_token_id)
        toks[t] = tok
        if t + 1 < max_new_tokens:  # the last token's forward would feed nothing
            logits, cache = fwd(cfg, params, tok[:, None], cache, **kwargs)
    return torch.cat([orig_input_ids, toks.T.to(orig_input_ids.dtype)], dim=1)


# ---------------------------------------------------------------------------
# Speculative decoding and beam search
# ---------------------------------------------------------------------------


@torch.no_grad()
def speculative_generate(model, draft_model, input_ids, max_new_tokens: int = 32, *,
                         num_draft_tokens: int = 4,
                         eos_token_id: Optional[int] = None) -> torch.Tensor:
    """Greedy speculative decoding, batch 1: the draft proposes
    ``num_draft_tokens`` tokens greedily through its own cache, one cached
    target pass over that window scores every position, and the longest
    agreeing prefix is kept with the target's token after it. The result
    is the target's greedy continuation (equal to :func:`generate` but
    where the top-2 logits sit within the window's rounding); the draft
    changes only how many target passes it takes.

    Both caches are indexed by position, so after a rejection each rewinds
    its length to the accepted prefix and the next write overwrites the
    stale rows. Returns (1, S + max_new_tokens) on the target's device."""
    if num_draft_tokens < 1:
        raise ValueError(f"num_draft_tokens must be >= 1, got {num_draft_tokens}")
    module, dmodule = getattr(model, "module", model), getattr(draft_model, "module", draft_model)
    cfg, dcfg = module.config, dmodule.config
    fwd, dfwd = _generation_plan(module), _generation_plan(dmodule)
    params, dparams = _decode_params(model), _decode_params(draft_model)
    device = _params_device(params)
    input_ids = torch.as_tensor(input_ids).to(device)
    b, s = input_ids.shape
    if b != 1:
        raise ValueError("speculative_generate supports batch size 1")
    k = num_draft_tokens
    t_max = s + max_new_tokens + k + 1
    if t_max > min(_cache_dims(cfg)[3], _cache_dims(dcfg)[3]):
        raise ValueError("sequence would exceed max positions")

    out = input_ids.long()
    tlogits, tcache = fwd(cfg, params, out, init_cache(cfg, b, t_max, device=device))
    dlogits, dcache = dfwd(dcfg, dparams, out, init_cache(dcfg, b, t_max, device=device))
    produced = 0
    while produced < max_new_tokens:
        proposals, dl, dc = [], dlogits, dcache
        for _ in range(k):
            tok = torch.argmax(dl, dim=-1)
            proposals.append(tok)
            dl, dc = dfwd(dcfg, dparams, tok[:, None], dc)
        prop = torch.stack(proposals, dim=1)  # (1, k)
        # Window position j predicts the token after proposal j; the
        # carried ``tlogits`` predicts the first.
        win_logits, tc = fwd(cfg, params, prop, tcache, return_all=True)
        pred_tok = torch.argmax(torch.cat([tlogits[:, None], win_logits], dim=1), dim=-1)
        agree = (pred_tok[0, :k] == prop[0]).cpu().numpy()
        n_accept = int(np.argmin(agree)) if not agree.all() else k
        new_toks = torch.cat([prop[:, :n_accept], pred_tok[:, n_accept:n_accept + 1]],
                             dim=1)[:, :max_new_tokens - produced]
        out = torch.cat([out, new_toks], dim=1)
        produced += new_toks.shape[1]
        if eos_token_id is not None and bool((new_toks == eos_token_id).any()):
            new = out[0, s:]
            first = int(torch.argmax((new == eos_token_id).int()))
            new[first + 1:] = eos_token_id
            break
        if produced >= max_new_tokens:
            break
        # Rewind both caches to the accepted prefix minus its last token and
        # feed that token again: its row is the only stale one, and the
        # carried logits come fresh.
        rewind = torch.tensor(out.shape[1] - 1, dtype=torch.long, device=device)
        tlogits, tcache = fwd(cfg, params, out[:, -1:], KVCache(tc.k, tc.v, rewind))
        dlogits, dcache = dfwd(dcfg, dparams, out[:, -1:], KVCache(dc.k, dc.v, rewind))

    if out.shape[1] < s + max_new_tokens:  # EOS ended the loop early
        pad = eos_token_id if eos_token_id is not None else 0
        out = torch.cat([out, out.new_full((1, s + max_new_tokens - out.shape[1]), pad)], dim=1)
    return out[:, :s + max_new_tokens].to(input_ids.dtype)


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest values of each row and their indices, equal values
    in index order (``lax.top_k``'s order)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[:, :k], indices[:, :k]


@torch.no_grad()
def beam_search(model, input_ids, max_new_tokens: int = 32, *, num_beams: int = 4,
                length_penalty: float = 1.0, eos_token_id: Optional[int] = None,
                forward_cached: Optional[Callable] = None,
                decoder_input_ids=None) -> torch.Tensor:
    """Length-normalised beam search (score ``logprob_sum /
    len**length_penalty``) over the cached forward of :func:`generate`.
    The prompt prefills once per row, the cache is tiled to
    ``B × num_beams`` and reordered along the beam axis every step, and
    each step keeps the best ``num_beams`` of ``num_beams × V`` candidates.
    A beam that emits ``eos_token_id`` freezes: its score stops growing and
    its later tokens are EOS. Returns the best sequence of each row,
    (B, S + max_new_tokens). Encoder-decoder modules follow
    :func:`generate`'s contract (the encoder runs once and its state is
    tiled along the beams; the result is the decoder's sequence)."""
    cfg = _module_of(model).config
    input_ids, fwd = _resolve_plan(model, input_ids, decoder_input_ids, forward_cached,
                                   beams=num_beams)
    params = _decode_params(model)
    device = _params_device(params)
    input_ids = torch.as_tensor(input_ids).to(device)
    b, s = input_ids.shape
    k = num_beams
    t_max = s + max_new_tokens
    max_pos = _cache_dims(cfg)[3]
    if t_max > max_pos:
        raise ValueError(f"{t_max} tokens exceeds max_position_embeddings={max_pos}")

    logits, cache = fwd(cfg, params, input_ids.long(), init_cache(cfg, b, t_max, device=device))
    cand_logp = torch.log_softmax(logits, dim=-1)[:, None, :].expand(b, k, -1)
    v = cand_logp.shape[-1]
    cache = KVCache(cache.k.repeat_interleave(k, dim=1), cache.v.repeat_interleave(k, dim=1),
                    cache.length)
    # Beam 0 carries the prompt; the others start dead, so the first step
    # picks k distinct tokens from beam 0's distribution.
    scores = torch.full((b, k), -float("inf"), device=device)
    scores[:, 0] = 0.0
    done = torch.zeros((b, k), dtype=torch.bool, device=device)
    lengths = torch.zeros((b, k), dtype=torch.long, device=device)
    tokens = torch.zeros((b, k, max_new_tokens), dtype=torch.long, device=device)
    not_first = torch.arange(v, device=device) != 0
    row_base = torch.arange(b, device=device)[:, None] * k
    for t in range(max_new_tokens):
        # A frozen beam continues through its slot 0 only, at its score.
        cand = scores[..., None] + torch.where(done[..., None], 0.0, cand_logp)
        cand = cand.masked_fill(done[..., None] & not_first, -float("inf"))
        scores, top_idx = _top_k(cand.reshape(b, k * v), k)
        beam_idx, tok = top_idx // v, top_idx % v
        was_done = done.gather(1, beam_idx)
        lengths = lengths.gather(1, beam_idx)
        tokens = tokens.gather(1, beam_idx[..., None].expand(-1, -1, max_new_tokens))
        emit = torch.where(was_done, eos_token_id if eos_token_id is not None else 0, tok)
        tokens[:, :, t] = emit
        lengths = torch.where(was_done, lengths, lengths + 1)
        done = was_done | (emit == eos_token_id) if eos_token_id is not None else was_done
        flat_beam = (row_base + beam_idx).reshape(-1)
        cache = KVCache(cache.k.index_select(1, flat_beam), cache.v.index_select(1, flat_beam),
                        cache.length)
        if t + 1 < max_new_tokens:
            logits, cache = fwd(cfg, params, emit.reshape(b * k, 1), cache)
            cand_logp = torch.log_softmax(logits, dim=-1).reshape(b, k, v)

    final = scores / lengths.clamp_min(1).float() ** length_penalty
    best = torch.argmax(final, dim=1)
    best_tokens = tokens[torch.arange(b, device=device), best]
    return torch.cat([input_ids, best_tokens.to(input_ids.dtype)], dim=1)
