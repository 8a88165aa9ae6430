"""Long-context generation over the ``cp`` axis: flash-decoding over the
processes of the ring (counterpart of ``accelerate_tpu/cp_generation.py``).

- **Prefill**: each process runs its ``S/cp`` slice of the prompt through
  every layer with its global positions, attending over the whole prompt
  through ``parallel/cp.py``'s ``ring_attention`` (one process on the
  axis: the flash forward kernel, once a layer). Its slice of every
  layer's K and V, ``(L, B, S/cp, Hkv, D)``, is kept as the **prefix
  cache**, so a prompt ``cp`` times longer than one card's memory holds
  fits. The last position's hidden state, on the last ``cp`` rank, reaches
  every rank through a small all_gather.
- **Decode**: each step's query takes the online-softmax partials (acc, m,
  l) against the local prefix, merged over ``cp`` with an all_reduce MAX
  and two SUMs, then the partials against a replicated **tail cache** of
  the generated tokens (masked past step ``t + 1``), merged exactly.

The contract is the JAX one: every process passes the whole (B, S) prompt
and gets back the whole (B, S + max_new_tokens); S must divide by ``cp``;
batch rows split over the data-parallel axes when B divides by their size
and are replicated otherwise. A sampled token is drawn on the first rank of
the processes that share its rows and broadcast, so every rank returns the
same tokens.

Unlike the JAX ``cp_generate``, which skips several knobs of the decoder
chassis that its ``generate`` applies (``residual_multiplier``,
``logits_scaling``, ``norm_type="layernorm"``, a partial ``rotary_dim``,
``attention_multiplier``, the ``o_proj`` bias), this one runs the whole
chassis through ``generation.py``'s block helpers, so that its greedy
tokens are ``generate``'s for every chassis config. A Mixtral is refused:
the JAX ``cp_generate`` has no MoE path (its prefill and decode loop read
each layer's ``mlp``, ``accelerate_tpu/cp_generation.py:191`` and
``:242``, which a Mixtral block has not), and the port adds no feature the
reference lacks.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .generation import (
    _chassis_norm,
    _decode_params,
    _dense,
    _mlp,
    _params_device,
    _qkv_proj,
    sample_logits,
)
from .models.llama import embed_tokens, rotary_embedding, scale_logits, scale_residual
from .ops.flash_attention import attention_stats
from .parallel.cp import mesh_axis, ring_attention

_DP_AXES = ("dp_replicate", "dp_shard")


def clear_cp_generation_cache() -> None:
    """Kept for the JAX package's name: eager generation memoizes no
    compiled loop, so there is nothing to drop."""


def _gather_seq(ids: torch.Tensor, cp: int, group) -> torch.Tensor:
    """(B, S/cp) slices of the ``cp`` ranks → (B, S), in rank order."""
    if cp == 1:
        return ids
    parts = [torch.empty_like(ids) for _ in range(cp)]
    dist.all_gather(parts, ids.contiguous(), group=group)
    return torch.cat(parts, dim=1)


def _last_position(x: torch.Tensor, cp: int, group) -> torch.Tensor:
    """(B, S/cp, E) slices → (B, E) at the last global position, on every
    rank: an all_gather of each rank's last row, the last rank's kept."""
    last = x[:, -1].contiguous()
    if cp == 1:
        return last
    parts = [torch.empty_like(last) for _ in range(cp)]
    dist.all_gather(parts, last, group=group)
    return parts[-1]


def _prefix_stats_sharded(q, pk, pv, cp: int, group):
    """Flash-decoding partials of q against the ``cp``-sharded prefix:
    local stats, then the exact online-softmax merge over ``cp`` (disjoint
    key sets, :func:`_merge_stats`'s combination) as a MAX and two SUMs."""
    acc, m, l = attention_stats(q, pk, pv, causal=False)
    if cp == 1:
        return acc, m, l
    m_g = m.clone()
    dist.all_reduce(m_g, op=dist.ReduceOp.MAX, group=group)
    w = torch.exp(m - m_g)
    l_g = l * w
    acc_g = acc * w[..., None]
    dist.all_reduce(l_g, group=group)
    dist.all_reduce(acc_g, group=group)
    return acc_g, m_g, l_g


def _merge_stats(parts) -> torch.Tensor:
    """Exact combination of disjoint-key-set online-softmax partials:
    (B, Sq, H, D) fp32."""
    m = parts[0][1]
    for _, mi, _ in parts[1:]:
        m = torch.maximum(m, mi)
    l = sum(li * torch.exp(mi - m) for _, mi, li in parts)
    acc = sum(ai * torch.exp(mi - m)[..., None] for ai, mi, _ in parts)
    out = acc / l.clamp_min(1e-30)[..., None]  # (B, H, Sq, D)
    return out.transpose(1, 2)


def _head(cfg, p: dict, h: torch.Tensor) -> torch.Tensor:
    """fp32 logits of the final hidden states ``h`` (B, E)."""
    head = p["model.embed_tokens.weight"] if cfg.tie_word_embeddings else p["lm_head.weight"]
    return scale_logits(F.linear(h, head.to(cfg.dtype)), cfg.logits_scaling).float()


def _layer_rest(cfg, p: dict, pre: str, x, out):
    """A layer after its attention output ``out`` (B, S, H, D): ``o_proj``,
    the residuals (times ``residual_multiplier``) and the MLP."""
    b, s = out.shape[:2]
    rm = cfg.residual_multiplier
    x = x + scale_residual(_dense(p, pre + "self_attn.o_proj", out.reshape(b, s, -1)), rm)
    hn = _chassis_norm(cfg, p, pre + "post_attention_layernorm", x)
    return x + scale_residual(_mlp(cfg, p, pre, hn), rm)


@torch.no_grad()
def _prefill(cfg, params: dict, input_ids: torch.Tensor, mesh=None):
    """This process's slice (B, S/cp) of the prompt through every layer,
    ring attention over ``cp``. Returns (fp32 logits (B, V) of the last
    global position, on every rank; prefix K and V, (L, B, S/cp, Hkv, D)
    in the compute dtype)."""
    cp, idx, group = mesh_axis(mesh, "cp")
    b, s = input_ids.shape
    x = embed_tokens(cfg, params["model.embed_tokens.weight"], input_ids.long())
    positions = (idx * s + torch.arange(s, device=x.device)).expand(b, s)
    cos, sin = rotary_embedding(positions, cfg.rotary_dim, cfg.rope_theta, x.dtype)
    pk, pv = [], []
    for i in range(cfg.num_hidden_layers):
        pre = f"model.layers.{i}."
        hn = _chassis_norm(cfg, params, pre + "input_layernorm", x)
        q, k, v = _qkv_proj(cfg, params, pre, hn, cos, sin)
        out = ring_attention(q, k, v, causal=True, mesh=mesh)
        x = _layer_rest(cfg, params, pre, x, out.to(x.dtype))
        pk.append(k.to(cfg.dtype))
        pv.append(v.to(cfg.dtype))
    x = _chassis_norm(cfg, params, "model.norm", x)
    return _head(cfg, params, _last_position(x, cp, group)), torch.stack(pk), torch.stack(pv)


@torch.no_grad()
def _decode_loop(cfg, params: dict, first_token, prefix_k, prefix_v, max_new_tokens: int, *,
                 generator=None, temperature=None, top_k=None, top_p=None,
                 eos_token_id=None, pad_token_id=None, prompt_len: int, finished0=None,
                 mesh=None, share=None):
    """``max_new_tokens`` decode steps after ``first_token`` (at position
    ``prompt_len``): the prefix stays sharded over ``cp``, the tail cache
    of the new tokens is replicated. ``share`` ((group, source rank)):
    where a sampled token is drawn and broadcast. Returns (B, N)."""
    cp, _, group = mesh_axis(mesh, "cp")
    n_layers, b, _, hkv, d = prefix_k.shape
    tail_k = prefix_k.new_zeros((n_layers, b, max_new_tokens, hkv, d))
    tail_v = torch.zeros_like(tail_k)
    token = first_token
    finished = (finished0 if finished0 is not None
                else torch.zeros((b,), dtype=torch.bool, device=token.device))
    toks = []
    for t in range(max_new_tokens):
        x = embed_tokens(cfg, params["model.embed_tokens.weight"], token[:, None])
        pos = torch.full((b, 1), prompt_len + t, dtype=torch.long, device=x.device)
        cos, sin = rotary_embedding(pos, cfg.rotary_dim, cfg.rope_theta, x.dtype)
        for i in range(n_layers):
            pre = f"model.layers.{i}."
            hn = _chassis_norm(cfg, params, pre + "input_layernorm", x)
            q, k_new, v_new = _qkv_proj(cfg, params, pre, hn, cos, sin)
            tail_k[i, :, t] = k_new[:, 0].to(tail_k.dtype)
            tail_v[i, :, t] = v_new[:, 0].to(tail_v.dtype)
            stats_prefix = _prefix_stats_sharded(q, prefix_k[i], prefix_v[i], cp, group)
            stats_tail = attention_stats(q, tail_k[i], tail_v[i], causal=False,
                                         kv_valid_len=t + 1)
            out = _merge_stats([stats_prefix, stats_tail])
            x = _layer_rest(cfg, params, pre, x, out.to(x.dtype))
        x = _chassis_norm(cfg, params, "model.norm", x)
        nxt = _pick(_head(cfg, params, x[:, -1]), generator, temperature, top_k, top_p, share)
        if eos_token_id is not None:
            nxt = torch.where(finished, pad_token_id, nxt)
            finished = finished | (nxt == eos_token_id)
        toks.append(nxt)
        token = nxt
    if not toks:
        return first_token.new_zeros((b, 0))
    return torch.stack(toks, dim=1)


def _pick(logits, generator, temperature, top_k, top_p, share):
    """Greedy, or a token sampled on ``share``'s source rank and broadcast
    over its group, so that every process that holds the rows agrees."""
    tok = sample_logits(logits, generator, temperature=temperature, top_k=top_k, top_p=top_p)
    if temperature is not None and temperature > 0 and share is not None:
        group, src = share
        dist.broadcast(tok, src=src, group=group)
    return tok


def _data_parallel(mesh, b: int):
    """(dp size, this process's dp index, the global rank holding dp index j
    on cp = sp = 0 for each j) when the batch rows split over the mesh's
    data-parallel axes, else None (rows replicated)."""
    if mesh is None:
        return None
    names = mesh.mesh_dim_names or ()
    dp_dims = [i for i, n in enumerate(names) if n in _DP_AXES and mesh.size(i) > 1]
    dp = 1
    for i in dp_dims:
        dp *= mesh.size(i)
    if dp == 1 or b % dp:
        return None
    coord = mesh.get_coordinate()
    index = 0
    for i in dp_dims:
        index = index * mesh.size(i) + coord[i]
    owners = mesh.mesh[tuple(slice(None) if i in dp_dims else 0 for i in range(len(names)))]
    return dp, index, owners.flatten().tolist()


@torch.no_grad()
def cp_generate(model, input_ids, max_new_tokens: int, *, temperature: Optional[float] = None,
                top_k: Optional[int] = None, top_p: Optional[float] = None,
                eos_token_id: Optional[int] = None, pad_token_id: Optional[int] = None,
                generator: Optional[torch.Generator] = None, mesh=None) -> torch.Tensor:
    """Generate with the prompt's sequence split over the ``cp`` axis of
    ``mesh`` (default: the set-up ``AcceleratorState``'s; one process, or no
    cp axis: the whole prompt here).

    Every process passes the whole ``input_ids`` (B, S), S divisible by the
    cp size, and gets back (B, S + max_new_tokens) on the parameters'
    device, as :func:`generation.generate` returns them; greedy tokens are
    ``generate``'s. ``generator`` (default: seeded 0) draws sampled tokens.
    Llama-chassis models only."""
    from .state import current_mesh

    module = getattr(model, "module", model)
    if type(module).__name__ != "LlamaForCausalLM":
        raise NotImplementedError(
            f"cp_generate runs the Llama chassis, not {type(module).__name__}: the JAX "
            "cp_generate has no MoE path either (its prefill and decode read each layer's "
            "'mlp', accelerate_tpu/cp_generation.py:191 and :242); decode a Mixtral with "
            "generate")
    cfg = module.config
    params = _decode_params(model)
    device = _params_device(params)
    mesh = current_mesh() if mesh is None else mesh
    cp, idx, group = mesh_axis(mesh, "cp")
    input_ids = torch.as_tensor(input_ids).to(device)
    b, s = input_ids.shape
    if max_new_tokens <= 0:
        return input_ids.long()
    if s % cp:
        raise ValueError(f"prompt length {s} must divide by cp={cp}")
    max_pos = cfg.max_position_embeddings
    if s + max_new_tokens > max_pos:
        raise ValueError(f"prompt ({s}) + max_new_tokens ({max_new_tokens}) exceeds "
                         f"max_position_embeddings ({max_pos})")
    if pad_token_id is None:
        pad_token_id = eos_token_id if eos_token_id is not None else 0
    if generator is None and temperature is not None and temperature > 0:
        generator = torch.Generator(device=device).manual_seed(0)

    dp = _data_parallel(mesh, b)
    rows = input_ids.long()
    if dp is not None:
        size, index, _ = dp
        rows = rows[index * b // size:(index + 1) * b // size]
    chunk = s // cp
    ids = rows[:, idx * chunk:(idx + 1) * chunk]
    share = None
    if dist.is_initialized() and dist.get_world_size() > 1:
        share = ((group, dist.get_global_rank(group, 0)) if dp is not None and cp > 1
                 else (None, 0) if dp is None else None)

    logits0, pk, pv = _prefill(cfg, params, ids, mesh)
    first = _pick(logits0, generator, temperature, top_k, top_p, share)
    finished0 = None
    if eos_token_id is not None:
        finished0 = first == eos_token_id
    rest = _decode_loop(cfg, params, first, pk, pv, max_new_tokens - 1, generator=generator,
                        temperature=temperature, top_k=top_k, top_p=top_p,
                        eos_token_id=eos_token_id, pad_token_id=pad_token_id,
                        prompt_len=s, finished0=finished0, mesh=mesh, share=share)
    out = torch.cat([_gather_seq(ids, cp, group), first[:, None], rest], dim=1)
    if dp is None:
        return out
    parts = [torch.empty_like(out) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, out.contiguous())
    return torch.cat([parts[r] for r in dp[2]], dim=0)
