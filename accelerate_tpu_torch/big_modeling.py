"""Big-model inference: load and run models larger than one card's memory
(counterpart of ``accelerate_tpu/big_modeling.py``).

Layer streaming, as in the JAX package:

- parameters live where the device map put them: on a GPU, in pinned host
  memory (``"cpu"``) or in the disk store (``"disk"``, memmaps of
  ``utils/offload.py``); the map and the sizes are in the JAX package's
  flax names (``utils/modeling.py``);
- a forward walks the family's stream spec: segments for the embedding and
  the head, and the stack of identical blocks, of which at most two are on
  the card at once. Block *i* runs as the family's own block module through
  ``torch.func.functional_call`` on the streamed tensors (the JAX
  package's ``block.apply({"params": p}, ...)``), while block *i+1*'s
  weights are copied host to device with ``non_blocking=True`` on a side
  CUDA stream. The compute stream waits on the copy's event, and
  ``record_stream`` keeps each copied buffer alive until the block that
  read it has run; before block *i+1* is fetched the host waits for block
  *i-1*'s compute, so that its buffers are free again and no more than two
  blocks are ever resident. A disk leaf goes memmap → pinned staging
  buffer (where its layout changes to the port's) → device. Host tensors
  are pinned when placed; where pinning is refused, the copy from
  pageable memory is synchronous, and ``utils/modeling.py`` warns.
- Each spec computes what the family's resident module computes: the
  embedding, the norms and the head are the module's own submodules (or
  the module file's own functions) with every chassis knob applied
  (Granite's ``embedding_multiplier`` and ``logits_scaling``, a
  ``layernorm`` chassis, Gemma's ``rms_norm_plus_one`` and
  ``scale_embeddings``), where the JAX package's Llama spec builds its own
  embedding, RMSNorm and head and drops three of them.

Models whose class has no spec fall back to materialising every parameter
on the execution device for the call, with one warning per class.
"""

from __future__ import annotations

import contextlib
import inspect
import logging
from typing import Any, Callable, Mapping, Optional

import torch
import torch.nn.functional as F
from torch.func import functional_call

from .model import Model
from .utils.modeling import (
    _DiskHandle,
    _leaves,
    _pinned_copy,
    check_device_map,
    compute_abstract_params,
    default_execution_device,
    get_balanced_memory,
    get_max_memory,
    infer_auto_device_map,
    load_checkpoint_in_model,
    normalize_device_map,
    placement_for,
    placement_key,
)
from .utils.offload import offload_weight, save_offload_index

__all__ = [
    "init_empty_weights",
    "init_on_device",
    "cpu_offload",
    "cpu_offload_with_hook",
    "disk_offload",
    "dispatch_model",
    "load_checkpoint_and_dispatch",
    "DispatchedModel",
    "LayerSeg",
    "ParamResolver",
    "Seg",
    "UserCpuOffloadHook",
    "register_stream_plan",
    "register_stream_spec",
]


def init_on_device(device):
    """Context in which modules create their parameters on ``device``
    (``torch.device`` as a context manager); ``"meta"`` allocates
    nothing."""
    return torch.device(device)


def init_empty_weights(module=None, *sample_args, rng=None, **sample_kwargs):
    """With a module: its abstract parameters (``compute_abstract_params``:
    the flax tree of meta tensors, as the JAX package's returns
    ``ShapeDtypeStruct``s). Without one: a context in which modules are
    built on ``meta``."""
    if module is None:
        return init_on_device("meta")
    return compute_abstract_params(module, *sample_args, rng=rng, **sample_kwargs)


# ---------------------------------------------------------------------------
# The resolver: groups of parameters fetched to the execution device
# ---------------------------------------------------------------------------


def _nbytes(v) -> int:
    if isinstance(v, _DiskHandle):
        return v.nbytes
    return v.numel() * v.element_size()


class ParamResolver:
    """Fetches groups of parameters (every name under a module path) to the
    execution device. ``prefetch`` starts a group's copies on the side
    stream and returns; ``take`` hands the group over, the compute stream
    waiting on its copies; ``peek`` fetches a group that stays for the
    whole call (a tied embedding); ``release`` ends a group's residency
    once the compute that read it has run. ``peak_cached_bytes`` is the
    largest sum of groups resident at once (the JAX meaning: every
    group's bytes, those already on the device too); ``copied_bytes`` the
    bytes copied to the device."""

    def __init__(self, store: Mapping[str, Any], device, groups: Mapping[str, list]):
        self.store = store
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.groups = groups
        self.cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if self.cuda else None
        self._cache: dict[str, tuple] = {}
        self._live: dict[str, int] = {}
        self.peak_cached_bytes = 0
        self.copied_bytes = 0

    def _fetch(self, fqn: str) -> tuple[torch.Tensor, bool]:
        v = self.store[fqn]
        if isinstance(v, _DiskHandle):
            host = v.load_port()
            if self.cuda:  # memmap -> pinned staging (layout changed here) -> device
                return _pinned_copy(host).to(self.device, non_blocking=True), True
            return host.contiguous(), True
        if v.device == self.device:
            return v, False
        return v.to(self.device, non_blocking=True), True

    def _materialize(self, prefix: str):
        members = self.groups[prefix]
        out, copied = {}, []
        ctx = torch.cuda.stream(self._stream) if self.cuda else contextlib.nullcontext()
        with ctx:
            for rel, fqn in members:
                t, was_copied = self._fetch(fqn)
                out[rel] = t
                if was_copied:
                    copied.append(t)
                    self.copied_bytes += _nbytes(t)
            event = None
            if self.cuda:
                event = torch.cuda.Event()
                event.record(self._stream)
        self._live[prefix] = sum(_nbytes(t) for t in out.values())
        self.peak_cached_bytes = max(self.peak_cached_bytes, sum(self._live.values()))
        value = out[""] if list(out) == [""] else out
        return value, event, copied

    def _hand_over(self, entry):
        value, event, copied = entry
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for t in copied:
                t.record_stream(stream)
        return value

    def prefetch(self, prefix: str):
        if prefix not in self._cache:
            self._cache[prefix] = self._materialize(prefix)

    def take(self, prefix: str):
        entry = self._cache.pop(prefix, None) or self._materialize(prefix)
        return self._hand_over(entry)

    def peek(self, prefix: str):
        if prefix not in self._cache:
            self._cache[prefix] = self._materialize(prefix)
        return self._hand_over(self._cache[prefix])

    def release(self, prefix: str):
        self._live.pop(prefix, None)

    def compute_done(self):
        """An event after the compute enqueued so far (None off the card)."""
        if not self.cuda:
            return None
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return event


def _groups(fqns, prefixes) -> dict[str, list]:
    """prefix → [(name relative to the prefix, fqn)] (``""`` for a prefix
    that is itself a parameter)."""
    out = {p: [] for p in prefixes}
    for fqn in fqns:
        for p in prefixes:
            if fqn == p:
                out[p].append(("", fqn))
            elif fqn.startswith(p + "."):
                out[p].append((fqn[len(p) + 1:], fqn))
    return out


# ---------------------------------------------------------------------------
# Stream specs
# ---------------------------------------------------------------------------

_STREAM_PLANS: dict[str, Callable] = {}
_STREAM_SPECS: dict[str, Callable] = {}


def register_stream_plan(module_class_name: str, fn: Callable):
    """Register ``fn(module, resolver, *args, **kwargs) -> output`` as the
    streamed forward of a module class (for architectures without a spec)."""
    _STREAM_PLANS[module_class_name] = fn


def register_stream_spec(module_class_name: str, builder: Callable):
    """Register ``builder(module) -> [Seg | LayerSeg, ...]`` for a class."""
    _STREAM_SPECS[module_class_name] = builder


class Seg:
    """One segment: ``fn(params, *carry) -> carry``, ``params`` the tuple of
    the groups under ``prefixes`` (module paths), in order, each a dict of
    names relative to its prefix (a prefix that is itself a parameter gives
    the tensor). Groups named in ``keep`` stay for later segments (a tied
    embedding); the others are released when the segment has run."""

    def __init__(self, name: str, prefixes: list, fn: Callable, keep: tuple = ()):
        self.name = name
        self.prefixes = list(prefixes)
        self.fn = fn
        self.keep = set(keep)


class LayerSeg:
    """A streamed stack of identical blocks: block ``i`` is the group under
    ``prefix_fmt.format(i=i + offset)`` (``offset``: T5's stacks stream
    ``block_1``.. after their ``block_0``), and ``fn(block_params, *carry)
    -> carry`` runs it while the next block's weights are copied."""

    def __init__(self, name: str, prefix_fmt: str, n_layers: int, fn: Callable,
                 offset: int = 0):
        self.name = name
        self.prefix_fmt = prefix_fmt
        self.n_layers = n_layers
        self.fn = fn
        self.offset = offset

    def prefixes(self) -> list[str]:
        return [self.prefix_fmt.format(i=i + self.offset) for i in range(self.n_layers)]


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _spec_arity(segments) -> int:
    """Number of model inputs the first segment takes (``(params, *inputs)``)."""
    return len(inspect.signature(segments[0].fn).parameters) - 1


def _spec_prefixes(segments) -> list[str]:
    out = []
    for seg in segments:
        out += seg.prefixes() if isinstance(seg, LayerSeg) else seg.prefixes
    return list(dict.fromkeys(out))


def _run_stream_spec(resolver: ParamResolver, segments, *inputs):
    carry = tuple(inputs)
    for seg in segments:
        if isinstance(seg, LayerSeg):
            keys = seg.prefixes()
            if not keys:
                continue
            resolver.prefetch(keys[0])
            previous = None
            for i, key in enumerate(keys):
                carry = _as_tuple(seg.fn(resolver.take(key), *carry))
                done = resolver.compute_done()
                if previous is not None:
                    # Block i-1 has run: its buffers are free for block i+1.
                    if previous[1] is not None:
                        previous[1].synchronize()
                    resolver.release(previous[0])
                if i + 1 < len(keys):
                    resolver.prefetch(keys[i + 1])
                previous = (key, done)
            resolver.release(keys[-1])
        else:
            params = tuple(resolver.peek(p) if p in seg.keep else resolver.take(p)
                           for p in seg.prefixes)
            carry = _as_tuple(seg.fn(params, *carry))
            del params
            for p in seg.prefixes:
                if p not in seg.keep:
                    resolver.release(p)
    return carry[0]


def _llama_spec(module):
    """The Llama chassis (Mistral, Qwen2, Gemma, Phi-3, Granite, the
    generic specs): ``embed_tokens`` with Gemma's and Granite's scales ->
    blocks -> the module's own final norm (RMSNorm, plus-one or LayerNorm)
    -> tied or untied head with Granite's ``logits_scaling``."""
    from .models.llama import embed_tokens, rotary_embedding, scale_logits
    from .state import current_sequence_shard

    cfg, inner = module.config, module.model
    block = inner.layers[0]
    tied = cfg.tie_word_embeddings

    def embed_fn(params, input_ids):
        x = embed_tokens(cfg, params[0]["weight"], input_ids)
        n, i = current_sequence_shard()
        s = input_ids.shape[-1]
        positions = i * s + torch.arange(s, device=input_ids.device)
        cos, sin = rotary_embedding(positions, cfg.rotary_dim, cfg.rope_theta, x.dtype)
        return x, cos, sin

    def block_fn(p, x, cos, sin):
        return functional_call(block, p, (x, cos, sin)), cos, sin

    def head_fn(params, x, cos, sin):
        x = functional_call(inner.norm, params[0], (x,))
        return scale_logits(F.linear(x, params[1]["weight"].to(cfg.dtype)), cfg.logits_scaling)

    return [Seg("embed", ["model.embed_tokens"], embed_fn,
                keep=("model.embed_tokens",) if tied else ()),
            LayerSeg("block", "model.layers.{i}", cfg.num_hidden_layers, block_fn),
            Seg("head", ["model.norm", "model.embed_tokens" if tied else "lm_head"], head_fn)]


def _mixtral_spec(module):
    """Mixtral: Llama's embedding, the MoE blocks (their aux losses are not
    returned), the final RMSNorm and the head without scaling, as
    ``MixtralForCausalLM.forward`` computes them."""
    from .models.llama import embed_tokens, rotary_embedding
    from .utils.operations import loss_processes

    cfg, inner = module.config, module.model
    block = inner.layers[0]
    tied = cfg.tie_word_embeddings

    def embed_fn(params, input_ids):
        x = embed_tokens(cfg, params[0]["weight"], input_ids)
        positions = torch.arange(input_ids.shape[-1], device=input_ids.device)
        cos, sin = rotary_embedding(positions, cfg.rotary_dim, cfg.rope_theta, x.dtype)
        return x, cos, sin

    def block_fn(p, x, cos, sin):
        return functional_call(block, p, (x, cos, sin, loss_processes()))[0], cos, sin

    def head_fn(params, x, cos, sin):
        x = functional_call(inner.norm, params[0], (x,))
        return F.linear(x, params[1]["weight"].to(cfg.dtype))

    return [Seg("embed", ["model.embed_tokens"], embed_fn,
                keep=("model.embed_tokens",) if tied else ()),
            LayerSeg("block", "model.layers.{i}", cfg.num_hidden_layers, block_fn),
            Seg("head", ["model.norm", "model.embed_tokens" if tied else "lm_head"], head_fn)]


def _tied_head(x, weight, dtype):
    """fp32 logits of a head tied to an embedding (GPT-2, OPT, Whisper)."""
    head = weight.to(dtype)
    dt = torch.promote_types(x.dtype, head.dtype)
    return F.linear(x.to(dt), head.to(dt)).float()


def _opt_spec(module):
    cfg, inner = module.config, module.model
    block = inner.layers[0]

    def embed_fn(params, input_ids):
        pos = torch.arange(input_ids.shape[-1], device=input_ids.device) + cfg.POSITION_OFFSET
        return (F.embedding(input_ids, params[0]["weight"]).to(cfg.dtype)
                + F.embedding(pos, params[1]["weight"]).to(cfg.dtype))

    def head_fn(params, x):
        return _tied_head(functional_call(inner.final_layer_norm, params[0], (x,)),
                          params[1]["weight"], cfg.dtype)

    return [Seg("embed", ["model.embed_tokens", "model.embed_positions"], embed_fn,
                keep=("model.embed_tokens",)),
            LayerSeg("block", "model.layers.{i}", cfg.num_hidden_layers,
                     lambda p, x: functional_call(block, p, (x,))),
            Seg("head", ["model.final_layer_norm", "model.embed_tokens"], head_fn)]


def _neox_spec(module):
    cfg, inner = module.config, module.gpt_neox
    block = inner.layers[0]

    def embed_fn(params, input_ids):
        x = F.embedding(input_ids, params[0]["weight"]).to(cfg.dtype)
        positions = torch.arange(input_ids.shape[-1], device=input_ids.device)
        return x, positions.expand(input_ids.shape)

    def head_fn(params, x, positions):
        x = functional_call(inner.final_layer_norm, params[0], (x,))
        return functional_call(module.embed_out, params[1], (x,)).float()

    return [Seg("embed", ["gpt_neox.embed_in"], embed_fn),
            LayerSeg("block", "gpt_neox.layers.{i}", cfg.num_hidden_layers,
                     lambda p, x, pos: (functional_call(block, p, (x, pos)), pos)),
            Seg("head", ["gpt_neox.final_layer_norm", "embed_out"], head_fn)]


def _gpt2_spec(module):
    cfg, inner = module.config, module.transformer
    block = inner.h[0]

    def embed_fn(params, input_ids):
        pos = torch.arange(input_ids.shape[-1], device=input_ids.device)
        return (F.embedding(input_ids, params[0]["weight"]).to(cfg.dtype)
                + F.embedding(pos, params[1]["weight"]).to(cfg.dtype))

    def head_fn(params, x):
        return _tied_head(functional_call(inner.ln_f, params[0], (x,)), params[1]["weight"],
                          cfg.dtype)

    return [Seg("embed", ["transformer.wte", "transformer.wpe"], embed_fn,
                keep=("transformer.wte",)),
            LayerSeg("block", "transformer.h.{i}", cfg.n_layer,
                     lambda p, x: functional_call(block, p, (x,))),
            Seg("head", ["transformer.ln_f", "transformer.wte"], head_fn)]


def _t5_spec(module):
    """T5: both stacks stream; ``block_0`` (owner of the relative-position
    bias) is a segment of its own, the blocks that reuse its bias are the
    streamed stack."""
    from .models.llama import as_dtype

    cfg = module.config
    enc, dec = module.encoder, module.decoder
    enc_blk = enc.block_1 if enc.n_blocks > 1 else None
    dec_blk = dec.block_1 if dec.n_blocks > 1 else None

    def embed(weight, ids):
        return F.embedding(ids, weight).to(cfg.dtype)

    def enc_embed_fn(params, input_ids, decoder_input_ids):
        mask = (input_ids != cfg.pad_token_id).to(torch.int32)
        return embed(params[0]["weight"], input_ids), mask, decoder_input_ids

    def enc_b0_fn(params, x, mask, dec_ids):
        x, bias = functional_call(enc.block_0, params[0], (x, mask, None))
        return x, bias, mask, dec_ids

    def enc_blk_fn(p, x, bias, mask, dec_ids):
        return functional_call(enc_blk, p, (x, mask, bias))[0], bias, mask, dec_ids

    def enc_final_fn(params, x, bias, mask, dec_ids):
        return functional_call(enc.final_ln, params[0], (x,)), mask, dec_ids

    def dec_embed_fn(params, h, mask, dec_ids):
        return embed(params[0]["weight"], dec_ids), h, mask

    def dec_b0_fn(params, y, h, mask):
        y, bias = functional_call(dec.block_0, params[0], (y, h, None, mask))
        return y, bias, h, mask

    def dec_blk_fn(p, y, bias, h, mask):
        return functional_call(dec_blk, p, (y, h, bias, mask))[0], bias, h, mask

    def head_fn(params, y, bias, h, mask):
        y = functional_call(dec.final_ln, params[0], (y,))
        y = y * as_dtype(cfg.d_model ** -0.5, y.dtype)
        head = params[1]["weight"].to(cfg.dtype)
        dt = torch.promote_types(y.dtype, head.dtype)
        return F.linear(y.to(dt), head.to(dt))

    return [Seg("enc_embed", ["shared"], enc_embed_fn, keep=("shared",)),
            Seg("enc_b0", ["encoder.block_0"], enc_b0_fn),
            LayerSeg("enc_blk", "encoder.block_{i}", cfg.num_layers - 1, enc_blk_fn, offset=1),
            Seg("enc_final", ["encoder.final_ln"], enc_final_fn),
            Seg("dec_embed", ["shared"], dec_embed_fn, keep=("shared",)),
            Seg("dec_b0", ["decoder.block_0"], dec_b0_fn),
            LayerSeg("dec_blk", "decoder.block_{i}", cfg.n_dec - 1, dec_blk_fn, offset=1),
            Seg("head", ["decoder.final_ln", "shared"], head_fn)]


def _whisper_spec(module):
    cfg = module.config
    enc, dec = module.encoder, module.decoder
    enc_blk, dec_blk = enc.layers[0], dec.layers[0]

    def enc_stem_fn(params, feats, dec_ids):
        x = F.gelu(functional_call(enc.conv1, params[0], (feats,)))
        x = F.gelu(functional_call(enc.conv2, params[1], (x,)))
        return x + params[2][None, :x.shape[1]].to(x.dtype), dec_ids

    def enc_ln_fn(params, x, dec_ids):
        return functional_call(enc.layer_norm, params[0], (x,)), dec_ids

    def dec_embed_fn(params, h, dec_ids):
        pos = torch.arange(dec_ids.shape[-1], device=dec_ids.device)
        y = (F.embedding(dec_ids, params[0]["weight"]).to(cfg.dtype)
             + F.embedding(pos, params[1]["weight"]).to(cfg.dtype))
        return y, h

    def head_fn(params, y, h):
        return _tied_head(functional_call(dec.layer_norm, params[0], (y,)),
                          params[1]["weight"], cfg.dtype)

    return [Seg("enc_stem", ["encoder.conv1", "encoder.conv2", "encoder.embed_positions"],
                enc_stem_fn),
            LayerSeg("enc_blk", "encoder.layers.{i}", cfg.encoder_layers,
                     lambda p, x, dec_ids: (functional_call(enc_blk, p, (x,)), dec_ids)),
            Seg("enc_ln", ["encoder.layer_norm"], enc_ln_fn),
            Seg("dec_embed", ["decoder.embed_tokens", "decoder.embed_positions"], dec_embed_fn,
                keep=("decoder.embed_tokens",)),
            LayerSeg("dec_blk", "decoder.layers.{i}", cfg.decoder_layers,
                     lambda p, y, h: (functional_call(dec_blk, p, (y, h)), h)),
            Seg("head", ["decoder.layer_norm", "decoder.embed_tokens"], head_fn)]


register_stream_spec("LlamaForCausalLM", _llama_spec)
register_stream_spec("MixtralForCausalLM", _mixtral_spec)
register_stream_spec("OPTForCausalLM", _opt_spec)
register_stream_spec("GPTNeoXForCausalLM", _neox_spec)
register_stream_spec("GPT2LMHeadModel", _gpt2_spec)
register_stream_spec("T5ForConditionalGeneration", _t5_spec)
register_stream_spec("WhisperForConditionalGeneration", _whisper_spec)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

_warned_fallback: set = set()


def _warn_materialize_fallback(cls_name, store, reason: str):
    """One warning per class: a dispatched model that materialises every
    parameter on the device for each call defeats the offload."""
    if cls_name in _warned_fallback:
        return
    _warned_fallback.add(cls_name)
    total = sum(_nbytes(v) for v in store.values())
    logging.getLogger(__name__).warning(
        "dispatch_model: %s cannot use layer streaming (%s) — the full parameter set "
        "(%.2f GB) will be materialized on the execution device for every forward, "
        "defeating offload. register_stream_spec()/register_stream_plan() add streamed "
        "forwards for custom models.", cls_name, reason, total / 1e9)


def _skeleton(module: torch.nn.Module) -> torch.nn.Module:
    """A copy of ``module`` whose parameters are meta tensors (the
    original keeps its own)."""
    import copy

    memo = {id(p): torch.nn.Parameter(torch.empty_like(p, device="meta"), requires_grad=False)
            for p in module.parameters()}
    return copy.deepcopy(module, memo)


class DispatchedModel(Model):
    """A ``Model`` whose parameters live across the card, the host and the
    disk. ``store`` maps each parameter name of the (meta) module to its
    tensor or ``_DiskHandle``. A call runs the class's stream spec when one
    is registered and the call gives exactly the spec's inputs, else a
    registered stream plan, else materialises every parameter on the
    execution device for the call (one warning per class). Inference only:
    calls run without autograd."""

    def __init__(self, module, store, device_map, execution_device, sep: str = "/"):
        super().__init__(module)
        self.store = dict(store)
        self.device_map = dict(device_map)
        self.execution_device = torch.device(execution_device)
        self._sep = sep
        self.last_stream_peak_bytes: Optional[int] = None
        self.last_stream_copied_bytes: Optional[int] = None

    def _resolver(self, prefixes):
        return ParamResolver(self.store, self.execution_device, _groups(self.store, prefixes))

    def __call__(self, *args, **kwargs):
        from .ops.fp8 import eval_mode

        with torch.no_grad(), eval_mode():
            return self._forward(*args, **kwargs)

    def _forward(self, *args, **kwargs):
        cls_name = type(self.module).__name__
        builder = _STREAM_SPECS.get(cls_name)
        reason = None
        if builder is not None and not kwargs:
            segments = builder(self.module)
            if _spec_arity(segments) == len(args):
                resolver = self._resolver(_spec_prefixes(segments))
                out = _run_stream_spec(resolver, segments, *args)
                self.last_stream_peak_bytes = resolver.peak_cached_bytes
                self.last_stream_copied_bytes = resolver.copied_bytes
                return out
            reason = (f"call arity {len(args)} != spec arity {_spec_arity(segments)} "
                      "(optional args need the full signature)")
        elif builder is not None:
            reason = "keyword arguments need the full apply signature"
        plan = _STREAM_PLANS.get(cls_name)
        if plan is not None:
            resolver = self._resolver(sorted({f.rpartition(".")[0] for f in self.store}))
            out = plan(self.module, resolver, *args, **kwargs)
            self.last_stream_peak_bytes = resolver.peak_cached_bytes
            self.last_stream_copied_bytes = resolver.copied_bytes
            return out
        _warn_materialize_fallback(cls_name, self.store, reason or "no stream plan registered")
        resolver = self._resolver(list(self.store))
        full = {fqn: resolver.take(fqn) for fqn in self.store}
        try:
            return functional_call(self.module, full, args, kwargs)
        finally:
            del full

    def hbm_resident_bytes(self) -> int:
        """Bytes of parameters resident on a device (not the host or disk
        tiers)."""
        return sum(_nbytes(v) for fqn, v in self.store.items()
                   if isinstance(self._placement(fqn), torch.device))

    def _placement(self, fqn):
        from .models.convert import flax_leaf

        return placement_for(flax_leaf(self.module, fqn).name, self.device_map, self._sep)

    def tier_bytes(self) -> dict:
        """Parameter bytes by placement (``placement_key``)."""
        out: dict[str, int] = {}
        for fqn, v in self.store.items():
            key = placement_key(self._placement(fqn))
            out[key] = out.get(key, 0) + _nbytes(v)
        return out


def _module_of(model) -> torch.nn.Module:
    return model.module if isinstance(model, Model) else model


def dispatch_model(model, device_map: Mapping[str, Any], offload_dir: Optional[str] = None,
                   execution_device=None, sep: str = "/") -> DispatchedModel:
    """Scatter an in-memory model's parameters per ``device_map`` (flax
    names): copies on the GPUs, pinned copies on the host, flax-layout
    leaves in the disk store under ``offload_dir``. The model passed in
    keeps its own parameters."""
    module = _module_of(model)
    device_map = normalize_device_map(device_map)
    check_device_map(compute_abstract_params(module), device_map, sep=sep)
    store: dict[str, Any] = {}
    disk: dict[str, dict] = {}
    for fqn, p, leaf in _leaves(module):
        placement = placement_for(leaf.name, device_map, sep=sep)
        if placement == "disk":
            disk.setdefault(leaf.name, {})[fqn] = (leaf, p.detach())
        elif placement == "cpu":
            store[fqn] = _pinned_copy(p.detach())
        else:
            store[fqn] = p.detach().to(placement, copy=True).contiguous()
    if disk:
        if offload_dir is None:
            raise ValueError("device_map contains 'disk' entries but no offload_dir given")
        index = {}
        for name, members in disk.items():
            rows = sorted(members.items(), key=lambda kv: kv[1][0].index or 0)
            values = [leaf.to_flax(p.to("cpu")) for _, (leaf, p) in rows]
            stacked = rows[0][1][0].index is not None
            value = torch.stack(values) if stacked else values[0]
            index[name] = offload_weight(value, name, offload_dir)
            for fqn, (leaf, _) in rows:
                store[fqn] = _DiskHandle(name, offload_dir, value.shape, index[name]["dtype"],
                                         leaf.index, leaf.from_flax)
        save_offload_index(index, offload_dir)
    if execution_device is None:
        execution_device = default_execution_device(device_map)
    return DispatchedModel(_skeleton(module), store, device_map, execution_device, sep=sep)


def cpu_offload(model, execution_device=None) -> DispatchedModel:
    """Every parameter in (pinned) host memory, streamed to the execution
    device for each forward."""
    top = {k: "cpu" for k in compute_abstract_params(_module_of(model))}
    return dispatch_model(model, top, execution_device=execution_device)


def disk_offload(model, offload_dir: str, execution_device=None) -> DispatchedModel:
    """Every parameter in the disk store under ``offload_dir``."""
    top = {k: "disk" for k in compute_abstract_params(_module_of(model))}
    return dispatch_model(model, top, offload_dir=offload_dir, execution_device=execution_device)


class UserCpuOffloadHook:
    """Handle of :func:`cpu_offload_with_hook`: ``offload()`` moves the
    model's parameters back to the host; ``remove()`` stops the hook."""

    def __init__(self, model: "HookedOffloadModel"):
        self.model = model

    def offload(self):
        self.model._to_host()

    def remove(self):
        self.model._hooked = False


class HookedOffloadModel(Model):
    """Parameters live on the host; the first forward moves them to the
    execution device and they stay there until ``hook.offload()``. With a
    ``prev_hook``, loading this model first offloads the previous one (a
    pipeline of models, each on the card in turn)."""

    def __init__(self, inner, execution_device, prev_hook):
        super().__init__(_module_of(inner))
        self._exec_device = torch.device(execution_device)
        self._prev_hook = prev_hook
        self._on_device = False
        self._hooked = True
        self._to_host()

    def _to_host(self):
        self.module.to("cpu")
        self._on_device = False

    def __call__(self, *args, **kwargs):
        if self._hooked:
            if self._prev_hook is not None:
                self._prev_hook.offload()
            if not self._on_device:
                self.module.to(self._exec_device)
                self._on_device = True
        return super().__call__(*args, **kwargs)


def cpu_offload_with_hook(model, execution_device=None,
                          prev_module_hook: Optional[UserCpuOffloadHook] = None
                          ) -> tuple[Model, UserCpuOffloadHook]:
    """Offload to the host, but keep the parameters on the card between
    forwards until the returned hook's ``offload()`` runs; chained through
    ``prev_module_hook``, model *i*'s load offloads model *i-1*."""
    if execution_device is None:
        execution_device = torch.device("cuda", 0)
    hooked = HookedOffloadModel(model, execution_device, prev_module_hook)
    return hooked, UserCpuOffloadHook(hooked)


def load_checkpoint_and_dispatch(module, checkpoint: str, *sample_args, device_map: Any = "auto",
                                 max_memory: Optional[dict] = None,
                                 no_split_modules: Optional[list[str]] = None,
                                 offload_folder: Optional[str] = None, dtype=None, rng=None,
                                 sep: str = "/", **sample_kwargs) -> DispatchedModel:
    """The JAX package's sharded safetensors checkpoint into a dispatched
    model, shard by shard, with no full copy of the model in any one
    memory. ``module`` is the port's module (built on ``meta``, or any
    instance: its own tensors are not used). ``device_map``: ``"auto"``
    (fill the GPUs, then the host, then the disk, within ``max_memory``),
    ``"balanced"`` / ``"balanced_low_0"`` (GPU budgets evened out), None
    (everything on GPU 0) or an explicit map of flax names."""
    abstract = compute_abstract_params(module, *sample_args, rng=rng, **sample_kwargs)
    if device_map in ("auto", "balanced", "balanced_low_0"):
        if device_map == "auto":
            budgets = get_max_memory(max_memory)
        else:
            budgets = get_balanced_memory(abstract, max_memory, no_split_modules, dtype=dtype,
                                          low_zero=device_map == "balanced_low_0")
        device_map = infer_auto_device_map(abstract, budgets, no_split_modules=no_split_modules,
                                           dtype=dtype, sep=sep)
    elif device_map is None:
        device_map = {"": torch.device("cuda", 0)}
    else:
        device_map = normalize_device_map(device_map)
    check_device_map(abstract, device_map, sep=sep)
    store, _ = load_checkpoint_in_model(module, checkpoint, device_map=device_map,
                                        offload_folder=offload_folder, dtype=dtype, sep=sep)
    skeleton = module if all(p.is_meta for p in module.parameters()) else _skeleton(module)
    return DispatchedModel(skeleton, store, device_map, default_execution_device(device_map),
                           sep=sep)
