"""BERT encoder in PyTorch (counterpart of ``accelerate_tpu/models/bert.py``).

Post-LN blocks with flax's LayerNorm (``layers.FlaxLayerNorm``): word,
position and token-type embeddings, a LayerNorm, then per block
self-attention → add & LayerNorm → exact-erf GELU MLP → add & LayerNorm;
a tanh pooler on token 0 and the task heads. The attention is the JAX
module's, materialised (``layers.module_attention``): scores in the
compute dtype, ``finfo.min`` on the keys ``attention_mask`` hides, an fp32
softmax, then a cast. ``BertForMaskedLM``'s decoder is tied to the word
embeddings and adds its own ``decoder_bias``; its logits and the
classifier's are fp32.

Dropout (``hidden_dropout_prob``, flax's ``nn.Dropout`` after the
embeddings' norm, after the attention and the MLP of each block, and on the
pooled output) draws from the ``torch.Generator`` a forward is given; none
without one (flax's ``deterministic=True``).

Parameter names follow the flax tree (``bert.layers.{i}.attention.query.
weight`` ↔ ``bert/layers/block/attention/query/kernel``, flax's LayerNorm
``scale`` is ``weight``); projections are ``(out, in)`` Linears and
``models/convert.py`` reshapes them into the ``DenseGeneral`` kernels.

``fp8=True`` sends the block projections (q, k, v, the attention output,
the MLP) through ``ops/fp8.fp8_dot_general``, as the JAX module's
``dot_general`` does; the embeddings, the pooler and the heads stay in the
compute dtype.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor

from ..ops.fp8 import backend_to_native, fp8_dot_general
from ..parallel import tp
from ..utils.operations import global_token_count
from .layers import FlaxLayerNorm, dropout, init_weights, module_attention, run_blocks
from .llama import _Linear

@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_dropout_prob: float = 0.1
    num_labels: int = 2
    dtype: Any = torch.bfloat16
    # Kept so a JAX config's fields carry over; convert.py reads both layouts.
    scan_layers: bool = True
    remat: bool = False
    fp8: bool = False
    fp8_format: str = "HYBRID"
    fp8_backend: str = "AUTO"      # AUTO | TE | AO | QDQ (ops/fp8.py backend_to_native)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def dot_general(self):
        if not self.fp8:
            return None
        return fp8_dot_general(self.fp8_format, native=backend_to_native(self.fp8_backend))

    @classmethod
    def tiny(cls, **kw):
        defaults = dict(vocab_size=256, hidden_size=128, num_hidden_layers=2,
                        num_attention_heads=4, intermediate_size=256,
                        max_position_embeddings=128, hidden_dropout_prob=0.0)
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def bert_base(cls, **kw):
        return cls(**kw)

    @classmethod
    def bert_large(cls, **kw):
        return cls(hidden_size=1024, num_hidden_layers=24, num_attention_heads=16,
                   intermediate_size=4096, **kw)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        linear = partial(_Linear, dtype=cfg.dtype, device=device, linear=cfg.dot_general,
                         bias=True)
        self.query, self.key, self.value = linear(h, h), linear(h, h), linear(h, h)
        self.output = linear(h, h)

    def forward(self, x, mask):
        cfg = self.cfg
        b, s, _ = x.shape
        q, k, v = (p(x).view(b, s, -1, cfg.head_dim)  # local heads under tp
                   for p in (self.query, self.key, self.value))
        out = module_attention(q, k, v, cfg.dtype, causal=False, key_mask=mask)
        return self.output(out.reshape(b, s, -1))


class BertBlock(nn.Module):
    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.cfg = cfg
        h, eps = cfg.hidden_size, cfg.layer_norm_eps
        linear = partial(_Linear, dtype=cfg.dtype, device=device, linear=cfg.dot_general,
                         bias=True)
        self.attention = BertSelfAttention(cfg, device)
        self.attention_norm = FlaxLayerNorm(h, eps, device)
        self.intermediate = linear(h, cfg.intermediate_size)
        self.output = linear(cfg.intermediate_size, h)
        self.output_norm = FlaxLayerNorm(h, eps, device)

    def forward(self, x, mask, generator=None):
        p = self.cfg.hidden_dropout_prob
        x = self.attention_norm(x + dropout(self.attention(x, mask), p, generator))
        h = self.output(F.gelu(self.intermediate(x)))  # exact erf GELU
        return self.output_norm(x + dropout(h, p, generator))


class BertModel(nn.Module):
    def __init__(self, cfg: BertConfig, add_pooling_layer: bool = True, device=None):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, h, device=device)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, h, device=device)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, h, device=device)
        self.embeddings_norm = FlaxLayerNorm(h, cfg.layer_norm_eps, device)
        self.layers = nn.ModuleList(BertBlock(cfg, device) for _ in range(cfg.num_hidden_layers))
        self.pooler = (_Linear(h, h, cfg.dtype, device, bias=True) if add_pooling_layer
                       else None)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                generator: Optional[torch.Generator] = None):
        """(last hidden state (B, S, H), the pooled token 0 or None)."""
        cfg = self.cfg
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        pos = torch.arange(input_ids.shape[-1], device=input_ids.device)
        x = (tp.embedding(input_ids, self.word_embeddings.weight).to(cfg.dtype)
             + F.embedding(pos, self.position_embeddings.weight).to(cfg.dtype)
             + F.embedding(token_type_ids, self.token_type_embeddings.weight).to(cfg.dtype))
        x = dropout(self.embeddings_norm(x), cfg.hidden_dropout_prob, generator)
        x = run_blocks(self.layers, x, cfg.remat, attention_mask, generator,
                       generator=generator)
        pooled = torch.tanh(self.pooler(x[:, 0])) if self.pooler is not None else None
        return x, pooled


class BertForSequenceClassification(nn.Module):
    # FSDP2's per-block units (parallel/fsdp.decoder_blocks).
    _fsdp_blocks = (BertBlock,)

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.config = cfg
        self.bert = BertModel(cfg, device=device)
        self.classifier = nn.Linear(cfg.hidden_size, cfg.num_labels, device=device)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                generator: Optional[torch.Generator] = None):
        """fp32 logits (B, num_labels)."""
        _, pooled = self.bert(input_ids, attention_mask, token_type_ids, generator)
        pooled = dropout(pooled, self.config.hidden_dropout_prob, generator)
        return F.linear(pooled.float(), self.classifier.weight.float(),
                        self.classifier.bias.float())

    def init_weights(self, generator: torch.Generator, std: float = 0.02):
        """normal(0, std) matrices and embeddings, zero biases, unit norm
        scales; ``generator`` on the parameters' device."""
        init_weights(self, generator, std)


class BertForMaskedLM(nn.Module):
    _fsdp_blocks = (BertBlock,)

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.config = cfg
        h = cfg.hidden_size
        self.bert = BertModel(cfg, add_pooling_layer=False, device=device)
        self.transform = _Linear(h, h, cfg.dtype, device, bias=True)
        self.transform_norm = FlaxLayerNorm(h, cfg.layer_norm_eps, device)
        self.decoder_bias = nn.Parameter(torch.zeros(cfg.vocab_size, device=device))

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                generator: Optional[torch.Generator] = None):
        """fp32 logits (B, S, V) of the head tied to the word embeddings:
        ``x @ embedding.T`` in the type the transform's output and the
        embedding rounded to the compute dtype promote to, plus the bias
        (in the type the two promote to)."""
        cfg = self.config
        x, _ = self.bert(input_ids, attention_mask, token_type_ids, generator)
        x = self.transform_norm(F.gelu(self.transform(x)))
        head = self.bert.word_embeddings.weight.to(cfg.dtype)
        dt = torch.promote_types(x.dtype, head.dtype)
        return tp.vocab_logits(x.to(dt), head.to(dt), self.decoder_bias,
                               post=lambda y: y.float())

    def init_weights(self, generator: torch.Generator, std: float = 0.02):
        init_weights(self, generator, std)


def masked_lm_loss(logits, labels, ignore_index: int = -100):
    """Cross entropy over the positions whose label is not
    ``ignore_index``: fp32 log-softmax, the sum over them divided by their
    count (at least 1). Inside a train step over several processes the
    count is that of every process's masked positions and the sum is
    scaled by their number, so that the step's mean is the global batch's,
    as the JAX step takes it (``operations.global_token_count``)."""
    mask = labels != ignore_index
    if isinstance(logits, DTensor):  # split on the vocab over tp (parallel/tp.py)
        nll = tp.vocab_parallel_nll(logits, labels)
    else:
        safe = torch.where(mask, labels, 0).long()
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -logp.gather(-1, safe[..., None])[..., 0]
    count, n = global_token_count(mask.sum())
    return (nll * mask).sum() * n / count.clamp_min(1)


def bert_tp_rules(scan_layers: bool = True) -> list[tuple[str, tuple]]:
    """The JAX package's TP rule table for BERT (``parallel/sharding.py``):
    query/key/value on their heads, ``intermediate`` on its output, the two
    ``output`` projections on their input, ``word_embeddings`` (and the tied
    MLM head) on the vocab."""
    lead = (None,) if scan_layers else ()
    return [
        (r"attention/(query|key|value)/kernel", lead + (None, "tp", None)),
        (r"intermediate/kernel", lead + (None, "tp")),
        (r"attention/output/kernel", lead + ("tp", None, None)),
        (r"(?<!attention/)output/kernel", lead + ("tp", None)),
        (r"word_embeddings/embedding", ("tp", None)),
    ]
