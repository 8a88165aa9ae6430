"""``utils/estimate_memory.py`` against the JAX package's.

For every configuration of the JAX package's ``tests/test_estimate_memory.py``
(the tiny Llama at ``dp_shard=8``, ``dp_shard=4 × tp=2`` with
``llama_tp_rules`` and ``dp_replicate=2 × dp_shard=4``; the replicated-leaf
detector at ``dp_replicate=8`` and ``dp_shard=8``; the 7B Llama at
``dp_shard=64`` in bf16 with remat; the tiny Mixtral at ``dp_replicate=8``
and at ``dp_replicate=4 × dp_shard=2`` with and without the EP rules; bf16
moments; ``pp=2`` with ``dp_shard`` and ``tp``), the port's ``estimate_per_chip`` on its module built on the
``meta`` device gives every row within one byte of the JAX function's on
its abstract parameter tree, and the same replicated leaves. The EP rules
are the JAX table as data (``models/moe._mixtral_rules``): the port prices
an EP plan it does not run yet.
"""

from __future__ import annotations

import pytest
import torch

import jax.numpy as jnp

from accelerate_tpu.models import LlamaConfig as JaxLlamaConfig
from accelerate_tpu.models import LlamaForCausalLM as JaxLlama
from accelerate_tpu.models import MixtralConfig as JaxMixtralConfig
from accelerate_tpu.models import MixtralForCausalLM as JaxMixtral
from accelerate_tpu.models import llama_tp_rules as jax_llama_rules
from accelerate_tpu.parallelism_config import ParallelismConfig as JaxPC
from accelerate_tpu.utils import estimate_memory as jax_em
from accelerate_tpu_torch import ParallelismConfig
from accelerate_tpu_torch.models import (
    LlamaConfig,
    LlamaForCausalLM,
    MixtralConfig,
    MixtralForCausalLM,
    llama_tp_rules,
)
from accelerate_tpu_torch.models import moe
from accelerate_tpu_torch.utils import estimate_memory as em


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TINY = dict(seq=16, per_chip_batch=1)
SEVEN_B = dict(seq=2048, per_chip_batch=1)

# name -> (family, config knobs, parallelism, rules, estimate kwargs)
CASES = {
    "llama-dp_shard8": ("llama", {}, {"dp_shard_size": 8}, None, TINY),
    "llama-dp_shard4_tp2": ("llama", {}, {"dp_shard_size": 4, "tp_size": 2}, "tp", TINY),
    "llama-dp_replicate2_dp_shard4": ("llama", {}, {"dp_replicate_size": 2, "dp_shard_size": 4},
                                      None, TINY),
    "llama-dp_replicate8": ("llama", {}, {"dp_replicate_size": 8}, None, TINY),
    "llama-moments_bf16": ("llama", {}, {"dp_shard_size": 8}, None,
                           dict(TINY, moments_dtype="bfloat16")),
    "llama7b-dp_shard64": ("llama7b", {"remat": True}, {"dp_shard_size": 64}, None,
                           dict(SEVEN_B, master_dtype="bfloat16", moments_dtype="bfloat16")),
    "mixtral-dp_replicate8": ("mixtral", {}, {"dp_replicate_size": 8}, None, TINY),
    "mixtral-dp_replicate4_dp_shard2": ("mixtral", {}, {"dp_replicate_size": 4,
                                                        "dp_shard_size": 2}, None, TINY),
    "mixtral-ep2": ("mixtral", {}, {"dp_replicate_size": 4, "dp_shard_size": 2}, "ep", TINY),
    # Pipeline stages: each holds its L/pp layers.
    "llama-pp2_dp_shard4": ("llama", {}, {"pp_size": 2, "dp_shard_size": 4}, None, TINY),
    "llama-pp2_dp_shard2_tp2": ("llama", {}, {"pp_size": 2, "dp_shard_size": 2, "tp_size": 2},
                                "tp", TINY),
}


def _jax(family, knobs, pc_kwargs, rules, kw):
    if family == "mixtral":
        cfg = JaxMixtralConfig.tiny(dtype=jnp.float32, **knobs)
        module = JaxMixtral(cfg)
    elif family == "llama7b":
        cfg = JaxLlamaConfig.llama_7b(dtype=jnp.bfloat16, **knobs)
        module = JaxLlama(cfg)
    else:
        cfg = JaxLlamaConfig.tiny(dtype=jnp.float32, **knobs)
        module = JaxLlama(cfg)
    pc = JaxPC(**pc_kwargs, **({"ep_size": 2} if rules == "ep" else {}))
    table = {None: None, "tp": jax_llama_rules(True),
             "ep": None if rules != "ep" else __import__(
                 "accelerate_tpu.models.moe", fromlist=["x"]).mixtral_tp_rules(
                 True, ep_axes=pc.ep_axes)}[rules]
    kw = {k: (getattr(jnp, v) if k.endswith("dtype") else v) for k, v in kw.items()}
    est, shapes, shardings = jax_em.estimate_per_chip(module, cfg, pc, tp_rules=table, **kw)
    bad = jax_em.replicated_large_leaves(shapes, shardings, jax_em.build_abstract_mesh(pc),
                                         min_bytes=2 ** 16)
    return est, bad


def _port(family, knobs, pc_kwargs, rules, kw):
    if family == "mixtral":
        cfg = MixtralConfig.tiny(dtype=torch.float32, **knobs)
        module = MixtralForCausalLM(cfg, device="meta")
    elif family == "llama7b":
        cfg = LlamaConfig(dtype=torch.bfloat16, **knobs)
        module = LlamaForCausalLM(cfg, device="meta")
    else:
        cfg = LlamaConfig.tiny(dtype=torch.float32, **knobs)
        module = LlamaForCausalLM(cfg, device="meta")
    pc = ParallelismConfig(**pc_kwargs)
    table = {None: None, "tp": llama_tp_rules(True),
             "ep": moe._mixtral_rules(True, ("dp_shard",))}[rules]
    kw = {k: (getattr(torch, v) if k.endswith("dtype") else v) for k, v in kw.items()}
    est, shapes, placements = em.estimate_per_chip(module, cfg, pc, tp_rules=table, **kw)
    bad = em.replicated_large_leaves(shapes, placements, em.build_abstract_mesh(pc),
                                     min_bytes=2 ** 16)
    return est, bad


@pytest.mark.parametrize("case", sorted(CASES))
def test_rows_equal_the_jax_estimate(case):
    """Every row within one byte of the JAX estimate's, and the same
    replicated large leaves."""
    want, want_bad = _jax(*CASES[case])
    got, got_bad = _port(*CASES[case])
    for (name, g), (wname, w) in zip(got.rows(), want.rows()):
        assert name == wname
        assert abs(g * em.GiB - w * em.GiB) <= 1, (case, name, g, w)
    assert sorted(got_bad) == sorted(want_bad)


def test_ep_rules_shrink_the_experts_and_replication_is_detected():
    """The JAX tests' orderings on the port's rows: EP rules halve the
    expert bytes against replication; FSDP leaves no large leaf whole, DDP
    the embedding; bf16 moments halve the optimizer row; 7B fits 16 GiB."""
    ep, _ = _port(*CASES["mixtral-ep2"])
    dp, _ = _port(*CASES["mixtral-dp_replicate8"])
    assert ep.params_gib < dp.params_gib
    _, bad = _port(*CASES["llama-dp_replicate8"])
    assert any("embed_tokens" in b for b in bad)
    assert _port(*CASES["llama-dp_shard8"])[1] == []
    half, _ = _port(*CASES["llama-moments_bf16"])
    full, _ = _port(*CASES["llama-dp_shard8"])
    assert half.opt_state_gib == pytest.approx(full.opt_state_gib / 2)
    seven, _ = _port(*CASES["llama7b-dp_shard64"])
    assert seven.params_gib * 64 > 11 and seven.total_gib < 16


def test_activation_bytes_overrides_remat():
    cfg = LlamaConfig.tiny(dtype=torch.bfloat16)
    jcfg = JaxLlamaConfig.tiny(dtype=jnp.bfloat16)
    for kw in ({}, {"remat": True}, {"remat": True, "remat_policy": "dots"},
               {"remat": True, "remat_policy": "minimal"}):
        assert (em.activation_bytes(cfg, 2, 64, 2, **kw)
                == jax_em.activation_bytes(jcfg, 2, 64, 2, **kw))
    assert em.abstract_param_shapes(LlamaForCausalLM(cfg, device="meta"))[
        "model.embed_tokens.weight"] == ((256, 128), torch.float32)
