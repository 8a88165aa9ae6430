"""Tensor parallelism of the port against the JAX package's.

In this process, without processes:

- every family's TP rule table against the JAX table, pattern for pattern
  and spec for spec (Mixtral's EP table as data);
- ``parallel/sharding.plan_parameter_sharding`` on a tiny model of each
  family against the JAX ``plan_parameter_sharding`` of the same config on
  a mesh of sizes: each parameter's spec equals the JAX spec of its flax
  leaf (``models/convert.flax_leaf``), at ``tp=2``, ``dp_shard=2 × tp=2``,
  GQA kv heads below ``tp`` (kept whole, with the JAX warning) and
  ``ignored_params``; and each split parameter's local shard holds the
  elements the JAX spec gives its rank;
- rows over ``tp``: ranks that differ only in ``tp`` read the same rows;
  ``tp`` with a sequence axis is refused.

On gloo gangs of 2 and 4 CPU processes (``torch.multiprocessing`` spawn,
a ``file://`` rendezvous under the test's temporary directory), spawned
once for the module, against the JAX package on the 8 virtual CPU devices
of ``tests/conftest.py`` with its ``tests/test_llama.py`` topology
(``dp_shard=4 × tp=2``, ``llama_tp_rules``):

- the tiny Llama's 3 steps of ``prepare_train_step`` at ``tp=2``,
  ``dp_shard=2 × tp=2`` (FSDP2 2-D) and ``dp_replicate=2 × tp=2`` in fp32
  (losses and grad norms within 1e-5 relative, the weights after them),
  and at ``tp=2`` in bf16 within the bf16 gate; flash attention runs on
  each rank's own heads;
- every other family's forward at ``tp=2`` within 1e-5 of the JAX module
  at ``tp=2`` (GSPMD over the JAX plan), Mixtral's drops equal;
- greedy ``generate`` at ``tp=2`` equal to the JAX package's and to the
  port's at ``tp=1`` (each step's top-2 logit gap above 1e-4);
- a checkpoint saved at ``tp=2`` resumed bit for bit at ``tp=1`` by the
  port and by the JAX package.

The spawned processes import this module: JAX is imported only inside the
functions that compute the references.
"""

from __future__ import annotations

import importlib
import logging
import pickle

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from accelerate_tpu_torch import (
    Accelerator,
    FullyShardedDataParallelPlugin,
    Model,
    ParallelismConfig,
    adamw,
    generate,
)
from accelerate_tpu_torch import models as M
from accelerate_tpu_torch.models import convert, cross_entropy_loss
from accelerate_tpu_torch.parallel import sharding, tp
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

STEPS, LR, SEQ, BATCH = 3, 1e-3, 16, 8
MIN_GAP = 1e-4

# family -> (port/JAX class, config class, JAX module, rule table, knobs)
FAMILIES = {
    "llama": ("LlamaForCausalLM", "LlamaConfig", "llama", "llama_tp_rules", {}),
    "llama_gqa": ("LlamaForCausalLM", "LlamaConfig", "llama", "llama_tp_rules",
                  {"num_key_value_heads": 1}),
    # 6 q heads over 3 kv heads: each rank's 3 q heads read two groups, so
    # the kv heads it needs are expanded to one per q head.
    "llama_gqa3": ("LlamaForCausalLM", "LlamaConfig", "llama", "llama_tp_rules",
                   {"num_attention_heads": 6, "num_key_value_heads": 3, "hidden_size": 96}),
    "mixtral": ("MixtralForCausalLM", "MixtralConfig", "moe", "mixtral_tp_rules",
                {"capacity_factor": 0.5}),
    "gpt2": ("GPT2LMHeadModel", "GPT2Config", "gpt2", "gpt2_tp_rules", {}),
    "neox": ("GPTNeoXForCausalLM", "GPTNeoXConfig", "neox", "neox_tp_rules", {}),
    "opt": ("OPTForCausalLM", "OPTConfig", "opt", "opt_tp_rules", {}),
    "t5": ("T5ForConditionalGeneration", "T5Config", "t5", "t5_tp_rules", {"num_layers": 3}),
    "whisper": ("WhisperForConditionalGeneration", "WhisperConfig", "whisper",
                "whisper_tp_rules", {}),
    "bert": ("BertForMaskedLM", "BertConfig", "bert", "bert_tp_rules", {}),
    "vit": ("ViTForImageClassification", "ViTConfig", "vit", "vit_tp_rules", {}),
    "clip": ("CLIPModel", "CLIPConfig", "clip", "clip_tp_rules", {}),
}
TABLES = sorted({(f[2], f[3]) for f in FAMILIES.values()})


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _reset_port():
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()


@pytest.fixture(autouse=True)
def reset_port_state():
    yield
    _reset_port()


def _config(family, dtype=torch.float32, **kw):
    _, cfg_cls, _, _, knobs = FAMILIES[family]
    return getattr(M, cfg_cls).tiny(dtype=dtype, **{**knobs, **kw})


def _port_module(family, sd=None, device=None, **kw):
    cfg = _config(family, **kw)
    module = getattr(M, FAMILIES[family][0])(cfg, device=device)
    if sd is not None:
        module.load_state_dict(sd)
    return module


def _rules(family, scan_layers=True):
    return getattr(M, FAMILIES[family][3])(scan_layers)


def _weights(family, seed=0) -> dict:
    """numpy-seeded fp32 weights of the family's tiny module."""
    rng = np.random.default_rng(seed)
    cfg = _config(family)
    out = {}
    for name, p in _port_module(family).state_dict().items():
        if name == "encoder.embed_positions":  # Whisper's fixed sinusoids
            out[name] = p.clone()
            continue
        if p.dim() == 0:  # CLIP's logit_scale
            a = np.full((), 2.6592)
        elif p.dim() == 1:
            a = rng.standard_normal(p.shape) * 0.1 + (0.0 if name.endswith("bias") else 1.0)
        else:
            fan_in = p.shape[-2] if name.endswith(("router", "w_gate", "w_up", "w_down")) \
                else np.prod(p.shape[1:])
            a = rng.standard_normal(p.shape) / np.sqrt(fan_in)
            if name.endswith(".q.weight"):  # T5 scales no query
                a = a / np.sqrt(cfg.d_kv)
        out[name] = torch.from_numpy(np.asarray(a, np.float32))
    return out


def _inputs(family, seed=1) -> tuple:
    """The family's forward inputs (numpy)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 250, (2, 12)).astype(np.int64)
    pixels = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    if family == "t5":
        return ids[:, :10], rng.integers(2, 250, (2, 6)).astype(np.int64)
    if family == "whisper":
        return (rng.standard_normal((2, 20, 16)).astype(np.float32),
                rng.integers(2, 250, (2, 6)).astype(np.int64))
    if family == "bert":
        mask = np.ones_like(ids)
        mask[1, 8:] = 0
        return ids, mask
    if family == "vit":
        return (pixels,)
    if family == "clip":
        ids[:, -1] = 511
        return ids, pixels
    return (ids,)


def _batches(vocab=256):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(STEPS):
        ids = rng.integers(0, vocab, size=(BATCH, SEQ + 1))
        out.append({"x": ids[:, :-1], "y": ids[:, 1:]})
    return out


def _whole(t) -> np.ndarray:
    t = t.full_tensor() if hasattr(t, "full_tensor") else t
    return t.detach().float().numpy().copy()


# ---------------------------------------------------------------------------
# Rule tables and the plan (no processes)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scan_layers", [True, False], ids=["stacked", "unrolled"])
@pytest.mark.parametrize("module,fn", TABLES, ids=[t[1] for t in TABLES])
def test_rule_tables_equal_the_jax_tables(module, fn, scan_layers):
    jax_fn = getattr(importlib.import_module(f"accelerate_tpu.models.{module}"), fn)
    want = [(pattern, tuple(spec)) for pattern, spec in jax_fn(scan_layers)]
    assert _port_table(fn, scan_layers) == want


def _port_table(fn, scan_layers, ep_axes=()):
    from accelerate_tpu_torch.models import moe

    if ep_axes:
        return moe._mixtral_rules(scan_layers, ep_axes)
    return getattr(M, fn)(scan_layers)


def test_mixtral_ep_table_is_data_and_refused():
    """The EP table is the JAX one, by ep_axes too (expert parallelism is
    ported: tests/test_torch_expert_parallel.py). A plan of a mesh without
    ep prices such a table (its specs) and places no tensor on the ep
    axes; under ep the stacks go on them (``ParamPlacement.ep``)."""
    from torch.distributed.tensor import Shard

    from accelerate_tpu.models.moe import mixtral_tp_rules as jax_rules

    for axes in (("dp_shard",), ("dp_shard", "tp")):
        want = [(p, tuple(s)) for p, s in jax_rules(True, ep_axes=axes)]
        assert _port_table("mixtral_tp_rules", True, axes) == want
        assert M.mixtral_tp_rules(ep_axes=axes) == want
    module = _port_module("mixtral", device="meta")
    rules = _port_table("mixtral_tp_rules", True, ("dp_shard", "tp"))
    plan = sharding.plan_parameter_sharding(module, {"dp_shard": 2, "tp": 2}, tp_rules=rules)
    experts = [p for p in plan.values() if ("dp_shard", "tp") in p.spec]
    assert experts and all(p.tp is None and p.ep is None for p in experts)
    pc = ParallelismConfig(dp_shard_size=2, tp_size=2, ep_size=4)
    plan = sharding.plan_parameter_sharding(module, pc, parallelism_config=pc, tp_rules=rules)
    experts = [p for p in plan.values() if ("dp_shard", "tp") in p.spec]
    assert len(experts) == 6 and all(p.ep == Shard(0) and p.tp is None for p in experts)


def _jax_specs(family, sizes, rules, plugin_kw=None, **cfg_kw) -> dict:
    """The JAX plan's specs of the family's tiny model, by flax name."""
    import jax
    import jax.numpy as jnp

    from accelerate_tpu import FullyShardedDataParallelPlugin as JaxPlugin
    from accelerate_tpu import ParallelismConfig as JaxPC
    from accelerate_tpu.parallel.sharding import plan_parameter_sharding as jax_plan
    from accelerate_tpu.utils.estimate_memory import build_abstract_mesh

    cls, cfg_cls, mod, _, knobs = FAMILIES[family]
    jm = importlib.import_module(f"accelerate_tpu.models.{mod}")
    module = getattr(jm, cls)(getattr(jm, cfg_cls).tiny(dtype=jnp.float32,
                                                         **{**knobs, **cfg_kw}))
    args = [jnp.asarray(a) for a in _inputs(family)]
    shapes = jax.eval_shape(lambda r: module.init(r, *args), jax.random.key(0))["params"]
    pc = JaxPC(**{f"{ax}_size": n for ax, n in sizes.items()})
    plan = jax_plan(shapes, build_abstract_mesh(pc), parallelism_config=pc, tp_rules=rules,
                    fsdp_plugin=JaxPlugin(**plugin_kw) if plugin_kw is not None else None)
    out = {}
    for path, s in jax.tree_util.tree_flatten_with_path(plan)[0]:
        out["/".join(str(k.key) for k in path)] = tuple(s.spec)
    return out


def _rank_elements(placement_spec, leaf, w, rank, tp_size) -> np.ndarray:
    """The values of port tensor ``w`` that the JAX spec of its flax leaf
    gives ``tp`` rank ``rank`` (sorted)."""
    flax = leaf.to_flax(w).numpy()
    spec = placement_spec[1:] if leaf.index is not None else placement_spec
    for f, entry in enumerate(spec):
        if entry == "tp" or (isinstance(entry, tuple) and "tp" in entry):
            n = flax.shape[f] // tp_size
            flax = np.take(flax, np.arange(rank * n, (rank + 1) * n), axis=f)
    return np.sort(flax.ravel())


PLANS = {
    "tp2": ({"tp": 2}, None),
    "dp_shard2_tp2": ({"dp_shard": 2, "tp": 2}, None),
    "ignored": ({"dp_shard": 2, "tp": 2}, {"ignored_params": [r"embed", r"wte", r"shared"]}),
    # The pp rule: a stacked block leaf's free layer dim goes on pp.
    "pp2_dp_shard2_tp2": ({"pp": 2, "dp_shard": 2, "tp": 2}, None),
}
PLAN_CASES = [(f, t) for f in sorted(FAMILIES) for t in ("tp2", "dp_shard2_tp2")] + [
    ("llama", "ignored"), ("gpt2", "ignored"), ("t5", "ignored"),
    ("llama", "pp2_dp_shard2_tp2"), ("gpt2", "pp2_dp_shard2_tp2")]


@pytest.mark.parametrize("family,topology", PLAN_CASES, ids=[f"{f}-{t}" for f, t in PLAN_CASES])
def test_placements_equal_the_jax_plan(family, topology, caplog):
    """Each parameter's spec is the JAX plan's for its flax leaf (the TP
    rule, then FSDP's largest free dim over dp_shard, rank-1 and
    ``ignored_params`` whole); a split parameter's local shard on each rank
    holds exactly the elements the JAX spec gives that rank; GQA kv heads
    below tp stay whole with the JAX plan's warning."""
    sizes, plugin_kw = PLANS[topology]
    rules = _rules(family)
    want = _jax_specs(family, sizes, rules, plugin_kw)
    module = _port_module(family)
    plugin = FullyShardedDataParallelPlugin(**plugin_kw) if plugin_kw is not None else None
    with caplog.at_level(logging.WARNING, logger=sharding.__name__):
        plan = sharding.plan_parameter_sharding(module, sizes, fsdp_plugin=plugin,
                                                tp_rules=rules)
    assert set(plan) == {n for n, _ in module.named_parameters()}
    assert {p.flax_name for p in plan.values()} == set(want)
    for name, p in module.named_parameters():
        pl = plan[name]
        assert pl.spec == tuple(e for e in want[pl.flax_name]), name
        split = any(e == "tp" or (isinstance(e, tuple) and "tp" in e) for e in pl.spec)
        assert (pl.tp is not None) == split, name
        if pl.tp is None:
            continue
        leaf = convert.flax_leaf(module, name)
        w = torch.arange(p.numel(), dtype=torch.float64).reshape(p.shape)
        for rank in range(2):
            rows = tp.local_rows(p.shape[pl.tp.dim], pl.tp, rank, 2, "cpu")
            got = np.sort(w.index_select(pl.tp.dim, rows).numpy().ravel())
            np.testing.assert_array_equal(got, _rank_elements(pl.spec, leaf, w, rank, 2))
    warned = "not divisible by axis tp" in caplog.text
    assert warned == family.startswith("llama_gqa")
    if family.startswith("llama_gqa"):
        assert plan["model.layers.0.self_attn.k_proj.weight"].tp is None
        assert plan["model.layers.0.self_attn.q_proj.weight"].tp is not None
    if topology == "ignored":
        assert all(pl.spec == () for pl in plan.values() if "embed" in pl.flax_name
                   or "wte" in pl.flax_name or "shared" in pl.flax_name)


def test_parallelism_config_follows_the_jax_validation(monkeypatch):
    """tests/test_state_and_mesh.py's cases on the port's config: tp fills
    with dp_shard, an oversubscribed product names each axis and its
    variable, a product that does not divide says so, cp with sp is
    refused, the environment round trip keeps tp."""
    from accelerate_tpu import ParallelismConfig as JaxPC

    from accelerate_tpu_torch import ParallelismOversubscriptionError

    assert ParallelismConfig(tp_size=2).infer_missing_axis(8).dp_shard_size == 4
    assert ParallelismConfig(dp_shard_size=4, tp_size=2).total_size == 8
    with pytest.raises(ParallelismOversubscriptionError) as exc:
        ParallelismConfig(dp_shard_size=4, tp_size=4).infer_missing_axis(8)
    msg = str(exc.value)
    for part in ("dp_shard=4", "tp=4", "PARALLELISM_CONFIG_DP_SHARD_SIZE",
                 "PARALLELISM_CONFIG_TP_SIZE"):
        assert part in msg
    assert "does not divide" not in msg and isinstance(exc.value, ValueError)
    with pytest.raises(ValueError, match="does not divide") as exc:
        ParallelismConfig(tp_size=3).infer_missing_axis(8)
    assert not isinstance(exc.value, ParallelismOversubscriptionError)
    for bad in (dict(cp_size=2, sp_size=2), dict(dp_shard_size=0)):
        with pytest.raises(ValueError):
            ParallelismConfig(**bad)
    cfg = ParallelismConfig(dp_shard_size=2, tp_size=4, cp_rotate_method="allgather")
    assert cfg.to_env() == JaxPC(dp_shard_size=2, tp_size=4,
                                 cp_rotate_method="allgather").to_env()
    for k, v in cfg.to_env().items():
        monkeypatch.setenv(k, v)
    assert ParallelismConfig.from_env() == cfg


def test_rows_over_tp_and_refused_meshes():
    """Processes that differ only in tp read the same rows
    (``batch_axes``) and take tp innermost in the rank; tp with cp or sp
    is taken (each tp slice's sequence group); ep outside whole axes
    raises as the JAX constructor does; pp is taken."""
    pc = ParallelismConfig(dp_shard_size=2, tp_size=2)
    assert [pc.coordinates(r)["tp"] for r in range(4)] == [0, 1, 0, 1]
    assert [pc.data_parallel_index(r) for r in range(4)] == [0, 0, 1, 1]
    batch = {"x": np.arange(8)[:, None] * np.ones((1, 4), np.int64)}
    rows = [sharding.local_batch(batch, pc, r)["x"][:, 0].tolist() for r in range(4)]
    assert rows == [[0, 1, 2, 3], [0, 1, 2, 3], [4, 5, 6, 7], [4, 5, 6, 7]]
    assert pc.loss_reduce_axes == ("dp_replicate", "dp_shard", "cp", "sp")
    assert ParallelismConfig(dp_shard_size=2, tp_size=2).ep_axes == ()
    assert ParallelismConfig(pp_size=2, tp_size=2).total_size == 4
    with pytest.raises(ValueError, match="ep_size must divide"):
        ParallelismConfig(ep_size=2)
    pc = ParallelismConfig(tp_size=2, cp_size=2)
    assert [(pc.sequence_index(r), pc.coordinates(r)["tp"]) for r in range(4)] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]


# ---------------------------------------------------------------------------
# The jobs each spawned process runs
# ---------------------------------------------------------------------------


def _train(ctx, pc, mixed_precision="no", plugin=None, spy=None):
    """STEPS steps of the tiny Llama on this process's rows: metrics and
    the whole parameters after them."""
    rank = dist.get_rank()
    cfg = M.LlamaConfig.tiny(dtype=torch.float32)
    module = M.LlamaForCausalLM(cfg)
    module.load_state_dict(ctx["llama"])
    acc = Accelerator(cpu=True, parallelism_config=pc, mixed_precision=mixed_precision,
                      fsdp_plugin=plugin)
    model, _ = acc.prepare(Model(module, tp_rules=M.llama_tp_rules()), adamw(LR))
    step = acc.prepare_train_step(
        lambda m, b: cross_entropy_loss(m(b["x"].long()), b["y"].long()), max_grad_norm=1.0)
    metrics = []
    for b in ctx["batches"]:
        _, m = step(acc.train_state, {k: torch.from_numpy(v) for k, v in
                                      sharding.local_batch(b, pc, rank).items()})
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    out = {"metrics": metrics, "params": {n: _whole(p) for n, p in module.named_parameters()},
           "tp_rank": acc.tensor_parallel_rank, "dp_index": acc.state.data_parallel_index,
           "mesh": list(acc.mesh.mesh_dim_names), "sharded": model.sharded,
           "split": sorted(n for n, p in module.named_parameters() if tp.is_split(p))}
    _reset_port()
    return out


def _job_llama_fp32(ctx):
    fa = importlib.import_module("accelerate_tpu_torch.ops.flash_attention")
    heads, plain = [], fa.flash_attention

    def spy(q, k, v, **kw):
        heads.append((q.shape[2], k.shape[2]))
        return plain(q, k, v, **kw)

    fa.flash_attention = spy
    try:
        out = _train(ctx, ParallelismConfig(tp_size=2))
    finally:
        fa.flash_attention = plain
    out["flash_heads"] = sorted(set(heads))
    return out


def _job_llama_bf16(ctx):
    return _train(ctx, ParallelismConfig(tp_size=2), mixed_precision="bf16")


def _job_fsdp_tp(ctx):
    return _train(ctx, ParallelismConfig(dp_shard_size=2, tp_size=2),
                  plugin=FullyShardedDataParallelPlugin())


def _job_ddp_tp(ctx):
    return _train(ctx, ParallelismConfig(dp_replicate_size=2, tp_size=2))


def _job_families(ctx):
    out = {}
    for family in sorted(FAMILIES):
        module = _port_module(family, ctx["weights"][family])
        acc = Accelerator(cpu=True, parallelism_config=ParallelismConfig(tp_size=2))
        model = acc.prepare_model(Model(module, tp_rules=_rules(family)))
        with torch.no_grad():
            res = model(*[torch.from_numpy(a) for a in _inputs(family)])
        res = res if isinstance(res, tuple) else (res,)
        out[family] = {"outputs": [_whole(tp.gather_vocab(r)) for r in res],
                       "split": sum(tp.is_split(p) for p in module.parameters())}
        if family == "mixtral":
            out[family]["dropped"] = int(module.router_stats()["dropped"])
        _reset_port()
    return out


def _job_generate(ctx):
    """Greedy tokens at tp=2 (GPT-2's decode plan too); the fused loss and
    its head gradient over the vocab-split head."""
    out = {}
    for family in ("llama", "llama_gqa", "gpt2"):
        module = _port_module(family, ctx["weights"][family])
        acc = Accelerator(cpu=True, parallelism_config=ParallelismConfig(tp_size=2))
        model = acc.prepare_model(Model(module, tp_rules=_rules(family)))
        ids = torch.from_numpy(_inputs(family)[0][:, :8])
        out[family] = generate(model, ids, max_new_tokens=8).numpy()
        if family == "llama":
            loss = M.fused_cross_entropy_loss(model, ids, _labels(), chunk_size=4)
            loss.backward()
            out["fused"] = (float(loss), _whole(module.lm_head.weight.grad))
        _reset_port()
    return out


def _labels():
    labels = torch.from_numpy(_inputs("llama")[0][:, 1:9]).clone()
    labels[1, -3:] = -100
    return labels


def _job_save(ctx):
    """Two steps at tp=2, then save_state: the whole state at the save."""
    pc = ParallelismConfig(tp_size=2)
    rank = dist.get_rank()
    module = M.LlamaForCausalLM(M.LlamaConfig.tiny(dtype=torch.float32))
    module.load_state_dict(ctx["llama"])
    acc = Accelerator(cpu=True, parallelism_config=pc)
    model, _ = acc.prepare(Model(module, tp_rules=M.llama_tp_rules()), adamw(LR))
    step = acc.prepare_train_step(
        lambda m, b: cross_entropy_loss(m(b["x"].long()), b["y"].long()), max_grad_norm=1.0)
    for b in ctx["batches"][:2]:
        step(acc.train_state, {k: torch.from_numpy(v)
                               for k, v in sharding.local_batch(b, pc, rank).items()})
    acc.save_state(ctx["ckpt"])
    st = acc.train_state
    out = {"params": {n: _whole(p) for n, p in module.named_parameters()},
           "moments": {n: {k: _whole(st.optimizer.state[p][k]) for k in ("exp_avg", "exp_avg_sq")}
                       for n, p in module.named_parameters()}}
    _reset_port()
    return out


JOBS = {name[5:]: fn for name, fn in globals().items() if name.startswith("_job_")}


def _worker(rank, world, init_file, ctx_path, jobs):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    with open(ctx_path, "rb") as f:
        ctx = pickle.load(f)
    results = {job: JOBS[job](ctx) for job in jobs}
    gathered = [None] * world
    dist.all_gather_object(gathered, results)
    if rank == 0:
        with open(ctx_path + ".out", "wb") as f:
            pickle.dump(gathered, f)
    dist.destroy_process_group()


def _spawn(tmp, world, jobs, ctx) -> list:
    ctx_path = str(tmp / f"ctx{world}.pkl")
    with open(ctx_path, "wb") as f:
        pickle.dump(ctx, f)
    mp.start_processes(_worker, args=(world, str(tmp / f"rendezvous{world}"), ctx_path, jobs),
                       nprocs=world, join=True, start_method="spawn")
    with open(ctx_path + ".out", "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_gangs")
    weights = {f: _weights(f) for f in FAMILIES}
    ctx = {"weights": weights, "llama": weights["llama"], "batches": _batches(),
           "ckpt": str(tmp / "ckpt_tp2")}
    return {2: _spawn(tmp, 2, ["llama_fp32", "llama_bf16", "families", "generate", "save"], ctx),
            4: _spawn(tmp, 4, ["fsdp_tp", "ddp_tp"], ctx), "ctx": ctx}


# ---------------------------------------------------------------------------
# The JAX references
# ---------------------------------------------------------------------------


def _jax_reset():
    from accelerate_tpu.state import AcceleratorState as JS
    from accelerate_tpu.state import GradientState as JG
    from accelerate_tpu.state import PartialState as JP

    for cls in (JS, JG, JP):
        cls._reset_state()


def _flax(family, sd, **kw):
    import jax

    module = _port_module(family, device="meta", **kw)
    tree = convert.flax_converter(module).to_flax(module.config, sd)
    return jax.tree.map(lambda t: np.asarray(t.numpy()), tree)


def _jax_module(family, dtype="float32", **kw):
    import jax.numpy as jnp

    cls, cfg_cls, mod, _, knobs = FAMILIES[family]
    jm = importlib.import_module(f"accelerate_tpu.models.{mod}")
    return getattr(jm, cls)(getattr(jm, cfg_cls).tiny(dtype=getattr(jnp, dtype),
                                                      **{**knobs, **kw}))


_JAX_TRAIN: dict = {}


def _jax_train(ctx, mixed_precision="no"):
    """STEPS steps of the JAX Accelerator at dp_shard=4 × tp=2 with
    llama_tp_rules (tests/test_llama.py's fsdp_tp topology) on the whole
    global batches: metrics and the parameters after them (memoised)."""
    if mixed_precision in _JAX_TRAIN:
        return _JAX_TRAIN[mixed_precision]
    import jax
    import jax.numpy as jnp
    import optax

    from accelerate_tpu import Accelerator as JaxAccelerator
    from accelerate_tpu import Model as JaxModel
    from accelerate_tpu import ParallelismConfig as JaxPC
    from accelerate_tpu.models import cross_entropy_loss as jax_ce
    from accelerate_tpu.models import llama_tp_rules as jax_rules

    _jax_reset()
    module = _jax_module("llama")
    acc = JaxAccelerator(parallelism_config=JaxPC(dp_shard_size=4, tp_size=2),
                         mixed_precision=mixed_precision)
    model = JaxModel(module=module, params=_flax("llama", ctx["llama"]), tp_rules=jax_rules(True))
    acc.prepare(model, optax.adamw(LR))
    step = acc.prepare_train_step(
        lambda p, b: jax_ce(module.apply({"params": p}, b["x"]), b["y"]), max_grad_norm=1.0)
    metrics = []
    for b in ctx["batches"]:
        _, m = step(acc.train_state, {k: jnp.asarray(v, jnp.int32) for k, v in b.items()})
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    final = jax.tree.map(np.asarray, acc.train_state.params)
    _jax_reset()
    _JAX_TRAIN[mixed_precision] = (metrics, final)
    return _JAX_TRAIN[mixed_precision]


def _jax_forward_tp2(family, params):
    """The JAX module's forward at dp_shard=4 × tp=2: the parameters laid
    out by the JAX plan with the family's rules, GSPMD's program."""
    import jax
    import jax.numpy as jnp

    from accelerate_tpu import ParallelismConfig as JaxPC
    from accelerate_tpu.parallel.sharding import plan_parameter_sharding as jax_plan

    jm = importlib.import_module(f"accelerate_tpu.models.{FAMILIES[family][2]}")
    module = _jax_module(family)
    pc = JaxPC(dp_shard_size=4, tp_size=2)
    mesh = pc.build_mesh()
    rules = getattr(jm, FAMILIES[family][3])(True)
    placed = jax.device_put(params, jax_plan(params, mesh, parallelism_config=pc,
                                             tp_rules=rules))
    args = [jnp.asarray(a) for a in _inputs(family)]
    out = jax.jit(lambda p, *a: module.apply({"params": p}, *a))(placed, *args)
    return [np.asarray(o, np.float32) for o in (out if isinstance(out, tuple) else (out,))]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _assert_metrics(got, want, rtol):
    for (gl, gn), (wl, wn) in zip(got, want):
        assert abs(gl - wl) <= rtol * abs(wl), (got, want)
        assert abs(gn - wn) <= rtol * abs(wn), (got, want)


def _assert_weights(got: dict, want_tree, init: dict, atol: float):
    """The port's whole parameters against the JAX ones (in the port's
    layout). AdamW's m/√v turns the rounding of a near-zero gradient into a
    move of up to a whole step either way (tests/test_torch_distributed.py
    ``_assert_params_close``): every entry within STEPS·lr, at most 1e-4 of
    a tensor's entries (and 2) beyond ``atol``, each tensor's update within
    1e-2 of the JAX one's in norm."""
    import jax

    cfg = M.LlamaConfig.tiny(dtype=torch.float32)
    want = convert.llama_views_from_flax(
        cfg, jax.tree.map(lambda a: torch.from_numpy(np.array(a)), want_tree))
    for name, g in got.items():
        w, i = want[name].numpy(), init[name].numpy()
        diff = np.abs(g - w)
        assert diff.max() <= STEPS * LR, name
        assert (diff > atol).sum() <= 1e-4 * diff.size + 2, (name, diff.max())
        assert np.linalg.norm(diff) <= 1e-2 * np.linalg.norm(w - i), name


def _flat_tree(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        out.update(_flat_tree(v, name) if isinstance(v, dict) else {name: v})
    return out


# ---------------------------------------------------------------------------
# The gang tests
# ---------------------------------------------------------------------------


STEP_CASES = [(2, "llama_fp32", 1e-5), (4, "fsdp_tp", 1e-5), (4, "ddp_tp", 1e-5),
              (2, "llama_bf16", 2e-2)]


@pytest.mark.parametrize("world,job,rtol", STEP_CASES,
                         ids=["tp2-fp32", "dp_shard2_tp2-fp32", "dp_replicate2_tp2-fp32",
                              "tp2-bf16"])
def test_llama_steps_match_jax(runs, world, job, rtol):
    """Losses and grad norms of 3 steps within ``rtol`` of the JAX step's at
    its TP topology (every process alike); the weights after them as the
    JAX ones (fp32)."""
    bf16 = job.endswith("bf16")
    want_metrics, want_params = _jax_train(runs["ctx"], "bf16" if bf16 else "no")
    results = [r[job] for r in runs[world]]
    for r in results:
        _assert_metrics(r["metrics"], want_metrics, rtol)
        assert r["split"] and all("norm" not in n for n in r["split"])
    assert [r["tp_rank"] for r in results] == [0, 1] * (world // 2)
    assert [r["dp_index"] for r in results] == [i // 2 for i in range(world)]
    assert results[0]["mesh"] == ["pp", "dp_replicate", "dp_shard", "cp", "sp", "tp"]
    assert results[0]["sharded"] == (job == "fsdp_tp")
    if not bf16:
        _assert_weights(results[0]["params"], want_params, runs["ctx"]["llama"], 1e-5)


def test_flash_attention_runs_on_local_heads(runs):
    """Under tp=2 the tiny Llama's 4 q and 2 kv heads reach the flash
    kernel's wrapper as 2 and 1 on each rank."""
    for r in runs[2]:
        assert r["llama_fp32"]["flash_heads"] == [(2, 1)]


FORWARD = sorted(f for f in FAMILIES if f != "llama")


@pytest.mark.parametrize("family", FORWARD)
def test_family_forwards_match_jax_at_tp2(runs, family):
    """Every output of the forward at tp=2 (both ranks) within 1e-5 of the
    JAX module's at tp=2; Mixtral drops the JAX module's choices."""
    params = _flax(family, runs["ctx"]["weights"][family])
    want = _jax_forward_tp2(family, params)
    for r in runs[2]:
        got = r["families"][family]
        assert got["split"] > 0
        assert len(got["outputs"]) == len(want)
        for g, w in zip(got["outputs"], want):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    if family == "mixtral":
        drops = _jax_drops(params)
        assert drops > 0
        assert {r["families"][family]["dropped"] for r in runs[2]} == {drops}


def _jax_drops(params) -> int:
    """The choices the JAX Mixtral drops on the family's inputs."""
    import jax
    import jax.numpy as jnp

    from accelerate_tpu.models import moe as jax_moe

    module, dispatch, dropped = _jax_module("mixtral"), jax_moe.compute_dispatch, []

    def counting(probs, k, capacity):
        d, c = dispatch(probs, k, capacity)
        jax.debug.callback(lambda n: dropped.append(int(n)), probs.shape[0] * k - d.sum())
        return d, c

    jax_moe.compute_dispatch = counting
    try:
        module.apply({"params": params}, jnp.asarray(_inputs("mixtral")[0]))
        jax.effects_barrier()
    finally:
        jax_moe.compute_dispatch = dispatch
    return sum(dropped)


@pytest.mark.parametrize("family", ["llama", "llama_gqa"])
def test_generate_at_tp2_matches_jax_and_tp1(runs, family):
    """Greedy tokens at tp=2 (kv heads split, and kept whole below tp) equal
    the JAX package's generate at dp_shard=4 × tp=2 and the port's at
    tp=1; each step's top-2 logit gap is above MIN_GAP."""
    import jax.numpy as jnp

    from accelerate_tpu import Accelerator as JaxAccelerator
    from accelerate_tpu import Model as JaxModel
    from accelerate_tpu import ParallelismConfig as JaxPC
    from accelerate_tpu import generate as jax_generate

    sd = runs["ctx"]["weights"][family]
    ids = _inputs(family)[0][:, :8]
    module = _port_module(family, sd)
    with torch.no_grad():
        want = generate(module, torch.from_numpy(ids), max_new_tokens=8).numpy()
        logits = module(torch.from_numpy(want[:, :-1]))[:, 7:]
    top2 = torch.topk(logits.float(), 2, dim=-1).values
    assert float((top2[..., 0] - top2[..., 1]).min()) > MIN_GAP
    _jax_reset()
    jmodule = _jax_module(family)
    acc = JaxAccelerator(parallelism_config=JaxPC(dp_shard_size=4, tp_size=2))
    model = acc.prepare(JaxModel(module=jmodule, params=_flax(family, sd),
                                 tp_rules=_rules(family)))
    jax_out = np.asarray(jax_generate(model, jnp.asarray(ids, jnp.int32), max_new_tokens=8))
    _jax_reset()
    np.testing.assert_array_equal(jax_out, want)
    for r in runs[2]:
        np.testing.assert_array_equal(r["generate"][family], want)


def test_fused_loss_and_other_plans_at_tp2(runs):
    """The fused chunked loss over the vocab-split head (Gemma's path) gives
    the one-process loss and head gradient; generate of another family
    (GPT-2: its heads split by head, its vocab-split ``wte``) gives the
    one-process tokens (every family against the JAX package's:
    tests/test_torch_parallel_rest.py)."""
    module = _port_module("llama", runs["ctx"]["weights"]["llama"])
    ids = torch.from_numpy(_inputs("llama")[0][:, :8])
    loss = M.fused_cross_entropy_loss(module, ids, _labels(), chunk_size=4)
    loss.backward()
    naive = cross_entropy_loss(module(ids), _labels())
    for r in runs[2]:
        got_loss, got_grad = r["generate"]["fused"]
        assert abs(got_loss - float(loss)) <= 1e-5 * float(loss)
        assert abs(float(naive) - float(loss)) <= 1e-5 * float(loss)
        np.testing.assert_allclose(got_grad, module.lm_head.weight.grad.numpy(),
                                   rtol=1e-5, atol=1e-7)
    gpt2 = _port_module("gpt2", runs["ctx"]["weights"]["gpt2"])
    with torch.no_grad():
        want = generate(gpt2, torch.from_numpy(_inputs("gpt2")[0][:, :8]),
                        max_new_tokens=8).numpy()
    for r in runs[2]:
        np.testing.assert_array_equal(r["generate"]["gpt2"], want)


def test_tp2_checkpoint_resumes_at_tp1_in_both_packages(runs):
    """save_state at tp=2 writes whole tensors in the JAX package's
    directory contract: the port at tp=1 and the JAX package load every
    parameter and AdamW moment bit for bit."""
    import jax
    import optax

    from accelerate_tpu import Accelerator as JaxAccelerator
    from accelerate_tpu import Model as JaxModel

    saved = runs[2][0]["save"]
    ckpt = runs["ctx"]["ckpt"]
    module = M.LlamaForCausalLM(M.LlamaConfig.tiny(dtype=torch.float32))
    acc = Accelerator(cpu=True)
    acc.prepare(Model(module), adamw(LR))
    acc.load_state(ckpt)
    st = acc.train_state
    for n, p in module.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), saved["params"][n])
        for k in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_array_equal(st.optimizer.state[p][k].numpy(), saved["moments"][n][k])
    assert int(st.step) == 2
    _reset_port()

    _jax_reset()
    jmodule = _jax_module("llama")
    jacc = JaxAccelerator()
    jacc.prepare(JaxModel(module=jmodule, params=_flax("llama", _weights("llama", seed=5))),
                 optax.adamw(LR))
    jacc.load_state(ckpt)
    got = _flat_tree(jax.tree.map(np.asarray, jacc.train_state.params))
    want = _flat_tree(_flax("llama", {n: torch.from_numpy(v)
                                      for n, v in saved["params"].items()}))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert int(jacc.train_state.step) == 2
    _jax_reset()
