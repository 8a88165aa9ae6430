"""chip_smoke.py's pure pieces on the CPU: the kernels' bounds, the SASS
check of the built libraries, the profiler's kernel categories, the decode
bound, the phase-7/8 gates, the serving trace, phase 9's gate, its
checkpoint directory and a rehearsal of the whole phase at a small width,
the rehearsals of phases 10 and 11, phase 12's gate and rehearsal, and
phases 13 and 14.

The script is loaded by its path, so the import does not depend on
sys.path; its top level imports no torch, and this file imports torch only
inside the phase-9 rehearsal.
"""

import copy
import importlib.util
import math
from pathlib import Path

import pytest


_PATH = Path(__file__).resolve().parent.parent / "chip_smoke.py"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the driver runs several test processes at once,
    and torch's spinning thread pools would contend for the cores."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", _PATH)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_bounds_at_the_training_shapes(chip_smoke):
    """B=4, S=2048, H=16, D=128, causal: operations bound all three."""
    bound = chip_smoke.bounds(4, 2048, 16, 16, 128)
    expected = {"flash_fwd": 0.0695, "flash_dq": 0.1043, "flash_dkv": 0.1390}
    for name, ms in expected.items():
        assert bound[name][0] == pytest.approx(ms, abs=5e-5), name
        assert bound[name][1] == "operations", name


@pytest.mark.parametrize("name,category", [
    ("void flash::flash_fwd_kernel<128>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "flash::FwdArgs)", "flash_fwd"),
    ("void flash::flash_dkv_kernel<128>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, flash::BwdArgs)", "flash_dkv"),
    ("void flash::flash_dq_kernel<128>(flash::BwdArgs)", "flash_dq"),
    ("void flash::flash_dq_kernel<128>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, flash::BwdArgs)", "flash_dq"),
    ("void flash::flash_fwd_kernel<32>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "flash::FwdArgs)", "flash_fwd"),
    ("nvjet_tst_128x256_64x4_2x1_v_bz_coopA_TNN", "matmul"),
    ("void at::native::elementwise_kernel<128, 2>(int, ...)", "other kernels"),
])
def test_category_books_the_kernels_by_name(chip_smoke, name, category):
    assert chip_smoke._category(name) == category


_KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")
# cuobjdump -sass counts of the four libraries as built for the H100 (D = 64,
# 128 and 256, bf16 and fp16 in the wgmma libraries, fp32 in flash_f32):
# wgmma and TMA loads in the first three and mma.sync in none; FMA on the
# CUDA cores and no tensor-core product in the fp32 one.
_SASS = {"flash_fwd": {"HGMMA": 208, "UTMALDG": 122, "HMMA": 0, "FFMA": 886},
         "flash_dq": {"HGMMA": 272, "UTMALDG": 168, "HMMA": 0, "FFMA": 320},
         "flash_dkv": {"HGMMA": 152, "UTMALDG": 56, "HMMA": 0, "FFMA": 160},
         "flash_f32": {"HGMMA": 0, "UTMALDG": 0, "HMMA": 0, "FFMA": 3033}}


@pytest.mark.parametrize("kernel,op,count,ok", [
    (None, None, None, True),
    ("flash_dq", "HMMA", 336, False),
    *[(k, "HGMMA", 0, False) for k in _KERNELS],
    *[(k, "UTMALDG", 0, False) for k in _KERNELS],
], ids=lambda x: str(x))
def test_sass_ok_needs_wgmma_and_tma_and_no_mma_sync(chip_smoke, kernel, op, count, ok):
    sass = copy.deepcopy(_SASS)
    if kernel is not None:
        sass[kernel][op] = count
    assert chip_smoke.sass_ok(sass) is ok


def test_sass_ok_needs_every_library(chip_smoke):
    assert not chip_smoke.sass_ok({k: v for k, v in _SASS.items() if k != "flash_dq"})
    assert not chip_smoke.sass_ok({k: v for k, v in _SASS.items() if k != "flash_f32"})


@pytest.mark.parametrize("op,count,ok", [
    ("FFMA", 0, False), ("HGMMA", 8, False), ("HMMA", 8, False), ("UTMALDG", 4, True)])
def test_sass_ok_judges_the_fp32_library_by_its_own_design(chip_smoke, op, count, ok):
    """flash_f32.cu multiplies on the CUDA cores: FMA and no tensor-core
    product; TMA loads would be allowed, though it has none."""
    sass = copy.deepcopy(_SASS)
    sass["flash_f32"][op] = count
    assert chip_smoke.sass_ok(sass) is ok
    assert chip_smoke.DESIGNS["flash_f32"] != chip_smoke.DESIGNS["flash_fwd"]


def test_bounds_by_dtype_and_padded_head_dim(chip_smoke):
    """fp16 shares bf16's tensor-core peak; fp32 runs on the CUDA cores at
    67 TFLOP/s with 4-byte elements; a padded head dim counts the unpadded
    work."""
    bf16 = chip_smoke.bounds(4, 2048, 16, 16, 128)
    assert chip_smoke.bounds(4, 2048, 16, 16, 128, "float16") == bf16
    f32 = chip_smoke.bounds(4, 2048, 16, 16, 128, "float32")
    for name in bf16:
        assert f32[name][0] == pytest.approx(bf16[name][0] * 989 / 67, rel=1e-9)
    d96 = chip_smoke.bounds(4, 2048, 16, 16, 96)
    assert d96["flash_fwd"][0] == pytest.approx(bf16["flash_fwd"][0] * 96 / 128, rel=1e-9)
    full = chip_smoke.bounds(2, 2048, 8, 1, 256, causal=False)
    causal = chip_smoke.bounds(2, 2048, 8, 1, 256)
    assert full["flash_dkv"][0] > 1.99 * causal["flash_dkv"][0]


def test_every_built_variant_is_timed_and_checked(chip_smoke):
    """Phase 3 times each dtype at each built head dim (and one padded head
    dim); phase 2's cases cover the same variants."""
    from accelerate_tpu_torch.ops import hopper_flash as hf

    timed = {(dtype, hf.built_head_dim(shape["d"]), shape["d"] in hf.BUILT_HEAD_DIMS)
             for _, dtype, shape, _ in chip_smoke.TIMED}
    built = {(dtype, w, True) for dtype in chip_smoke.TOLS for w in hf.BUILT_HEAD_DIMS}
    assert built <= timed and ("bfloat16", 128, False) in timed
    assert chip_smoke.TIMED[0][:3] == (None, "bfloat16", chip_smoke.SLICE)


def test_check_kernels_bookkeeping_on_the_cpu(chip_smoke):
    """check_kernels' plumbing with the plain versions standing in for the
    kernels on the CPU: the variant and library it names, padding and the
    tolerance of its dtype."""
    import torch

    from accelerate_tpu_torch.ops import hopper_flash as hf

    class PlainAsKernels:
        def __getattr__(self, name):
            return getattr(hf, name)

        def flash_fwd_cuda(self, *a, **kw):
            return hf.flash_fwd_plain(*a, **kw)

        def flash_dq_cuda(self, *a, **kw):
            return hf.flash_dq_plain(*a, **kw)

        def flash_dkv_cuda(self, *a, **kw):
            return hf.flash_dkv_plain(*a, **kw)

    for dtype, d, variant, library, padded in (
            ("float32", 80, "flash_dq.f32.d128", "flash_f32", 128),
            ("float16", 256, "flash_dq.f16.d256", "flash_fwd", None),
            ("bfloat16", 32, "flash_dq.bf16.d64", "flash_fwd", 64)):
        res = chip_smoke.check_kernels(PlainAsKernels(), "cpu", 1, 40, 4, 2, d, seed=1,
                                       dtype=dtype, device="cpu")
        assert res["ok"], res
        assert res["variants"]["flash_dq"] == variant and res["library"] == library
        assert res["padded_to"] == padded
        assert res["tolerance"]["out_rel"] == chip_smoke.TOLS[dtype][0]
    assert torch.get_default_dtype() == torch.float32


def test_kernel_summary_lists_every_timed_variant(chip_smoke):
    """One kernels-line entry per kernel of each timed variant, with the
    keys the contract names, the fp32 variants' source flash_f32.cu and the
    padded one named by its own head dim."""
    from accelerate_tpu_torch.ops import hopper_flash as hf
    import torch

    timed, cases = [], []
    for label, dtype, shape, paths in chip_smoke.TIMED:
        width = hf.built_head_dim(shape["d"])
        variants = {k: hf.variant(k, getattr(torch, dtype), width) for k in chip_smoke.KERNELS}
        padded = width if width != shape["d"] else None
        timed.append({"name": label, "paths": paths, "dtype": dtype, "shape": shape,
                      "padded_to": padded,
                      "variants": variants, "ms": dict.fromkeys(chip_smoke.KERNELS, 2.0),
                      "plain_ms": dict.fromkeys(chip_smoke.KERNELS, 9.0),
                      "bound": chip_smoke.bounds(*shape.values(), dtype),
                      "library_ms": {"flash_fwd": 1.5, "flash_dq+flash_dkv": 3.0}})
        cases.append({"variants": variants, "padded_to": padded,
                      "max_abs": dict.fromkeys(chip_smoke.KERNELS, 1e-3)})
    main_path = {"variant_launches": {"flash_fwd.bf16.d128": 126, "flash_dq.bf16.d128": 126,
                                      "flash_dkv.bf16.d128": 126}}
    lines = chip_smoke.kernel_summary(timed, cases, main_path)
    assert len(lines) == 3 * len(chip_smoke.TIMED)
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms"}
    assert all(keys <= set(line) for line in lines)
    by_name = {line["name"]: line for line in lines}
    assert by_name["flash_fwd.bf16.d128"]["launches"] == 126
    assert by_name["flash_dkv.f32.d256"]["source"].endswith("flash_f32.cu")
    assert by_name["flash_dq.bf16.d96"]["runs"] == "flash_dq.bf16.d128"
    assert by_name["flash_dq.bf16.d96"]["launches"] == 0
    assert by_name["flash_fwd.f16.d64"]["library_ms"] == 1.5
    assert by_name["flash_dq.f16.d64"]["library_ms"] is None


# ---------------------------------------------------------------------------
# Phases 7 and 8: the decode bound and the gates
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("weight_bytes,gb,ms", [(2, 1.9810, 0.5913), (1, 1.0577, 0.3157)])
def test_decode_bound_per_token_of_the_1b_llama(chip_smoke, weight_bytes, gb, ms):
    """924.9M block + 65.5M head parameters: ≈ 1.98 GB in bf16, ≈ 1.06 GB
    with int8 blocks (plus their scales), at 3.35 TB/s."""
    bound_ms, nbytes = chip_smoke.decode_bound(chip_smoke.FULL_WIDTH, weight_bytes)
    assert nbytes / 1e9 == pytest.approx(gb, abs=5e-4)
    assert bound_ms == pytest.approx(ms, abs=5e-4)


def test_decode_bound_counts_the_kv_cache_read(chip_smoke):
    """Each cached position adds K and V of 18 layers × 2048 bf16 values."""
    base = chip_smoke.decode_bound(chip_smoke.FULL_WIDTH, 2)[1]
    assert chip_smoke.decode_bound(chip_smoke.FULL_WIDTH, 2, ctx=80)[1] - base == \
        80 * 18 * 2 * 2048 * 2


_GAPS = [[0.5, 0.3, 5e-5, 0.2], [0.1, 0.1, 0.1, 0.1]]


@pytest.mark.parametrize("got,expected", [
    ([[1, 2, 3, 4], [5, 6, 7, 8]], [None, None]),
    ([[1, 2, 9, 9], [5, 6, 7, 8]], [{"pos": 2, "gap": 5e-5, "near_tie": True}, None]),
    ([[1, 9, 3, 4], [5, 6, 7, 8]], [{"pos": 1, "gap": 0.3, "near_tie": False}, None]),
    ([[1, 2, 3, 4], [5, 6, 7, 9]], [None, {"pos": 3, "gap": 0.1, "near_tie": False}]),
    # Row 0 parts at a near-tie; row 1 is still compared, and is wrong.
    ([[1, 2, 9, 9], [5, 9, 7, 8]], [{"pos": 2, "gap": 5e-5, "near_tie": True},
                                    {"pos": 1, "gap": 0.1, "near_tie": False}]),
], ids=["equal", "near_tie", "wrong", "wrong_last", "near_tie_then_wrong_row"])
def test_first_divergence_applies_the_near_tie_rule(chip_smoke, got, expected):
    ref = [[1, 2, 3, 4], [5, 6, 7, 8]]
    div = chip_smoke.first_divergence(ref, got, _GAPS)
    assert div == expected
    assert chip_smoke.parity_ok(div) is all(d is None or d["near_tie"] for d in expected)


def _gen_result(tiny=None, in_vocab=True, finite=True):
    full = {"tokens_in_vocab": True, "logits_finite": True}
    return {"tiny": {"plain": [None, None], "left_padded_eos": [None, tiny]},
            "full_width": {"bf16": dict(full),
                           "int8": {"tokens_in_vocab": in_vocab, "logits_finite": finite}}}


@pytest.mark.parametrize("kw,ok", [
    ({}, True),
    ({"tiny": {"pos": 4, "gap": 2e-5, "near_tie": True}}, True),
    ({"tiny": {"pos": 4, "gap": 0.4, "near_tie": False}}, False),
    ({"in_vocab": False}, False),
    ({"finite": False}, False),
], ids=["ok", "near_tie", "diverged", "token_out_of_vocab", "nonfinite_logits"])
def test_generate_gate(chip_smoke, kw, ok):
    assert chip_smoke.generate_gate(_gen_result(**kw)) is ok


_PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8]]
_BUDGETS = [4, 2]


def _rows(new=7):
    return [p + [new] * b for p, b in zip(_PROMPTS, _BUDGETS)]


def _stats(completed=2, tokens_out=6):
    return {"requests_completed": completed, "tokens_out": tokens_out}


@pytest.mark.parametrize("rows,stats,ok", [
    (_rows(), _stats(), True),
    (_rows(), _stats(tokens_out=5), False),
    ([_rows()[0][:-1], _rows()[1]], _stats(), False),
    ([[9] + _rows()[0][1:], _rows()[1]], _stats(), False),
    (_rows(new=50), _stats(), False),
    (_rows()[:1], _stats(completed=1), False),
], ids=["full_budgets", "short_count", "short_row", "prompt_changed", "token_out_of_vocab",
        "missing_request"])
def test_serving_gate(chip_smoke, rows, stats, ok):
    assert chip_smoke.serving_gate(rows, _PROMPTS, _BUDGETS, stats, vocab=50) is ok


def test_serving_trace_is_generate_bench_serving_row(chip_smoke):
    """The trace draws what benchmarks/generate_bench.py's Poisson serving
    row draws, in its order, from default_rng(1)."""
    import numpy as np

    lengths, budgets, prompts, arrivals = chip_smoke.serving_trace(
        32000, **chip_smoke.SERVING_ROW)
    rng = np.random.default_rng(1)
    n = 32
    np.testing.assert_array_equal(lengths, rng.integers(4, 64, n))
    short = rng.random(n) < 0.5
    short_b, long_ = rng.integers(4, 12, n), rng.integers(32, 65, n)
    np.testing.assert_array_equal(budgets, np.where(short, short_b, long_))
    for prompt, n_tok in zip(prompts, lengths):
        np.testing.assert_array_equal(prompt, rng.integers(1, 32000, (n_tok,), dtype=np.int32))
    np.testing.assert_array_equal(arrivals, np.cumsum(rng.exponential(1 / 8.0, n)))
    assert ((budgets >= 4) & (budgets <= 64)).all() and np.all(np.diff(arrivals) > 0)


# ---------------------------------------------------------------------------
# Phase 9: the training loop
# ---------------------------------------------------------------------------

_TINY_WIDTH = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                   num_attention_heads=4, num_key_value_heads=2)


def _loop_run(**change):
    run = {"indices": [[1, 2], [3, 4]], "loss": [5.25, 5.5], "grad_norm": [1.5, 1.25],
           "lr": [3e-4, 2.9e-4]}
    run.update(change)
    return run


def _gate(chip_smoke, first=None, resumed=None, lrs=(3e-4, 2.9e-4), after_load=4, after=8,
          launches=None, native_ok=True):
    loop = dict(chip_smoke.LOOP, steps=6)  # two steps after the save
    chip_smoke.LOOP, saved = loop, chip_smoke.LOOP
    try:
        return chip_smoke.loop_gate(
            first or _loop_run(), resumed or _loop_run(), list(lrs), after_load, after - 2,
            launches or [({"flash_fwd": 12, "flash_dq": 12}, 6), ({"flash_fwd": 4}, 2)],
            2, native_ok)
    finally:
        chip_smoke.LOOP = saved


@pytest.mark.parametrize("kw,failed", [
    ({}, None),
    ({"resumed": _loop_run(indices=[[1, 2], [4, 3]])}, "same_indices"),
    ({"resumed": _loop_run(loss=[5.25, 5.500000000000001])}, "bit_equal_loss"),
    ({"resumed": _loop_run(grad_norm=[1.5, 1.2500001])}, "bit_equal_grad_norm"),
    ({"lrs": (3e-4, 2.8e-4)}, "lr_follows_schedule"),
    ({"first": _loop_run(grad_norm=[float("inf"), 1.25]),
      "resumed": _loop_run(grad_norm=[float("inf"), 1.25])}, "finite"),
    ({"after_load": 0}, "step_after_load"),
    ({"after": 7}, "step_after"),
    ({"launches": [({"flash_fwd": 12}, 6), ({"flash_fwd": 3}, 2)]}, "launches"),
    ({"native_ok": False}, "native"),
], ids=["ok", "indices", "loss_one_ulp", "grad_norm", "lr", "inf", "step_after_load",
        "step_after", "launches", "native"])
def test_loop_gate(chip_smoke, kw, failed):
    checks = _gate(chip_smoke, **kw)
    assert checks["ok"] is (failed is None)
    assert [k for k, v in checks.items() if not v and k != "ok"] == ([failed] if failed else [])


def test_llama_n_params_is_the_modules_count(chip_smoke):
    import torch

    from accelerate_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    for width in (chip_smoke.FULL_WIDTH, _TINY_WIDTH):
        module = LlamaForCausalLM(LlamaConfig(**width), device="meta")
        assert chip_smoke.llama_n_params(width) == sum(p.numel() for p in module.parameters())
    assert chip_smoke.llama_n_params(chip_smoke.FULL_WIDTH) == 1_055_991_808
    del torch


def test_checkpoint_root_falls_back_when_the_temporary_directory_is_small(
        chip_smoke, tmp_path, monkeypatch):
    import shutil
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "tmp"))
    (tmp_path / "tmp").mkdir()
    fallback = tmp_path / "fallback"
    real = shutil.disk_usage

    def usage(path):
        free = 10 if str(path).startswith(str(tmp_path / "tmp")) else 10**6
        return real(path)._replace(free=free)

    monkeypatch.setattr(shutil, "disk_usage", usage)
    root, disk = chip_smoke.checkpoint_root(8, fallback=fallback)
    assert root.startswith(str(tmp_path / "tmp")) and disk["free_bytes"] == 10
    root, disk = chip_smoke.checkpoint_root(1000, fallback=fallback)
    assert root.startswith(str(fallback)) and disk["free_bytes"] == 10**6
    assert len(disk["tried_free_bytes"]) == 2 and list(fallback.iterdir()) == [Path(root)]
    with pytest.raises(RuntimeError, match="no directory"):
        chip_smoke.checkpoint_root(10**7, fallback=fallback)


def test_loop_phase_rehearsed_on_the_cpu(chip_smoke, monkeypatch):
    """The whole phase at a small width on the CPU: the resumed run takes
    the same samples, rates, losses and grad norms. The flash wrappers take
    their plain versions here, so no kernel launches, and the checkpoint is
    too small for the native writer: those two checks fail here only."""
    import torch

    from accelerate_tpu_torch.ops import hopper_flash as hf
    from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("max_memory_allocated", "memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    try:
        res = chip_smoke.loop_phase(hf, 1.0, device="cpu", width=_TINY_WIDTH, seq=32,
                                    profile_steps=0)
    finally:
        for cls in (AcceleratorState, GradientState, PartialState):
            cls._reset_state()
    failed = sorted(k for k, v in res["checks"].items() if not v)
    assert failed == ["launches", "native", "ok"]
    assert res["step_count"] == 8 and len(res["resumed"]["loss"]) == 4
    assert res["resumed"]["lr"] == res["after_save"]["lr"]
    assert res["save"]["bytes"] > 3 * 4 * chip_smoke.llama_n_params(_TINY_WIDTH)
    assert res["native"]["paths"]["pwrite_segments"] == {"native": 0, "plain": 1}
    assert not Path(res["checkpoint_disk"]["dir"]).exists()


# ---------------------------------------------------------------------------
# Phase 10: FSDP2 and DDP over a process group of one, in a child process
# ---------------------------------------------------------------------------


def test_data_parallel_child_rehearsed_on_the_cpu(chip_smoke, monkeypatch):
    """The whole phase on the CPU at a small width: phases 4 and 5 in this
    process without a group, then ``chip_smoke.py --child`` with torchrun's
    environment, which joins a gloo group of one, shards phase 5's model
    with FSDP2 and runs phase 9's loop and phase 4's step under DDP. The
    plain versions stand in for the kernels here, so no kernel launches,
    and the checkpoint is too small for the native writer: the launch
    checks fail here only. Phase 4's step with ring and Ulysses attention
    over the 6-D mesh of one process gives phase 4's numbers bit for bit."""
    import torch

    from accelerate_tpu_torch.ops import hopper_flash as hf
    from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    kw = dict(width=_TINY_WIDTH, seq=32, batch_size=4)
    try:
        main = chip_smoke.full_width_steps(hf, device="cpu", **kw)
        fused = chip_smoke.accumulation_run(hf, loop=False, device="cpu", profile=False, **kw)
        assert not main["sharded"] and main["variant_launches"] == {}
        cfg, weights, batch = chip_smoke._tiny_step_inputs()
        tiny, ddp = chip_smoke.tiny_step(cfg, weights, batch, cpu=True)
        assert not ddp
    finally:
        for cls in (AcceleratorState, GradientState, PartialState):
            cls._reset_state()
    args = {"device": "cpu", "kw": {**kw, "profile": False},
            "phase5": {"first_metrics": main["first_metrics"], "step_ms": main["step_ms"],
                       "peak_mem_gib": 0.0},
            "tiny_step": tiny}
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the child's intra-op threads
    rc, lines, err = chip_smoke.run_child(args, timeout=300)
    assert lines, err
    res = lines[-1]
    failed = sorted(k for k, v in res["checks"].items() if not v)
    assert failed == ["dcp_loop_resumes_bit_equal", "launches", "loop_resumes_bit_equal", "ok",
                      "strategies_match_phase4"], (failed, err)
    assert rc == 1
    assert res["group"] == {"backend": "gloo", "world": 1, "distributed_type": "MULTI_CPU"}
    assert res["fsdp2"]["sharded"] and all(res["collectives"].values())
    assert max(max(r) for r in res["fsdp2"]["rel_to_phase5"]) <= chip_smoke.DP_REL_TOL
    assert sorted(k for k, v in res["loop"]["checks"].items() if not v) == [
        "launches", "native", "ok"]
    assert res["ddp_tiny"]["rel"]["loss"] <= chip_smoke.DP_REL_TOL
    assert len(res["loop"]["resumed"]["loss"]) == 4
    assert res["mesh"] == [["pp", "dp_replicate", "dp_shard", "cp", "sp", "tp"],
                           [1, 1, 1, 1, 1, 1]]
    assert res["seq_tiny"] == {"ring": tiny, "ulysses": tiny}
    # Phase 14 (a)'s overflow under FSDP2.
    assert res["fp16"]["sharded"] and res["checks"]["fp16_overflow_skipped"]
    # Phase 12 (c): the imperative loop under FSDP2 against the fused step
    # of this process, as phase 12 holds it.
    imperative = res["imperative"]
    assert imperative["sharded"] and imperative["loop"] == "imperative"
    assert imperative["sync_flags"] == [False, False, False, True] * 3
    for got, ref in zip(imperative["metrics"], fused["metrics"]):
        assert max(chip_smoke._rel(a, b) for a, b in zip(got, ref)) <= chip_smoke.DP_REL_TOL
    # Phase 15 (c), at phase 4's tiny width: the DCP loop under FSDP2
    # resumes bit-equal (its launch check fails here only), and every
    # strategy keeps phase 4's numbers.
    dcp_loop = res["phase15"]["dcp_loop"]
    assert sorted(k for k, v in dcp_loop["checks"].items() if not v) == ["launches", "ok"]
    assert dcp_loop["state_dict_type"] == "DISTRIBUTED_STATE_DICT"
    assert dcp_loop["save"]["format"] == "dcp" and dcp_loop["load"]["format"] == "dcp"
    assert dcp_loop["n_params"] == chip_smoke.llama_n_params(chip_smoke.TINY_WIDTH)
    strategies = res["phase15"]["strategies"]
    assert sorted(strategies) == sorted(chip_smoke.STRATEGY_RUNS)
    for name, run in strategies.items():
        assert max(run["rel_to_phase4"].values()) <= chip_smoke.DP_REL_TOL, name
        assert run["ddp"] == (name == "NO_SHARD")
        assert not any(run["launches"].values())
    assert strategies["zero2"]["sharding_strategy"] == "SHARD_GRAD_OP"


def test_distributed_checkpoint_phase_rehearsed_on_the_cpu(chip_smoke, monkeypatch):
    """Phase 15 (a) and (b) at a small width on the CPU: the blocking and
    the asynchronous DCP save both resume bit-equal (their launch checks
    fail here only: the plain versions stand in for the kernels); the
    asynchronous save was in flight while steps 5 and 6 ran. (c) comes
    from the child (test_data_parallel_child_rehearsed_on_the_cpu); here a
    report that passes stands in for it."""
    import torch

    from accelerate_tpu_torch.ops import hopper_flash as hf
    from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("max_memory_allocated", "memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    phase9 = {"phase5_fixed_batch_step_ms": 1.0, "save": {"seconds": 2.0, "bytes": 10},
              "load": {"seconds": 1.0}}
    child = {"phase15": {"dcp_loop": {"ok": True},
                         "strategies": {n: {"ok": True} for n in chip_smoke.STRATEGY_RUNS}},
             "fsdp2": {"step_ms": 1.0}}
    calls = []
    real_save = chip_smoke.loop_phase

    def loop_phase(*a, **k):
        calls.append((k["state_dict_type"], k.get("async_save", False)))
        return real_save(*a, **{**k, "width": _TINY_WIDTH, "seq": 32})

    monkeypatch.setattr(chip_smoke, "loop_phase", loop_phase)
    try:
        res = chip_smoke.distributed_checkpoint_phase(hf, phase9, child, device="cpu")
    finally:
        for cls in (AcceleratorState, GradientState, PartialState):
            cls._reset_state()
    assert calls == [("DISTRIBUTED_STATE_DICT", False), ("DISTRIBUTED_STATE_DICT", True)]
    failed = sorted(k for k, v in res["checks"].items() if not v)
    assert set(failed) - {"async_returned_before_persisting"} == {
        "async_resumes_bit_equal", "dcp_resumes_bit_equal", "ok"}
    for run in (res["blocking"], res["background"]):
        assert sorted(k for k, v in run["checks"].items() if not v) == ["launches", "ok"]
        assert run["save"]["format"] == run["load"]["format"] == "dcp"
        assert run["resumed"]["loss"] == run["after_save"]["loss"]
        assert not Path(run["checkpoint_disk"]["dir"]).exists()
    background = res["background"]["save"]
    assert not background["blocking"] and background["bytes"] > 0
    assert res["async"]["staged_bytes"] >= 3 * 4 * chip_smoke.llama_n_params(_TINY_WIDTH)
    assert res["async"]["stall_s"] > 0 and res["async"]["wait_for_checkpoint_s"] >= 0
    assert res["async"]["second_save_stall_s"] > 0  # the second save, removed once written
    assert res["save"]["safetensors_phase9"]["gb_per_s"] == 10 / 2.0 / 1e9
    assert set(res["strategies"]) == set(chip_smoke.STRATEGY_RUNS)


def test_torchrun_env_is_a_group_of_one(chip_smoke):
    env = chip_smoke.torchrun_env(29512)
    assert env["WORLD_SIZE"] == "1" and env["RANK"] == env["LOCAL_RANK"] == "0"
    assert env["MASTER_PORT"] == "29512" and env["MASTER_ADDR"] == "127.0.0.1"
    assert 0 < chip_smoke.free_port() < 65536


# ---------------------------------------------------------------------------
# Phase 11: ring attention and Ulysses, every rank's share in one process
# ---------------------------------------------------------------------------


def _stub_cuda(chip_smoke, monkeypatch):
    import torch

    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda fn, iters, warmup=2: (fn(), 0.0)[1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sequence_parallel_attention_rehearsed_on_the_cpu(chip_smoke, monkeypatch, dtype):
    """Phase 11 (a) at a tiny GQA shape on the plain versions: the ring
    (both rotate methods) and Ulysses over 4 virtual ranks against one
    plain call on the whole sequence, within the dtype's tolerance. No
    kernel launches here, so only the gate's launch counts fail."""
    from accelerate_tpu_torch.ops import hopper_flash as hf

    _stub_cuda(chip_smoke, monkeypatch)
    res = chip_smoke.sequence_parallel_attention(hf, 1, 64, 4, 2, 16, n=4, dtype=dtype,
                                                 device="cpu", iters=1)
    assert res["shape"] == dict(b=1, s=64, hq=4, hkv=2, d=16) and res["ranks"] == 4
    for method in ("alltoall", "allgather", "ulysses"):
        assert res[method]["ok"], (method, res[method]["errors"])
        assert res[method]["launches"] == {k: 0 for k in chip_smoke.KERNELS}
    assert not chip_smoke.attention_gate([res])


def _attention_case(ok=True, ring=16, other=4):
    launches = {"alltoall": ring, "allgather": other, "ulysses": other}
    return {"ranks": 4, **{m: {"ok": ok, "launches": {k: n for k in _KERNELS}}
                           for m, n in launches.items()}}


@pytest.mark.parametrize("case,ok", [
    (_attention_case(), True), (_attention_case(ok=False), False),
    (_attention_case(ring=4), False), (_attention_case(other=16), False)],
    ids=["passes", "outside_tolerance", "ring_launches", "allgather_launches"])
def test_attention_gate(chip_smoke, case, ok):
    assert chip_smoke.attention_gate([case]) is ok


def _seq_row(policy="flash", fwd=16, loss_rel=1e-4, gnorm_rel=1e-3, first_loss=10.4):
    return {"remat_policy": policy, "losses": [first_loss, 10.3, 10.2], "ln_vocab": 10.37,
            "n_layers": 18, "launches_per_step": {k: 18.0 for k in _KERNELS},
            "ring_step": {"rel": {"loss": loss_rel, "grad_norm": gnorm_rel},
                          "launches_per_layer": {"flash_fwd": fwd, "flash_dq": 16,
                                                 "flash_dkv": 16}}}


@pytest.mark.parametrize("row,ok", [
    (_seq_row(), True), (_seq_row("minimal", fwd=32), True), (_seq_row(fwd=32), False),
    (_seq_row(loss_rel=2e-3), False), (_seq_row(gnorm_rel=3e-2), False),
    (_seq_row(first_loss=12.0), False)],
    ids=["flash", "minimal_recomputes", "flash_recomputed", "loss", "grad_norm", "start"])
def test_seq_row_gate(chip_smoke, row, ok):
    assert chip_smoke.seq_row_gate(row) is ok


def test_seq_row_rehearsed_on_the_cpu(chip_smoke, monkeypatch):
    """Phase 11 (b) at a small width on the CPU: the flash steps, then one
    step through the 4-rank ring schedule on the same weights, within the
    gate's loss and grad-norm bounds. Under remat "flash" each block runs
    the forward 16 times (4 ranks × 4 steps) and its recompute none; the
    plain versions stand in for the kernels, so the launch checks fail
    here only."""
    from accelerate_tpu_torch.ops import hopper_flash as hf
    from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

    _stub_cuda(chip_smoke, monkeypatch)
    calls = []
    plain = hf.flash_fwd_plain
    monkeypatch.setattr(hf, "flash_fwd_plain", lambda *a, **k: calls.append(1) or plain(*a, **k))
    try:
        row = chip_smoke.seq_row_steps(hf, device="cpu", width=_TINY_WIDTH, batch_size=2,
                                       seq=64, profile=False)
    finally:
        for cls in (AcceleratorState, GradientState, PartialState):
            cls._reset_state()
    ring = row["ring_step"]
    assert row["remat_policy"] == "flash" and row["seq"] == 64 and row["steps"] == 5
    assert ring["rel"]["loss"] <= chip_smoke.SEQ_LOSS_RTOL
    assert ring["rel"]["grad_norm"] <= chip_smoke.SEQ_GNORM_RTOL
    assert ring["launches"] == {k: 0 for k in chip_smoke.KERNELS}
    # 5 flash steps of 2 layers, then two ring steps of 2 layers × 16 chunks.
    assert len(calls) == 5 * 2 + 2 * 2 * 16
    assert not chip_smoke.seq_row_gate(row)
    assert chip_smoke.seq_row_gate({**row, "launches_per_step": {
        k: 2.0 for k in chip_smoke.KERNELS}, "ring_step": {**ring, "launches_per_layer": {
            "flash_fwd": 16, "flash_dq": 16, "flash_dkv": 16}}})


# ---------------------------------------------------------------------------
# Phase 12: the imperative loop against the fused step, and the batch search
# ---------------------------------------------------------------------------


def _acc_run(loop=True, metrics=((10.4, 2.0), (10.3, 1.9), (10.2, 1.8)), launches=72,
             flags=None, sharded=False):
    return {"loop": "imperative" if loop else "fused", "ga": 4, "steps": 3, "n_layers": 6,
            "sharded": sharded, "optimizer_steps": 3, "metrics": [list(m) for m in metrics],
            "launches": {k: launches for k in _KERNELS},
            "sync_flags": ([False] * 3 + [True]) * 3 if flags is None and loop else flags or []}


def _search(size=16, before=10 * 2**30, after=10 * 2**30):
    return {"start": 64, "batch_size": size, "allocated_before": before,
            "allocated_after": after}


_OFF = ((10.4 * (1 + 2e-4), 2.0), (10.3, 1.9), (10.2, 1.8))


@pytest.mark.parametrize("loop,search,fsdp,failed", [
    (_acc_run(), _search(), _acc_run(sharded=True), []),
    (_acc_run(metrics=_OFF), _search(), _acc_run(sharded=True), ["loop_matches_fused"]),
    (_acc_run(launches=18), _search(), _acc_run(sharded=True), ["launches"]),
    (_acc_run(flags=[True] * 12), _search(), _acc_run(sharded=True), ["windows"]),
    (_acc_run(), _search(size=64), _acc_run(sharded=True), ["search_settled_below_start"]),
    (_acc_run(), _search(after=10 * 2**30 + 65 * 2**20), _acc_run(sharded=True),
     ["search_gave_memory_back"]),
    (_acc_run(), _search(), _acc_run(), ["fsdp2_loop_matches_fused"]),
    (_acc_run(), _search(), _acc_run(sharded=True, metrics=_OFF),
     ["fsdp2_loop_matches_fused"]),
    (_acc_run(), _search(), _acc_run(sharded=True, launches=0), ["fsdp2_loop_launches"]),
    (_acc_run(), _search(), None, ["fsdp2_loop_launches", "fsdp2_loop_matches_fused"]),
], ids=["passes", "loss", "launches", "windows", "no_halving", "memory_kept", "fsdp_unsharded",
        "fsdp_numbers", "fsdp_launches", "no_child_run"])
def test_imperative_gate(chip_smoke, loop, search, fsdp, failed):
    checks = chip_smoke.imperative_gate(_acc_run(loop=False), loop, search, fsdp)
    assert sorted(k for k, v in checks.items() if not v) == sorted(failed + ["ok"] if failed else [])


def test_imperative_phase_rehearsed_on_the_cpu(chip_smoke, monkeypatch):
    """Phase 12 (a) and (b) at a small width on the CPU (bf16 over fp32
    masters, the plain versions for the kernels): the loop gives the fused
    step's losses and grad norms bit for bit, since 1/4 scales exactly;
    the batch search halves from 64 rows down to 16, where an allocation
    failure stands in for the card's above 16 rows. No kernel launches and
    no child run here: those checks fail here only."""
    import torch

    from accelerate_tpu_torch.ops import hopper_flash as hf
    from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

    _stub_cuda(chip_smoke, monkeypatch)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda *a, **k: 0)
    search = chip_smoke.batch_size_search

    def limited_search(acc, opt, loss_fn, cfg, **kw):
        def loss_within_memory(model, batch):
            if batch["x"].shape[0] > 16:
                raise torch.OutOfMemoryError("CUDA out of memory (a stand-in)")
            return loss_fn(model, batch)

        return search(acc, opt, loss_within_memory, cfg, **kw)

    monkeypatch.setattr(chip_smoke, "batch_size_search", limited_search)
    try:
        res = chip_smoke.imperative_phase(hf, None, device="cpu", width=_TINY_WIDTH, seq=32,
                                          batch_size=4, profile=False)
    finally:
        for cls in (AcceleratorState, GradientState, PartialState):
            cls._reset_state()
    failed = sorted(k for k, v in res["checks"].items() if not v)
    assert failed == ["fsdp2_loop_launches", "fsdp2_loop_matches_fused", "launches", "ok"]
    assert res["bit_equal"] and res["loop"]["optimizer_steps"] == 3
    assert res["loop"]["sync_flags"] == [False, False, False, True] * 3
    assert res["batch_search"]["tried"] == [64, 32, 16]
    assert res["batch_search"]["halvings"] == 2
    assert all(math.isfinite(x) for m in res["fused"]["metrics"] for x in m)


# ---------------------------------------------------------------------------
# Phase 13: the loop and the engine with the library's observability on
# ---------------------------------------------------------------------------


def test_counted_flops_model_at_full_width(chip_smoke):
    """What capture_cost should count a step of the 1.06B Llama at batch 4,
    seq 2048, beside bench.py's model: 0.894 of it, the embedding and the
    causal half of attention apart."""
    f = chip_smoke.counted_flops_model(chip_smoke.FULL_WIDTH, 4, 2048)
    assert f["bench_model"] == 59325812834304 and f["counted_model"] == 53010600296448
    assert (f["bench_model"] - f["embedding_in_bench"] - f["attention_in_bench"]
            + f["attention_counted"] - f["counted_model"]) == 6 * 37 * 2048 * 4 * 2048


@pytest.mark.parametrize("terms,wall,ok", [
    ({"a": 0.1, "b": 0.2}, 0.3, True),
    ({"a": 0.100000001, "b": 0.2}, 0.3, True),      # a nanosecond of rounding
    ({"a": 0.100000005, "b": 0.2}, 0.3, False),
    ({"a": 0.0, "b": 0.0}, 1e-3, False),
])
def test_sums_to_wall_allows_the_rounding_only(chip_smoke, terms, wall, ok):
    assert chip_smoke.sums_to_wall({"terms": terms, "wall_s": wall}) is ok


def test_trace_launches_counts_the_flash_kernels(chip_smoke, tmp_path):
    import json

    events = [{"cat": "kernel", "name": "void flash::flash_fwd_kernel<128>(CUtensorMap_st)"},
              {"cat": "kernel", "name": "void flash::flash_dq_kernel<128>(flash::BwdArgs)"},
              {"cat": "kernel", "name": "void flash::flash_dq_kernel<128>(flash::BwdArgs)"},
              {"cat": "cpu_op", "name": "flash_dkv_kernel"},
              {"cat": "kernel", "name": "nvjet_tst_128x256"}]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    assert chip_smoke.trace_launches(path) == {"flash_fwd": 1, "flash_dq": 2, "flash_dkv": 0}


def test_observed_phase_rehearsed_on_the_cpu(chip_smoke, monkeypatch):
    """Phase 13 at a small width on the CPU: trackers (TensorBoard is
    installed here), the telemetry JSONL, the profiler's records, the
    traced window, the flight bundle, the cost of telemetry, the
    imperative window and the engine. The plain versions stand in for the
    kernels (no launches) and ``max_memory_allocated`` is stubbed (the
    CPU's gauge is a census of live tensors): those checks fail here only.
    The engine replays 8 of the serving row's requests at 64 per second."""
    import torch

    from accelerate_tpu_torch.ops import hopper_flash as hf
    from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

    _stub_cuda(chip_smoke, monkeypatch)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda *a, **k: 0)
    try:
        res = chip_smoke.observed_phase(hf, device="cpu", width=_TINY_WIDTH, seq=32,
                                        serving_row=dict(chip_smoke.SERVING_ROW, requests=8,
                                                         qps=64.0))
    finally:
        for cls in (AcceleratorState, GradientState, PartialState):
            cls._reset_state()
    failed = sorted(k for k, v in res["checks"].items() if not v)
    assert failed == ["hbm_peak_matches", "imperative_launches", "launches", "ok",
                      "trace_launches"]
    assert res["trackers"] == ["json", "tensorboard"] and not res["tracker_warnings"]
    assert res["flops"]["counted"] == res["flops"]["counted_model"]
    assert res["trace_dirs"] == ["cycle_0"] and res["flight_entries"] == 8
    assert [r["step"] for r in res["step_records"]] == list(range(1, 9))
    assert res["telemetry_cost"]["syncs_equal"] and len(res["telemetry_cost"]["blocks"]) == 2
    assert res["imperative"]["sync_flags"] == [False, False, False, True]
    assert res["serving"]["tick_records"] == res["serving"]["ticks"] > 0
    assert [r["telemetry"] for r in res["serving"]["replays"]] == [False, True]


# ---------------------------------------------------------------------------
# Phase 14: reduced precision
# ---------------------------------------------------------------------------

_OVERFLOW_OK = {"params_bit_equal": True, "moments_bit_equal": True, "scale_backed_off": True,
                "step_held": True, "next_applied": True}
_BF16_SYNCS = {"cudaStreamSynchronize": 0.0, "cudaDeviceSynchronize": 1.0,
               "cudaEventSynchronize": 0.0, "memcpy_dtoh": 0.0}


def _fp16_run(steps=12, skipped=(0, 1), losses=None, launches=18, overflow=None, syncs=None,
              sharded=False):
    per_step = [{"loss": (losses or {}).get(i, 10.4), "grad_norm": 1.0, "scale": 1.0,
                 "skipped": i in skipped} for i in range(steps)]
    return {"n_layers": 18, "steps": steps, "per_step": per_step, "ln_vocab": math.log(32000),
            "overflowed_steps": len(skipped), "sharded": sharded,
            "variant_launches": {f"{k}.f16.d128": launches * steps for k in _KERNELS},
            "overflow": {**_OVERFLOW_OK, **(overflow or {})},
            "profile": {"syncs": {**_BF16_SYNCS, **(syncs or {})}}}


def _fp8_run(steps=12, scaled_mm=None, first=10.45, last=10.0, launches=18):
    return {"n_layers": 18, "steps": steps, "losses": [first] + [10.2] * (steps - 2) + [last],
            "paths": {"scaled_mm": 21 * 18 * steps if scaled_mm is None else scaled_mm,
                      "dequantized": 0, "plain": 0},
            "variant_launches": {f"{k}.bf16.d128": launches * steps for k in _KERNELS}}


def _linear(ok=True, codes=True):
    return [{"ok": ok, "codes_equal": codes}] * 9


@pytest.mark.parametrize("change,failed", [
    ({}, []),
    ({"fp16": _fp16_run(losses={0: 12.0})}, ["fp16_losses"]),
    ({"fp16": _fp16_run(losses={5: float("nan")})}, ["fp16_losses"]),
    ({"fp16": _fp16_run(skipped=range(12))}, ["fp16_applied"]),
    ({"fp16": _fp16_run(launches=17)}, ["fp16_flash_launches"]),
    ({"fp16": _fp16_run(overflow={"moments_bit_equal": False})}, ["overflow_moments_bit_equal"]),
    ({"fp16": _fp16_run(overflow={"scale_backed_off": False})}, ["overflow_scale_backed_off"]),
    ({"fp16": _fp16_run(syncs={"memcpy_dtoh": 1.0})}, ["fp16_no_added_sync"]),
    ({"fp16": _fp16_run(syncs={"cudaDeviceSynchronize": 2.0})}, []),
    ({"fp8": _fp8_run(scaled_mm=21 * 18 * 12 - 1)}, ["fp8_on_scaled_mm"]),
    ({"fp8": _fp8_run(first=11.2)}, ["fp8_first_loss"]),
    ({"fp8": _fp8_run(last=10.5)}, ["fp8_descends"]),
    ({"linear": _linear(ok=False)}, ["linear_within_tolerance"]),
    ({"linear": _linear(codes=False)}, ["quantize_bit_equal"]),
    ({"dp": _fp16_run(steps=1, skipped=(), sharded=False)}, ["fsdp2_fp16_overflow"]),
    ({"dp": _fp16_run(steps=1, skipped=(), sharded=True, overflow={"step_held": False})},
     ["fsdp2_fp16_overflow"]),
], ids=["ok", "first_loss", "nan", "all_skipped", "launches", "moments", "scale", "dtoh",
        "device_sync_counted_apart", "fallback", "fp8_loss", "fp8_flat", "linear", "codes",
        "dp_unsharded", "dp_step"])
def test_precision_gate(chip_smoke, change, failed):
    """Phase 14's checks: a D2H copy fails the step, the measurement's own
    device synchronisation does not; one fp8 product off ``_scaled_mm``
    fails the fp8 step."""
    runs = {"fp16": _fp16_run(), "fp8": _fp8_run(), "linear": _linear(),
            "dp": _fp16_run(steps=1, skipped=(), sharded=True), **change}
    checks = chip_smoke.precision_gate(runs["fp16"], runs["fp8"], runs["linear"],
                                       {"losses": [10.4]}, _BF16_SYNCS, runs["dp"])
    assert sorted(k for k, v in checks.items() if not v) == sorted(failed + ["ok"] if failed
                                                                   else [])


def test_precision_phase_rehearsed_on_the_cpu(chip_smoke, monkeypatch):
    """Phase 14 at a small width on the CPU (the plain versions for the
    flash kernels and the fp8 products): the fp16 step with its injected
    overflow (parameters, moments and counts bit-equal, the scale halved,
    the next step applied) and no synchronisation in a profiled step; the
    fp8 step's 21 products a layer a step and its first loss against the
    bf16 step's; the fp8 linear equal to its plain version. No kernel
    launch and no ``_scaled_mm`` here, and no child run: those checks fail
    here only."""
    import torch

    from accelerate_tpu_torch.ops import hopper_flash as hf
    from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

    _stub_cuda(chip_smoke, monkeypatch)
    try:
        main = chip_smoke.full_width_steps(hf, device="cpu", width=_TINY_WIDTH, seq=32,
                                           batch_size=4)
        res = chip_smoke.precision_phase(hf, main, _BF16_SYNCS, None, device="cpu",
                                         width=_TINY_WIDTH, seq=32, batch_size=4,
                                         linear_shapes=((64, 32, 48),))
    finally:
        for cls in (AcceleratorState, GradientState, PartialState):
            cls._reset_state()
    failed = sorted(k for k, v in res["checks"].items() if not v)
    assert failed == ["fp16_flash_launches", "fp8_flash_launches", "fp8_on_scaled_mm",
                      "fsdp2_fp16_overflow", "linear_within_tolerance", "ok"]
    fp16, fp8 = res["fp16"], res["fp8"]
    assert fp16["overflow"]["after"]["scale"] == fp16["overflow"]["before"]["scale"] / 2
    assert not any(fp16["profile"]["syncs"].values())
    assert fp8["paths"] == {"scaled_mm": 0, "dequantized": 0, "plain": 21 * 2 * 12}
    assert set(fp8["profile"]["split_ms"]) == {"fp8_gemm", "quantization", "flash", "rest"}
    assert fp8["fp8_speedup"] > 0 and torch.cuda.max_memory_allocated() == 0
    for case in res["fp8_linear"]:
        assert case["codes_equal"] and max(case["rel_err"].values()) == 0.0
        assert case["paths"] == {"scaled_mm": 0, "dequantized": 0, "plain": 3}


# ---------------------------------------------------------------------------
# Phase 16: serving, the rest
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy,n,cap,shed", [
    ("reject", 32, 8, list(range(8, 32))), ("shed_oldest", 32, 8, list(range(24))),
    ("block", 32, 8, []), ("reject", 5, 8, []), ("shed_oldest", 8, 8, []),
    ("reject", 9, 8, [8]), ("shed_oldest", 9, 8, [0])])
def test_expected_shed_is_the_queue_arithmetic(chip_smoke, policy, n, cap, shed):
    assert chip_smoke.expected_shed(policy, n, cap) == shed


@pytest.mark.parametrize("k_row,gap,ok", [
    ([4, 5, 6, 7], None, True),        # equal rows
    ([4, 5, 9, 1], 0.05, True),        # parted at a step whose gap is under the tie gap
    ([4, 5, 9, 1], 0.5, False),        # parted where the 0 run's choice was clear
])
def test_tie_gap_gate_on_speculative_rows(chip_smoke, k_row, gap, ok):
    gaps = [0.9, 0.8, 0.7 if gap is None else gap, 0.6]
    div = chip_smoke.first_divergence([[4, 5, 6, 7]], [k_row], [gaps], tie_gap=0.1)
    assert chip_smoke.parity_ok(div) is ok
    if gap is not None:
        assert div[0]["pos"] == 2 and div[0]["gap"] == gap


@pytest.mark.parametrize("head_dim", [64, 128, 256])
def test_int8_bytes_ratio_of_the_slot_caches(chip_smoke, head_dim):
    """The int8 slot cache's bytes against a 16-bit one's: exactly
    (D + 4) / (2 D) (0.516 at D = 128)."""
    import torch

    from accelerate_tpu_torch import generation as gen
    from accelerate_tpu_torch.models import LlamaConfig

    cfg = LlamaConfig(**dict(_TINY_WIDTH, hidden_size=4 * head_dim), head_dim=head_dim,
                      dtype=torch.bfloat16)
    q = gen.init_slot_cache(cfg, 3, 24, dtype=torch.int8)
    b = gen.init_slot_cache(cfg, 3, 24)
    int8_bytes, bf16_bytes = q.k.nbytes + q.v.nbytes, b.k.nbytes + b.v.nbytes
    assert chip_smoke.int8_bytes_ok(int8_bytes, bf16_bytes, head_dim)
    assert not chip_smoke.int8_bytes_ok(int8_bytes + 1, bf16_bytes, head_dim)
    if head_dim == 128:
        assert round(int8_bytes / bf16_bytes, 3) == 0.516


def test_speculation_counts_ok(chip_smoke):
    rows = [{"drafted": 8, "accepted": 3}, {"drafted": 4, "accepted": 4}]
    assert chip_smoke.speculation_counts_ok(rows, {"drafted": 12, "accepted": 7})
    assert not chip_smoke.speculation_counts_ok(rows, {"drafted": 12, "accepted": 6})
    assert not chip_smoke.speculation_counts_ok([{"drafted": 2, "accepted": 3}],
                                                {"drafted": 2, "accepted": 3})


def test_serving_rest_phase_rehearsed_on_the_cpu(chip_smoke, monkeypatch):
    """Phase 16 on the CPU at a small width: (a) with the CPU standing in
    for the card, (b)-(e) with 8 requests of the serving row at 64 per
    second, short deadlines and budgets, (b)'s speculate_k=0 run on phase
    8's trace taken from phase 8's replay (``full_width_serving``) as the
    script passes it. Every check passes here too. One intra-op thread:
    its thousands of small ops stall when they contend with other test
    workers for the cores."""
    import torch

    from accelerate_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from accelerate_tpu_torch.ops import hopper_flash as hf

    _stub_cuda(chip_smoke, monkeypatch)
    row = dict(chip_smoke.SERVING_ROW, requests=8, qps=64.0, new_tokens=16)
    rest = dict(chip_smoke.SERVING_REST, burst=12, queue_depth=3, deadline_s=0.15,
                deadline_budget=120, poison_budget=8)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        module = LlamaForCausalLM(LlamaConfig(**_TINY_WIDTH, max_position_embeddings=2048,
                                              dtype=torch.bfloat16))
        module.init_weights(torch.Generator().manual_seed(0))
        module.to(torch.bfloat16)
        serving = chip_smoke.full_width_serving(module, row, keep_rows=True)
        phase8 = {"rows": serving["_rows"], "stats": serving["stats"],
                  **{k: serving[k] for k in ("wall_s", "tok_s", "peak_mem_gib", "decode_ticks",
                                             "max_len", "kv_cache_bytes")}}
        res = chip_smoke.serving_rest_phase(hf, phase7=25.0, device="cpu", width=_TINY_WIDTH,
                                            row=row, rest=rest, phase8=phase8)
    finally:
        torch.set_num_threads(threads)
    assert sorted(k for k, v in res["checks"].items() if not v) == []
    assert res["speculation"]["runs"]["phase8_k0"]["from_phase8"]
    assert res["variant_launches"] == {}
    assert res["admission"]["burst"]["reject"]["faults"]["sheds"] == 9
    assert res["speculation"]["runs"]["repetitive_k4"]["speculation"]["acceptance_rate"] > 0
    assert res["int8_pages"]["bytes_ratio"] == res["int8_pages"]["bytes_ratio_expected"]
