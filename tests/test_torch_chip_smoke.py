"""chip_smoke.py's pure pieces on the CPU: the kernels' bounds, the SASS
check of the built libraries, the profiler's kernel categories, the decode
bound, the phase-7/8 gates, the serving trace, and phase 9's gate, its
checkpoint directory and a rehearsal of the whole phase at a small width.

The script is loaded by its path, so the import does not depend on
sys.path; its top level imports no torch, and this file imports torch only
inside the phase-9 rehearsal.
"""

import copy
import importlib.util
from pathlib import Path

import pytest

_PATH = Path(__file__).resolve().parent.parent / "chip_smoke.py"


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
# cuobjdump -sass counts of the three libraries as built for the H100 (D = 32,
# 64 and 128 each): wgmma and TMA loads in all three, mma.sync in none.
_SASS = {"flash_fwd": {"HGMMA": 76, "UTMALDG": 44, "HMMA": 0},
         "flash_dq": {"HGMMA": 80, "UTMALDG": 48, "HMMA": 0},
         "flash_dkv": {"HGMMA": 52, "UTMALDG": 16, "HMMA": 0}}


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
