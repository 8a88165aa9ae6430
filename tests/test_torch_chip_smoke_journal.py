"""chip_smoke.py's phase 27 (request tracing and the crash-durable journal)
rehearsed on the CPU at narrow widths: (a) the engine served four ways (no
tracer and no journal, then a tracer with the journal under each fsync
policy) with equal rows and host syncs, explain()'s terms, the Chrome
trace and the metrics text, a swap mid-trace and a canary window rolled
back; (c) the traced training loop with a save and a load; (b)
``chip_smoke.py --journal-child`` really dying by ``engine_crash`` (exit
78) and the recovery of its two journals in this process. The script is
loaded by its path; the CUDA calls of the phases are no-ops here, so only
the flash launch count fails (and the step-time comparison may: CPU
timings say nothing of the card), and a gate on edited lines fails each
part.
"""

import copy
import importlib.util
from pathlib import Path

import pytest
import torch

_PATH = Path(__file__).resolve().parent.parent / "chip_smoke.py"
NARROW_LLAMA = dict(vocab_size=256, hidden_size=128, intermediate_size=384, num_hidden_layers=1,
                    num_attention_heads=4, num_key_value_heads=4)
FT_ROW = dict(layers=2, batch=2, seq=32)
ENGINE = dict(requests=8, prompt_len=8, new_tokens=6, slots=4, repeats=1, profiled_ticks=1,
              swap_after=2)
NO_KERNELS = {"c_flash_launched"}
CPU_TIMING = {"c_step_ms_within_spread"}


def _load():
    spec = importlib.util.spec_from_file_location("chip_smoke", _PATH)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def chip_smoke():
    return _load()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _reset():
    from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()


@pytest.fixture(scope="module")
def rehearsal(chip_smoke):
    from accelerate_tpu_torch.ops import hopper_flash as hf

    mp_ = pytest.MonkeyPatch()
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        mp_.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("max_memory_allocated", "memory_allocated"):
        mp_.setattr(torch.cuda, name, lambda *a, **k: 0)
    mp_.setenv("OMP_NUM_THREADS", "1")
    try:
        _reset()
        res = chip_smoke.journal_phase(hf, device="cpu", width=dict(chip_smoke.FULL_WIDTH,
                                                                    **NARROW_LLAMA),
                                       row={**chip_smoke.FT_ROW, **FT_ROW},
                                       spec={**chip_smoke.JOURNAL_ENGINE, **ENGINE})
    finally:
        mp_.undo()
        _reset()
    return res


def test_journal_phase_rehearsed_on_the_cpu(rehearsal):
    """Every check of phase 27 passes but the flash launch count (and, on
    this host's clock, perhaps the step-time comparison)."""
    res = rehearsal
    failed = {k for k, v in res["checks"].items() if not v}
    assert NO_KERNELS <= failed <= NO_KERNELS | CPU_TIMING, (failed, res["b"]["child"])
    a, b = res["a"], res["b"]
    assert set(a["modes"]) == {"off", "every_tick", "every_record", "os"}
    assert a["modes"]["os"]["journal"][0]["fsyncs"] == 0
    assert a["swap"]["in_flight_at_swap"] > 0 and a["swap"]["versions_left"] == [1]
    assert a["canary"]["status"]["routed_candidate"] == 2
    assert b["child"]["exit"] == 78 and b["cached"] > 0 and b["replayed"] > 0
    assert b["summaries"]["s"]["corrupt_skipped"] == 1 and b["recent_spans"] > 0
    assert res["c"]["checkpoint_s"]["checkpoint_save"]["event"] > 0


def test_a_failing_metric_fails_each_part(chip_smoke, rehearsal):
    """The gate fails on a failed check of any part (a row one token off
    fails (a)'s row comparison), and passes the rehearsal's own parts but
    for the checks only the card can pass."""
    import numpy as np

    row = {"tokens": np.arange(6)}
    edited = {"tokens": np.arange(6) + (np.arange(6) == 5)}
    assert chip_smoke._same_rows([row], [dict(row)])
    assert not chip_smoke._same_rows([row], [edited])
    parts = {p: rehearsal[p] for p in ("a", "b", "c")}
    gate = chip_smoke.journal_gate(**parts)
    assert {k for k, v in gate["checks"].items() if not v} <= NO_KERNELS | CPU_TIMING
    for part, check in (("a", "rows_bit_equal_all_modes"), ("b", "child_exit_78"),
                        ("c", "checkpoint_spans_last_their_seconds")):
        moved = copy.deepcopy(parts)
        moved[part]["checks"][check] = False
        gate = chip_smoke.journal_gate(**moved)
        assert not gate["ok"] and not gate["checks"][f"{part}_{check}"]
