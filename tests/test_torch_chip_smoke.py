"""chip_smoke.py's pure pieces on the CPU: the kernels' bounds and the
profiler's kernel categories.

The script is loaded by its path, so the import does not depend on
sys.path; its top level imports no torch, and neither does this file.
"""

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
    ("void flash::flash_fwd_kernel<32>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "flash::FwdArgs)", "flash_fwd"),
    ("nvjet_tst_128x256_64x4_2x1_v_bz_coopA_TNN", "matmul"),
    ("void at::native::elementwise_kernel<128, 2>(int, ...)", "other kernels"),
])
def test_category_books_the_kernels_by_name(chip_smoke, name, category):
    assert chip_smoke._category(name) == category
