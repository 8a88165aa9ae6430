"""chip_smoke.py's pure pieces on the CPU: the kernels' bounds, the SASS
check of the built libraries and the profiler's kernel categories.

The script is loaded by its path, so the import does not depend on
sys.path; its top level imports no torch, and neither does this file.
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
