"""The NTT's least time at the fast path's and the wide path's widths."""

import pytest

from harness import roofline as RF


def test_fast_width_is_bytes_bound():
    # chip_smoke.py's ntt_bound: (16, 6, 8192) in 3.756 us at 3.35 TB/s
    shape = (16, 6, 8192)
    t = RF.ntt_bound_s(shape, wide=False)
    assert t == pytest.approx(2 * 16 * 6 * 8192 * 8 / 3.35e12)
    assert t * 1e6 == pytest.approx(3.756, abs=1e-3)
    ops = 16 * 6 * 4096 * 13 * 8
    assert ops / RF.INT32_OPS_PER_S < t


def test_wide_width_counts_four_int32_operations_an_operation():
    shape = (192, 2, 3, 8192)
    polys = 192 * 2 * 3
    ops = polys * 4096 * 13 * 8 * 4
    t = RF.ntt_bound_s(shape, wide=True)
    assert t == pytest.approx(ops / RF.INT32_OPS_PER_S)
    assert t > 2 * polys * 8192 * 8 / RF.MEM_BYTES_PER_S   # operations bound it


def test_peaks_are_the_data_sheet_s():
    assert RF.MEM_BYTES_PER_S == 3.35e12
    assert RF.INT32_OPS_PER_S == pytest.approx(16.73e12, rel=1e-3)
