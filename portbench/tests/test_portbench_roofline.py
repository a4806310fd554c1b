"""The byte bounds of PERF.md's kernel tables, from portbench.roofline."""

import pytest

from portbench import roofline


def test_edt_pass_bound_at_512():
    # 2 * 2^28 * 4 B (both fields read and written once) at 3.35 TB/s.
    b = roofline.bound_seconds(roofline.edt_pass_bytes((512, 512, 512)))
    assert roofline.edt_pass_bytes((512, 512, 512)) == 2 * 2 ** 28 * 4
    assert b * 1e3 == pytest.approx(0.641, abs=5e-4)


def test_carve_bound_at_512():
    # 307,200 rays of 66 B read, two 512 MiB int32 grids written.
    n = roofline.carve_bytes(640 * 480, (512, 512, 512))
    assert roofline.CARVE_RAY_BYTES == 66
    assert n == 66 * 307200 + 2 * 4 * 512 ** 3
    assert roofline.bound_seconds(n) * 1e3 == pytest.approx(0.3266,
                                                            abs=5e-5)


def test_share_is_none_without_time():
    assert roofline.share_percent(1e-3, 0.0) is None
    assert roofline.share_percent(1e-3, 2e-3) == pytest.approx(50.0)
