"""The roofline's counts against hand counts."""

import pytest

from h100bench import roofline as r


def test_operation_counts():
    assert r.xxh3_ops(35) == 19 * 2 * 2 + 14 == 90
    assert r.xxh3_ops(43) == 90 and r.xxh3_ops(17) == 52 and r.xxh3_ops(128) == 166
    assert r.ascii_ops(35) == 18 and r.ascii_ops(43) == 22
    assert r.canonical_packed_ops(35) == 36
    assert r.rolling_ops(43) == 4 + 4 * 3 + 6 + 3 * 3 + 2 * 2 + 2 == 37


def test_peaks():
    assert r.HBM_BYTES_PER_S == 3.35e12 and r.INT_OPS_PER_S == 33.5e12


def test_k1():
    # a million lanes: 28 MB over 3.35 TB/s against 167 M instructions
    # over 33.5 T a second
    t, by = r.k1_least_s(1_000_000, 35)
    assert by == "bytes" and t == pytest.approx(28e6 / 3.35e12)
    assert 1_000_000 * (36 + 18 + 90 + 23) / 33.5e12 < t


def test_k3():
    # 30.2 M windows in one piece: the bytes plus 42, and 16 B of key and a
    # flag written a window
    t, by = r.k3_least_s(30_200_000, 1, 43)
    assert by == "bytes" and t == pytest.approx((30_200_000 * 18 + 42) / 3.35e12)
    assert r.k3_least_s(30_200_000, 2, 43)[0] > t


def test_bound_picks_the_longer():
    assert r.bound_s(0, 33.5e12) == (1.0, "operations")
    assert r.bound_s(3.35e12, 0) == (1.0, "bytes")
