"""The roofline arithmetic and the union of device intervals."""

import numpy as np
import pytest

from portbench import roofline
from portbench.harness import kernel_base


def test_union_counts_overlaps_once():
    assert roofline.union_seconds([]) == 0.0
    assert roofline.union_seconds([(0, 10)]) == pytest.approx(10e-6)
    # a copy under a kernel, a kernel inside another, a gap, touching ends
    ivs = [(0, 10), (5, 12), (6, 7), (20, 30), (30, 31), (25, 26)]
    assert roofline.union_seconds(ivs) == pytest.approx((12 + 11) * 1e-6)
    assert roofline.union_seconds(list(reversed(ivs))) == \
        roofline.union_seconds(ivs)


def test_drain_bound_bytes_and_operations():
    # bytes: 32 lane bytes + the 44-byte row read, and what the hits change
    assert roofline.ROW_BYTES == 44
    t_bytes = (1000 * (16 + 16 + 44) + 5000) / 3.35e12
    t_ops = 1000 * 300 / (132 * 64 * 1.98e9)
    assert t_bytes > t_ops
    assert roofline.drain_bound_s(1000, 5000) == pytest.approx(t_bytes)
    assert roofline.INT32_OPS_PER_S == pytest.approx(16.727e12, rel=1e-4)
    assert roofline.drain_bound_s(0, 0) == 0.0


def test_row_work_counts_distinct_keys_and_their_writes():
    # keys 3, 5, 7, 9; 5 twice with a hit once; 7 only read; 9 a token hit
    idx = np.array([3, 5, 5, 7, 9, 3])
    hits = np.array([1, 0, 2, 0, 1, 1])
    algos = np.array([1, 1, 1, 1, 0, 1])
    rows, written = roofline.row_work(idx, hits, algos)
    assert rows == 4
    assert written == 16 + 16 + 0 + 8
    assert roofline.row_work(idx, np.zeros(6), algos) == (4, 0)


def test_kernel_base_names():
    assert kernel_base("void drain_compact_kernel(long const*, int)") == \
        "drain_compact_kernel"
    assert kernel_base("drain_compact_kernel") == "drain_compact_kernel"
    assert kernel_base("(anonymous namespace)::drain_compact_kernel(long "
                       "const*, long const*, int)") == "drain_compact_kernel"
    assert kernel_base("void at::native::f<4>(int)") == "f"
    assert kernel_base("void foo<1, true>(Args)") == "foo"
    assert kernel_base("Memcpy HtoD (Pinned -> Device)") == \
        "Memcpy HtoD"
