"""The yardstick's arithmetic on hand-worked shapes, and the trace
reader's interval sums."""

import pytest

from perfbench import arith, trace


def test_attention_cost_hand_worked():
    # (2, 6, 1024, 64) self-attention in bf16: 4 * 2*6*1024*1024*64 ops;
    # q, k, v and the output, 2*6*1024*64 elements each, 2 bytes
    ops, nbytes = arith.attention_cost((2, 6, 1024, 64), (2, 6, 1024, 64), 2)
    assert ops == 4 * 2 * 6 * 1024 * 1024 * 64 == 3221225472
    assert nbytes == 4 * 2 * 6 * 1024 * 64 * 2 == 6291456


def test_attention_cost_cross():
    # 1024 queries over 256 keys: products scale with Tq * Tk, bytes with
    # 2 Tq + 2 Tk rows
    ops, nbytes = arith.attention_cost((1, 1, 1024, 64), (1, 1, 256, 64), 4)
    assert ops == 4 * 1024 * 256 * 64
    assert nbytes == 4 * 64 * (2 * 1024 + 2 * 256)


def test_conv3x3_cost_hand_worked():
    # 256 -> 256 at 128^2, batch 4, bf16: 18 * 4 * 256 * 128^2 * 256 ops
    ops, nbytes = arith.conv3x3_cost((4, 256, 128, 128), 256, 2)
    assert ops == 18 * 4 * 256 * 128 * 128 * 256 == 77309411328
    assert nbytes == 2 * (2 * 4 * 256 * 128 * 128 + 256 * 256 * 9) + 8 * 256


def test_bound_takes_the_slower_side():
    # operations bound: 989e12 ops take one second
    assert arith.bound_seconds(989e12, 1.0) == pytest.approx(1.0)
    # bytes bound: 3.35e12 bytes take one second
    assert arith.bound_seconds(1.0, 3.35e12) == pytest.approx(1.0)
    # the published K2 case: 0.0782 ms of bound (PERF.md's kernel table)
    ops, nbytes = arith.conv3x3_cost((4, 256, 128, 128), 256, 2)
    assert arith.bound_seconds(ops, nbytes) * 1e3 == pytest.approx(0.0782,
                                                                   abs=1e-4)


def test_roofline_and_mfu():
    calls = [(989e9, 0.0), (0.0, 3.35e9)]      # 1 ms each
    assert arith.roofline_pct(calls, 0.004) == pytest.approx(50.0)
    assert arith.roofline_pct([], 1.0) is None
    assert arith.roofline_pct(calls, 0.0) is None
    assert arith.mfu_pct(989e12 * 0.25, 1.0) == pytest.approx(25.0)
    assert arith.mfu_pct(0.0, 1.0) is None


def test_merge_is_a_union_not_a_sum():
    got = trace._merge([(0, 10), (5, 20), (30, 40), (40, 45)])
    assert got == [(0, 20), (30, 45)]
    assert sum(b - a for a, b in got) == 35


def test_launch_names():
    assert trace._is_launch("cudaLaunchKernel")
    assert trace._is_launch("cuLaunchKernelEx")
    assert not trace._is_launch("cudnn::conv")
    assert not trace._is_launch("aten::mm")
