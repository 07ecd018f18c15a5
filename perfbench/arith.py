"""The yardstick's arithmetic: one H100's published peaks (NVIDIA's data
sheet, SXM part, dense, at the 700 W limit), the operations and bytes a
kernel call needs from its shapes, and the least time the card could take
for them.

Every input byte is counted read once and every output byte written once;
operations are multiply-adds counted as two.  The bound of a call is
max(bytes / HBM rate, operations / tensor-core bf16 rate).  An f32 call
is bounded at the bf16 rate too: the served kernels compute f32 on the
tensor cores, and a lower rate could set a bound above what they reach.
"""

from __future__ import annotations

from typing import Iterable, Sequence, Tuple

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS_PER_S = 989e12        # bf16 / fp16 tensor cores, dense


def attention_cost(q: Sequence[int], k: Sequence[int],
                   itemsize: int) -> Tuple[float, float]:
    """(operations, bytes) of softmax(q k^T) v with q (B, H, Tq, Dh) and
    k, v (B, H, Tk, Dh): two products of 2 B H Tq Tk Dh each; q, k, v read
    and the output (q's shape) written once."""
    b, h, tq, dh = q
    tk = k[2]
    ops = 4.0 * b * h * tq * tk * dh
    nbytes = itemsize * (2 * b * h * tq * dh + 2 * b * h * tk * dh)
    return ops, float(nbytes)


def conv3x3_cost(x: Sequence[int], cout: int,
                 itemsize: int) -> Tuple[float, float]:
    """(operations, bytes) of a stride-1 'same' 3x3 conv of x (B, Cin, H,
    W) to Cout channels: 2 B Cout H W Cin 9 operations; x, the weights and
    the output read or written once (the per-channel scale and bias
    in f32)."""
    b, cin, h, w = x
    ops = 18.0 * b * cout * h * w * cin
    nbytes = itemsize * (b * cin * h * w + cout * cin * 9 + b * cout * h * w) \
        + 8 * cout
    return ops, float(nbytes)


def bound_seconds(ops: float, nbytes: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS_PER_S)


def roofline_pct(calls: Iterable[Tuple[float, float]],
                 device_seconds: float):
    """100 * sum of the calls' bounds / the device time they took; None
    when no call or no device time was seen."""
    total = sum(bound_seconds(o, b) for o, b in calls)
    if total <= 0 or device_seconds <= 0:
        return None
    return 100.0 * total / device_seconds


def mfu_pct(flops: float, seconds: float):
    """100 * flops / seconds / the bf16 peak; None without both."""
    if flops <= 0 or seconds <= 0:
        return None
    return 100.0 * flops / seconds / PEAK_FLOPS_PER_S
