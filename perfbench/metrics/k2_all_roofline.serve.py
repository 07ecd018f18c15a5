"""k2_all_roofline.serve: the sum of the bounds of every K2 launch
(operations and bytes from their shapes, ``perfbench/arith.py``) over the
device time of K2's kernels, in the traced run's profiled stretch, those
that CUDA graphs replay included.

The launches are the K2 calls the harness records from Python
(``k2_roofline.serve``'s) and those that each ``dvd.cond.graph`` replay
span of the program opened in the ``perfbench.window`` range lists
(attribute ``launches``, entries ``("conv3x3", B, Cin, Cout, H, W,
itemsize)``, ``dvd_tpu_torch/utils/graphs.py``); the device time is that
of the device activities, found by K2's kernel names, that start in the
window.  The window opens and closes on a synchronised card, so its
kernels are those its calls launched.  A program that replays no graph
is read over the calls ``k2_roofline.serve`` reads.  None without a
profile, the window, a K2 call or K2's device time."""

from perfbench.arith import conv3x3_cost, roofline_pct
from perfbench.trace import WINDOW, _is_device

SPAN = "dvd.cond.graph"
KERNELS = ("conv3x3_wgmma_kernel", "conv3x3_f32x6_kernel")


def _replayed(w0, w1):
    try:
        from dvd_tpu_torch.utils import trace
    except ImportError:
        return []
    out = []
    for name, t0, _, _, _, attrs in trace.records():
        if name != SPAN or not w0 <= t0 < w1 or attrs.get("mode") != "replay":
            continue
        for launch in attrs.get("launches", ()):
            if launch[0] == "conv3x3":
                _, b, cin, cout, h, w, itemsize = launch
                out.append(conv3x3_cost((b, cin, h, w), cout, itemsize))
    return out


def read(rec):
    prof = (rec.get("profile") or {}).get("prof")
    if prof is None:
        return None
    events = prof.profiler.kineto_results.events()
    window = next(((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in events
                   if e.name() == WINDOW and not _is_device(e)), None)
    if window is None:
        return None
    w0, w1 = window
    device_ns = sum(e.duration_ns() for e in events
                    if _is_device(e) and w0 <= e.start_ns() < w1
                    and any(k in e.name() for k in KERNELS))
    calls = list((rec.get("calls") or {}).get("k2") or ()) + _replayed(w0, w1)
    return roofline_pct(calls, device_ns / 1e9)
