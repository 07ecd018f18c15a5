"""The reader of every K2 launch's roofline share
(``perfbench/metrics/k2_all_roofline.serve.py`` and its ``.device_paced``
twin) on hand-made calls, spans and profile events: the bounds of the
calls recorded from Python and of the launches that each replay span in
the window lists, over the device time of K2's kernels that start in the
window; on a program without graph spans, the same reading as
``k2_roofline.serve`` where K2's kernels are all that its calls launched;
nothing read without a profile, the window, a call or K2's device
time."""

import types

import pytest

from perfbench.arith import conv3x3_cost, roofline_pct
from perfbench.harness import reader

MS = 1_000_000
NAMES = ("k2_all_roofline.serve", "k2_all_roofline.device_paced")
WGMMA = ("void (anonymous namespace)::conv3x3_wgmma_kernel<64, 32, 1>"
         "(dvd::conv::Args<__nv_bfloat16>)")
F32 = ("void (anonymous namespace)::conv3x3_f32x6_kernel<64>"
       "(dvd::conv::Args<float>)")


class Ev:
    def __init__(self, name, t0, t1, device=False):
        self._n, self._d = name, device
        self._a, self._b = int(t0 * MS), int(t1 * MS)

    def name(self):
        return self._n

    def start_ns(self):
        return self._a

    def duration_ns(self):
        return self._b - self._a

    def device_type(self):
        return "DeviceType.CUDA" if self._d else "DeviceType.CPU"


def _rec(events, calls=None, range_s=None):
    kineto = types.SimpleNamespace(events=lambda: list(events))
    rec = {"profile": {"prof": types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=kineto))}}
    if calls is not None:
        rec["calls"] = {"k2": list(calls)}
    if range_s is not None:
        rec["trace"] = {"range_s": {"perfbench.k2": range_s}}
    return rec


def _replay(t0, launches, mode="replay"):
    return ("dvd.cond.graph", int(t0 * MS), int((t0 + 1) * MS), 11, 0,
            {"net": "seg", "mode": mode, "launches": launches})


A = ("conv3x3", 4, 16, 16, 144, 144, 2)
B = ("conv3x3", 4, 64, 64, 36, 36, 2)
EAGER = [conv3x3_cost((4, 32, 64, 64), 32, 2)]
# window 10-100 ms; K2 runs 4 ms inside it (one f32), the 0.5 ms at 5 and
# at 120 are outside, the elementwise kernel is no K2
EVENTS = [Ev("perfbench.window", 10, 100),
          Ev("perfbench.window", 0, 200, device=True),
          Ev(WGMMA, 5, 5.5, device=True),
          Ev(WGMMA, 20, 21.5, device=True),
          Ev(F32, 40, 41, device=True),
          Ev(WGMMA, 60, 61.5, device=True),
          Ev("void at::native::elementwise_kernel<128, 4>", 70, 90,
             device=True),
          Ev(WGMMA, 120, 120.5, device=True)]


@pytest.fixture
def spans(monkeypatch):
    from dvd_tpu_torch.utils import trace

    def use(records):
        monkeypatch.setattr(trace, "records", lambda: list(records))

    use([])
    return use


def _cost(launch):
    _, b, cin, cout, h, w, itemsize = launch
    return conv3x3_cost((b, cin, h, w), cout, itemsize)


@pytest.mark.parametrize("name", NAMES)
def test_eager_calls_and_each_replays_launches_over_k2s_time(spans, name):
    spans([("dvd.cond", 0, 120 * MS, 11, None, {"pages": 4}),
           _replay(2, (A,)),                    # before the window
           _replay(20, (A, B)),
           _replay(40, (A,), mode="capture"),   # its calls are recorded
           ("dvd.cond.graph", 45 * MS, 46 * MS, 11, 0,
            {"net": "line", "mode": "eager"}),
           _replay(60, (B, ("unwarp", 1, 2))),  # no K2: left out
           _replay(150, (A,))])                 # after it
    got = reader(name)(_rec(EVENTS, EAGER))
    want = roofline_pct(EAGER + [_cost(A), _cost(B), _cost(B)], 4e-3)
    assert got == pytest.approx(want)


@pytest.mark.parametrize("name", NAMES)
def test_without_graph_spans_it_reads_as_k2_roofline(spans, name):
    calls = EAGER * 3
    got = reader(name)(_rec(EVENTS, calls, range_s=4e-3))
    assert got == pytest.approx(roofline_pct(calls, 4e-3))
    assert got == pytest.approx(
        reader("k2_roofline.serve")(_rec(EVENTS, calls, range_s=4e-3)))


@pytest.mark.parametrize("name", NAMES)
def test_replays_alone_are_read(spans, name):
    spans([_replay(20, (A, A))])
    got = reader(name)(_rec(EVENTS, []))
    assert got == pytest.approx(roofline_pct([_cost(A)] * 2, 4e-3))


@pytest.mark.parametrize("name", NAMES)
def test_nothing_without_a_profile_window_call_or_k2_time(spans, name):
    read = reader(name)
    assert read({}) is None and read({"profile": None}) is None
    assert read(_rec(EVENTS[1:], EAGER)) is None        # no window
    assert read(_rec(EVENTS)) is None                    # no call
    assert read(_rec(EVENTS[:2] + EVENTS[-2:], EAGER)) is None   # no K2 time
