"""The reader of the dataset driver's pinned pulls
(``perfbench/metrics/dataset.pull_ready_pct.py``) on hand-made drain spans
and a hand-made profile window: the share of ``dvd.driver.drain`` spans
inside the window whose ``ready`` attribute is true, spans cut by the
window's edge counted in part; nothing read without a profile, without
the window, or from a program whose drains carry no ``ready`` (a CPU run,
or a driver older than its pinned pulls)."""

import types

import pytest

from perfbench.harness import reader

MS = 1_000_000
NAME = "dataset.pull_ready_pct"


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


def _rec(events):
    kineto = types.SimpleNamespace(events=lambda: list(events))
    return {"profile": {"prof": types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=kineto))}}


def _drain(t0, t1, bi, ready=None):
    attrs = {"batch": bi} if ready is None else {"batch": bi, "ready": ready}
    return ("dvd.driver.drain", int(t0 * MS), int(t1 * MS), 11, None, attrs)


# window 10-100 ms: the drain before it is out, the first one half in, the
# last one a fifth in, the open one not counted
SPANS = [("dvd.driver.h2d", 0, 120 * MS, 11, None, {"batch": 0}),
         _drain(0, 5, 0, False),
         _drain(5, 15, 1, False),
         _drain(20, 30, 2, True),
         _drain(40, 50, 3, True),
         _drain(60, 70, 4, False),
         _drain(98, 108, 5, True),
         ("dvd.driver.drain", 110 * MS, None, 11, None, {"ready": True})]
EVENTS = [Ev("perfbench.window", 10, 100),
          Ev("perfbench.window", 0, 200, device=True)]


@pytest.fixture
def spans(monkeypatch):
    from dvd_tpu_torch.utils import trace

    def use(records):
        monkeypatch.setattr(trace, "records", lambda: list(records))

    use(SPANS)
    return use


def test_weighted_share_of_ready_drains(spans):
    # drains in the window: 0.5 (not ready) + 1 + 1 + 1 (not ready) + 0.2
    assert reader(NAME)(_rec(EVENTS)) == pytest.approx(
        100.0 * 2.2 / 3.7)


@pytest.mark.parametrize("ready, want", [(True, 100.0), (False, 0.0)])
def test_all_or_none_ready(spans, ready, want):
    spans([_drain(20, 30, 0, ready), _drain(40, 45, 1, ready)])
    assert reader(NAME)(_rec(EVENTS)) == pytest.approx(want)


def test_nothing_without_a_profile_or_a_window(spans):
    read = reader(NAME)
    assert read({}) is None and read({"profile": None}) is None
    assert read(_rec([Ev("perfbench.window", 0, 200, device=True)])) is None


def test_nothing_without_drain_spans_that_say_ready(spans):
    read = reader(NAME)
    spans([r for r in SPANS if r[0] != "dvd.driver.drain"])
    assert read(_rec(EVENTS)) is None
    spans([_drain(20, 30, 0), _drain(40, 50, 1)])       # the CPU's drains
    assert read(_rec(EVENTS)) is None
    spans([_drain(150, 160, 0, True)])                   # outside the window
    assert read(_rec(EVENTS)) is None
