"""The reader of the conditioning networks' graph replays
(``perfbench/metrics/serve.cond_graph_replay_pct.py`` and its
``.device_paced`` twin) on hand-made spans and a hand-made profile window:
the share of ``dvd.cond.graph`` calls inside the window that replayed,
spans cut by the window's edge counted in part; nothing read without a
profile, without the window, or from a program that records no such
span."""

import types

import pytest

from perfbench.harness import reader

MS = 1_000_000
NAMES = ("serve.cond_graph_replay_pct",
         "serve.cond_graph_replay_pct.device_paced")


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


def _span(t0, t1, mode, net="seg"):
    return ("dvd.cond.graph", int(t0 * MS), int(t1 * MS), 11, 0,
            {"net": net, "mode": mode})


# window 10-100 ms: the capture before it is out, the eager call half in
SPANS = [("dvd.cond", 0, 120 * MS, 11, None, {"pages": 4}),
         _span(0, 5, "capture"),
         _span(5, 15, "eager", "line"),
         _span(20, 30, "replay"),
         _span(40, 50, "replay", "geotr"),
         _span(60, 70, "replay", "line"),
         _span(95, 105, "replay"),
         ("dvd.cond.graph", 110 * MS, None, 11, 0, {"mode": "replay"})]
EVENTS = [Ev("perfbench.window", 10, 100),
          Ev("perfbench.window", 0, 200, device=True)]


@pytest.fixture
def spans(monkeypatch):
    from dvd_tpu_torch.utils import trace

    def use(records):
        monkeypatch.setattr(trace, "records", lambda: list(records))

    use(SPANS)
    return use


@pytest.mark.parametrize("name", NAMES)
def test_share_of_replays_in_the_window(spans, name):
    got = reader(name)(_rec(EVENTS))
    assert got == pytest.approx(100.0 * 3.5 / 4.0)


@pytest.mark.parametrize("name", NAMES)
def test_all_replays_read_100(spans, name):
    spans([_span(20, 30, "replay"), _span(30, 40, "replay", "line")])
    assert reader(name)(_rec(EVENTS)) == pytest.approx(100.0)


@pytest.mark.parametrize("name", NAMES)
def test_nothing_without_a_profile_or_a_window(spans, name):
    read = reader(name)
    assert read({}) is None and read({"profile": None}) is None
    assert read(_rec([Ev("perfbench.window", 0, 200, device=True)])) is None


@pytest.mark.parametrize("name", NAMES)
def test_nothing_from_a_program_without_graph_spans(spans, name):
    spans([r for r in SPANS if r[0] != "dvd.cond.graph"])
    assert reader(name)(_rec(EVENTS)) is None
    spans([_span(150, 160, "replay")])      # outside the window only
    assert reader(name)(_rec(EVENTS)) is None
