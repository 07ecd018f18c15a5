"""The readers of the program's spans (``perfbench/program_spans.py``) on a
hand-made profile whose device work, launches and spans have known splits;
nothing read without a profile or without the program's tracer; and on the
card, a span's stamps around a synchronised K2 launch contain the kernel's
device interval in the profile (the shared clock)."""

import sys
import types

import pytest
import torch

from perfbench.harness import reader

MS = 1_000_000
MAIN, LOADER, WRITER = 11, 12, 13


class Ev:
    """A profiler event: ``device`` activities on the card, else host."""

    def __init__(self, name, t0, t1, corr=0, device=False):
        self._n, self._a, self._b = name, int(t0 * MS), int(t1 * MS)
        self._c, self._d = corr, device

    def name(self):
        return self._n

    def start_ns(self):
        return self._a

    def duration_ns(self):
        return self._b - self._a

    def correlation_id(self):
        return self._c

    def device_type(self):
        return "DeviceType.CUDA" if self._d else "DeviceType.CPU"


def _launch(name, t, corr, a, b):
    return [Ev("cudaLaunchKernel", t, t + 0.01, corr),
            Ev(name, a, b, corr, device=True)]


# window 0-100 ms.  Busy: 0-5, 18-28, 30-35, 45-75, 81-83, 84-90, 99-100
# (59 ms); idle 41 ms, all inside the main thread's outermost spans.
EVENTS = [Ev("perfbench.window", 0, 100),
          Ev("perfbench.stage.conditioning", 15, 40, 90, device=True),
          *_launch("before_window", -5, 1, -3, 5),
          *_launch("cond_k2", 16, 2, 18, 28),
          *_launch("seg_k2", 20, 3, 30, 35),
          *_launch("dit_k1", 41, 4, 45, 75),
          *_launch("unwarp", 81, 5, 81, 83),
          *_launch("Memcpy DtoH", 83, 6, 84, 90),
          *_launch("Memcpy HtoD", 97, 7, 99, 103)]


def _rec(name, t0, t1, thread=MAIN, parent=None, **attrs):
    return (name, int(t0 * MS), int(t1 * MS), thread, parent, attrs)


RECORDS = [_rec("dvd.loader.batch", 0, 30, LOADER, batch=1),
           _rec("dvd.driver.wait", 0, 10),
           _rec("dvd.driver.h2d", 10, 15, batch=0),
           _rec("dvd.cond", 15, 40, pages=4),
           _rec("dvd.cond.seg", 20, 30, parent=3),
           _rec("dvd.sample", 40, 80, pages=4),
           _rec("dvd.sample.step", 41, 60, parent=5, step=1),
           _rec("dvd.sample.step", 60, 79, parent=5, step=0),
           _rec("dvd.unwarp", 80, 82, pages=4),
           _rec("dvd.driver.drain", 82, 96, batch=0),
           _rec("dvd.driver.write", 85, 95, WRITER),
           # the next batch's uploads, half inside the window
           _rec("dvd.driver.h2d", 96, 104, batch=1),
           # open when the records were read
           ("dvd.driver.wait", 104 * MS, None, MAIN, None, {})]

# per dvd.cond / dvd.sample (one each); per batch (1.5: one h2d and half)
WANT = {"serve.conditioning_device_ms": 15.0,
        "serve.conditioning_idle_ms": 10.0,
        "serve.sampling_device_ms": 30.0,
        "serve.sampling_idle_ms": 10.0,
        "dataset.h2d_ms": 9.0 / 1.5,
        "dataset.drain_ms": 14.0 / 1.5,
        "dataset.driver_idle_ms": (5.0 + 5.0 + 7.0 + 3.0) / 1.5,
        "dataset.loader_ms": 30.0 / 1.5}


def _profile(events):
    kineto = types.SimpleNamespace(events=lambda: list(events))
    return {"prof": types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=kineto))}


@pytest.fixture
def spans(monkeypatch):
    from dvd_tpu_torch.utils import trace

    def use(records):
        monkeypatch.setattr(trace, "records", lambda: list(records))

    use(RECORDS)
    return use


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_reads_the_known_split(spans, name):
    rec = {"profile": _profile(EVENTS)}
    assert reader(name)(rec) == pytest.approx(WANT[name], abs=1e-6)
    if name.startswith("serve."):
        twin = reader(name + ".device_paced")(rec)
        assert twin == pytest.approx(WANT[name], abs=1e-6)


def test_idle_is_split_without_remainder(spans):
    from perfbench.program_spans import readings

    r = readings({"profile": _profile(EVENTS)})
    assert r["window_ns"] == 100 * MS and r["idle_ns"] == 41 * MS
    names = r["names"]
    assert sum(n["idle_ns"] for n in names.values()) == r["idle_ns"]
    assert names["dvd.unwarp"]["device_ns"] == 2 * MS
    assert names["dvd.driver.drain"]["device_ns"] == 6 * MS
    # inner spans and other threads get no device or idle time
    for k in ("dvd.cond.seg", "dvd.sample.step", "dvd.driver.write",
              "dvd.loader.batch"):
        assert names[k]["device_ns"] == names[k]["idle_ns"] == 0
    assert names["dvd.sample.step"]["count"] == 2


def test_readings_are_computed_once(spans):
    from perfbench.program_spans import readings

    rec = {"profile": _profile(EVENTS)}
    first = readings(rec)
    spans([])
    assert readings(rec) is first


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_reads_nothing_without_a_profile(spans, name):
    assert reader(name)({}) is None
    assert reader(name)({"profile": {}}) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_reads_nothing_without_the_programs_spans(spans, monkeypatch,
                                                         name):
    # a program without the tracer (the module cannot be imported)
    import dvd_tpu_torch.utils

    monkeypatch.delattr(dvd_tpu_torch.utils, "trace")
    monkeypatch.setitem(sys.modules, "dvd_tpu_torch.utils.trace", None)
    assert reader(name)({"profile": _profile(EVENTS)}) is None


def test_reader_reads_nothing_without_conditioning_spans(spans):
    spans([r for r in RECORDS if r[0] != "dvd.cond"])
    assert reader("serve.sampling_idle_ms")(
        {"profile": _profile(EVENTS)}) is None


def test_dataset_readers_need_the_drivers_batches(spans):
    spans([r for r in RECORDS if r[0] != "dvd.driver.h2d"])
    rec = {"profile": _profile(EVENTS)}
    assert reader("dataset.drain_ms")(rec) is None
    assert reader("serve.conditioning_idle_ms")(rec) == \
        pytest.approx(10.0, abs=1e-6)


# --------------------------------------------------------- on the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K2 is a CUDA kernel")
    return "cuda:0"


@pytest.mark.cuda
def test_span_contains_its_kernel_on_the_card(card):
    """The shared clock: a span's ``time.time_ns()`` stamps around one K2
    launch, synchronised inside the span, contain that kernel's device
    interval in the profile."""
    from torch.profiler import ProfilerActivity, profile

    from dvd_tpu_torch.models import layers
    from dvd_tpu_torch.utils import trace

    conv = torch.nn.Conv2d(256, 256, 3, padding=1).to(card, torch.bfloat16)
    x = torch.randn((4, 256, 128, 128), device=card, dtype=torch.bfloat16)
    with torch.inference_mode():
        layers.conv3x3_same(conv, x)        # builds and warms K2
        torch.cuda.synchronize()
        n0 = layers.conv3x3.launches
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            with trace.span("dvd.card_clock"):
                layers.conv3x3_same(conv, x)
                torch.cuda.synchronize()
    assert layers.conv3x3.launches == n0 + 1
    _, t0, t1, _, _, _ = [r for r in trace.records()
                          if r[0] == "dvd.card_clock"][-1]
    events = prof.profiler.kineto_results.events()
    launched = {e.correlation_id() for e in events
                if not str(e.device_type()).endswith("CUDA")
                and e.name().startswith("cu")}
    kernels = [e for e in events if str(e.device_type()).endswith("CUDA")
               and e.correlation_id() in launched]
    assert kernels
    for e in kernels:
        a, b = e.start_ns(), e.start_ns() + e.duration_ns()
        assert t0 <= a < b <= t1, (e.name(), a - t0, t1 - b)
