"""The port's spans (``dvd_tpu_torch/utils/trace.py``) on the CPU: off
unless a profiler records or tracing is enabled, the serving path's and the
dataset driver's spans nested and placed on their threads as documented,
their stamps on the clock of the profiler's host events,
``run_benchmark --profile``'s window and span export, and the bound on
the driver's writer backlog."""

import json
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import test_torch_common  # noqa: F401  (sets torch to 1 thread)
from dvd_tpu_torch.config import default_config
from dvd_tpu_torch.evaluation import driver
from dvd_tpu_torch.evaluation.pipeline import DewarpPipeline, unwarp_fixed
from dvd_tpu_torch.utils import trace
from test_torch_common import SRC, TINY_MODEL
from writer_pool import CountingPool

BATCH = 2
CANVAS = 160


@pytest.fixture(autouse=True)
def clean():
    trace.disable()
    trace.clear()
    yield
    trace.disable()
    trace.clear()


@pytest.fixture(scope="module")
def pipe():
    cfg = default_config().replace(
        model=dict(TINY_MODEL, dit_variant="DiT-mini"),
        diffusion={"n_batch": 2})
    return DewarpPipeline.create(cfg, "cpu",
                                 generator=torch.Generator().manual_seed(0))


def _sources(b, seed=0):
    return torch.rand((b, SRC, SRC, 3),
                      generator=torch.Generator().manual_seed(seed))


class Pages:
    """``run_benchmark``'s dataset contract over ``n`` random pages of
    mixed sizes in a ``CANVAS``^2 canvas."""

    def __init__(self, n):
        rng = np.random.RandomState(0)
        self.pages = [rng.randint(0, 256, (100 + 20 * (i % 3), 120, 3))
                      .astype(np.uint8) for i in range(n)]

    def __len__(self):
        return len(self.pages)

    def batches(self, batch_size):
        for k in range(0, len(self.pages), batch_size):
            idx = range(k, k + batch_size)
            padded = np.zeros((batch_size, CANVAS, CANVAS, 3), np.uint8)
            for j, i in enumerate(idx):
                h, w = self.pages[i].shape[:2]
                padded[j, :h, :w] = self.pages[i]
            yield {"source_image": np.random.RandomState(k).rand(
                       batch_size, SRC, SRC, 3).astype(np.float32),
                   "source_padded": padded,
                   "hw": np.array([p.shape[:2] for p in
                                   self.pages[k:k + batch_size]], np.int32),
                   "paths": [f"page_{i}.png" for i in idx],
                   "count": batch_size}


def _by_name(recs):
    out = {}
    for i, r in enumerate(recs):
        out.setdefault(r[0], []).append((i, r))
    return out


def test_inactive_span_is_the_shared_noop():
    a = trace.span("dvd.a")
    b = trace.span("dvd.b", batch=3)
    assert a is b
    with a:
        with trace.span("dvd.c", step=1):
            pass
    assert trace.records() == [] and trace.dropped() == 0


def test_enable_records_without_a_profiler():
    trace.enable()
    with trace.span("dvd.outer", batch=7):
        with trace.span("dvd.inner", step=2):
            time.sleep(0.001)
    trace.disable()
    with trace.span("dvd.after"):
        pass
    (n0, a0, b0, th0, p0, at0), (n1, a1, b1, th1, p1, at1) = trace.records()
    assert (n0, p0, at0) == ("dvd.outer", None, {"batch": 7})
    assert (n1, p1, at1) == ("dvd.inner", 0, {"step": 2})
    assert th0 == th1 == threading.get_ident()
    assert a0 <= a1 < b1 <= b0 and b1 - a1 >= 1_000_000


def test_full_buffer_counts_dropped_spans():
    tr = trace.Tracer(capacity=2)
    tr.on = True
    for _ in range(5):
        with tr.span("dvd.x"):
            with tr.span("dvd.y"):
                pass
    assert [r[0] for r in tr.records()] == ["dvd.x", "dvd.y"]
    assert tr.dropped == 8


def test_clear_during_an_open_span():
    trace.enable()
    with trace.span("dvd.open"):
        trace.clear()
        with trace.span("dvd.child"):
            pass
    (name, _, t1, _, parent, _), = trace.records()
    assert (name, parent) == ("dvd.child", None) and t1 is not None


def test_threads_keep_their_own_parents():
    trace.enable()

    def worker(k):
        with trace.span("dvd.w", k=k):
            time.sleep(0.002)
            with trace.span("dvd.w.inner", k=k):
                time.sleep(0.002)

    ts = [threading.Thread(target=worker, args=(k,)) for k in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in ts)
    recs = trace.records()
    assert len(recs) == 8
    for r in recs:
        if r[0] == "dvd.w.inner":
            parent = recs[r[4]]
            assert parent[0] == "dvd.w" and parent[3] == r[3]
            assert parent[5] == r[5]


def test_span_stamps_bracket_the_profilers_event():
    """The clock check: a span's ``time.time_ns()`` stamps contain, within
    2 ms, the profiler's own host event for an aten op run inside it."""
    x = torch.randn(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("dvd.clock"):
            torch.mm(x, x)
    (_, t0, t1, _, _, _), = trace.records()
    ev, = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "aten::mm"]
    a, b = ev.start_ns(), ev.start_ns() + ev.duration_ns()
    assert t0 <= a + 2_000_000 and b <= t1 + 2_000_000
    assert abs(a - t0) < 2_000_000 and abs(t1 - b) < 2_000_000


def test_serving_spans_nest_under_the_profiler(pipe):
    src = _sources(BATCH)
    with profile(activities=[ProfilerActivity.CPU]):
        flow = pipe.dewarp_flow(src, generator=torch.Generator()
                                .manual_seed(1))
        unwarp_fixed(src, flow)
    with trace.span("dvd.outside"):
        pass
    recs = trace.records()
    names = _by_name(recs)
    (ci, cond), = names["dvd.cond"]
    (si, sample), = names["dvd.sample"]
    (ui, unw), = names["dvd.unwarp"]
    assert cond[4] is None and sample[4] is None and unw[4] is None
    assert cond[5] == {"pages": BATCH} and unw[5] == {"pages": BATCH}
    kids = {r[0] for r in recs if r[4] == ci}
    assert kids == {"dvd.cond.geotr", "dvd.cond.seg", "dvd.cond.line"}
    steps = names["dvd.sample.step"]
    assert len(steps) == pipe.sched.num_timesteps
    assert [r[5]["step"] for _, r in steps] == \
        list(range(pipe.sched.num_timesteps - 1, -1, -1))
    assert all(r[4] == si for _, r in steps)
    assert cond[2] <= sample[1] and sample[2] <= unw[1]
    for _, r in steps:
        assert sample[1] <= r[1] <= r[2] <= sample[2]
    assert "dvd.outside" not in names


def test_run_benchmark_spans_on_their_threads(pipe, tmp_path):
    """Two batches under ``enable()``: the driver's spans on the calling
    thread, covering the loop's body, the loader's and the writers' on
    threads of their own.  On the CPU the drain copies the results itself
    (no pinned pull runs ahead of it), so its span has no ``ready``
    attribute: only a card's drain says whether its pull was done."""
    trace.enable()
    stats = driver.run_benchmark(pipe, Pages(2 * BATCH), str(tmp_path),
                                 batch_size=BATCH, mesh=None)
    trace.disable()
    assert stats["images"] == 2 * BATCH
    main = threading.get_ident()
    recs = trace.records()
    names = _by_name(recs)
    threads = {n: {r[3] for _, r in v} for n, v in names.items()}
    for n in ("dvd.driver.wait", "dvd.driver.h2d", "dvd.driver.drain",
              "dvd.cond", "dvd.sample", "dvd.unwarp"):
        assert threads[n] == {main}, n
    assert [r[5]["batch"] for _, r in names["dvd.driver.h2d"]] == [0, 1]
    assert [r[5] for _, r in names["dvd.driver.drain"]] == \
        [{"batch": 0}, {"batch": 1}]
    assert names["dvd.driver.h2d"][0][1][5]["bytes"] == \
        BATCH * (SRC * SRC + CANVAS * CANVAS) * 3
    # the loader made two batches and found the end in a third span
    assert [r[5]["batch"] for _, r in names["dvd.loader.batch"]] == [0, 1, 2]
    loader, = threads["dvd.loader.batch"]
    assert loader != main
    assert len(names["dvd.driver.write"]) == 2 * BATCH
    # (an ended thread's ident may be reused: the loader's by a writer)
    assert main not in threads["dvd.driver.write"]
    # the loop's body: batch 1's wait, inputs, stages, unwarp and batch
    # 0's drain follow each other on the calling thread
    loop = sorted((r[1], r[2], r[0]) for r in recs
                  if r[3] == main and r[4] is None)
    h2d_1 = [s for s in loop if s[2] == "dvd.driver.h2d"][1]
    after = [s[2] for s in loop if s[0] >= h2d_1[0]][:5]
    assert after == ["dvd.driver.h2d", "dvd.cond", "dvd.sample",
                     "dvd.unwarp", "dvd.driver.drain"]


def test_run_benchmark_bounds_the_writers_backlog(pipe, tmp_path,
                                                   monkeypatch):
    """Writers far slower than the loop (1 s a page): a drain waits for
    the writes of all but the newest ``WRITE_BACKLOG - 1`` drained
    batches before it queues its own, so at most ``WRITE_BACKLOG``
    batches' results (on a card, their pinned blocks) are held by
    writes: fewer than ``WRITE_BACKLOG * BATCH`` writes are pending when
    one is queued; every page is still written."""
    written = []

    def slow(path, arr):
        time.sleep(1.0)
        written.append(path)

    monkeypatch.setattr(CountingPool, "most", 0)
    monkeypatch.setattr(driver, "ThreadPoolExecutor", CountingPool)
    monkeypatch.setattr(driver, "save_png", slow)
    stats = driver.run_benchmark(pipe, Pages(6 * BATCH), str(tmp_path),
                                 batch_size=BATCH, mesh=None)
    assert stats["images"] == len(written) == 6 * BATCH
    assert 0 < CountingPool.most < driver.WRITE_BACKLOG * BATCH


class SlowStart(profile):
    """A profiler whose start takes ``DELAY`` seconds, with the moments its
    start and its stop returned."""

    DELAY = 0.5
    started = stopped = None

    def __enter__(self):
        time.sleep(self.DELAY)
        out = super().__enter__()
        SlowStart.started = time.perf_counter()
        return out

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        SlowStart.stopped = time.perf_counter()
        return out


def test_run_benchmark_profile_window_and_span_export(pipe, tmp_path,
                                                     monkeypatch):
    """``profile_dir``: the profiler's start lies before the throughput
    clock, and the spans it recorded are exported beside its trace."""
    monkeypatch.setattr(torch.profiler, "profile", SlowStart)
    with trace.span("dvd.before"):
        pass
    stats = driver.run_benchmark(pipe, Pages(4 * BATCH), str(tmp_path / "o"),
                                 batch_size=BATCH, mesh=None,
                                 profile_dir=str(tmp_path / "p"))
    # the clock stops just after the profiler: it started after its start
    assert stats["seconds_total"] <= \
        SlowStart.stopped - SlowStart.started + 0.1
    assert (tmp_path / "p" / "trace.json").exists()
    lines = [json.loads(ln) for ln in
             (tmp_path / "p" / "spans.jsonl").read_text().splitlines()]
    assert lines and all(set(ln) == set(driver.SPAN_KEYS) for ln in lines)
    names = [ln["name"] for ln in lines]
    # batches 1-3 ran under the profiler, batch 0 before it; the loader,
    # two batches ahead, found the end (its fifth span) only after the
    # second batch was taken
    assert [ln["attrs"]["batch"] for ln in lines
            if ln["name"] == "dvd.driver.h2d"] == [1, 2, 3]
    assert names.count("dvd.cond") == 3 and "dvd.before" not in names
    assert {"batch": 4} in [ln["attrs"] for ln in lines
                            if ln["name"] == "dvd.loader.batch"]
    assert names.count("dvd.driver.write") == 4 * BATCH
    by_i = {ln["i"]: ln for ln in lines}
    for ln in lines:
        assert ln["t0_ns"] <= ln["t1_ns"]
        if ln["name"] == "dvd.sample.step":
            assert by_i[ln["parent"]]["name"] == "dvd.sample"
