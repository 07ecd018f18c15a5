"""The chained DiT's cell at a tiny size on the CPU (the card check
skipped, the program on its plain CPU path in float32): its check passes
with the program's chained DiT and fails when the program runs the
dead-block path against the chained reference; the float8 control fails
it.  And its readers on hand-made records: device time inside nested
spans, the padded K1 launches a batch."""

import copy

import pytest
import torch

from perfbench import harness, nested_spans
from perfbench.harness import reader
from perfbench.run import Context, run_cell
from perfbench.tests.test_perfbench_program_spans import (Ev, _launch,
                                                          _profile, _rec)

CELL = "ditxl2-chain-serve-b4"
TINY_MODEL = dict(dit_variant="DiT-mini", image_size=16, source_size=128,
                  perception_size=64, compute_dtype="float32")
SEED = 2 ** 31 + 777


def tiny():
    cell = copy.deepcopy(harness.load_cell(CELL))
    cell.config["model"].update(TINY_MODEL)
    cell.traffic.update(pool_batches=2, warm_batches=1,
                        check_pages=cell.traffic["batch"])
    return cell


def test_run_is_correct():
    res = run_cell(tiny(), SEED, 1.0, False, "cpu")
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {m["name"] for m in
                                   harness.load_cell(CELL).end_to_end}


def test_dead_block_program_is_not_correct():
    """The program on the dead-block path (only the last block runs)
    against the chained reference."""
    res = run_cell(tiny(), SEED, 0.5, False, "cpu",
                   over={"model": {"chain_blocks": False}})
    assert not res["correct"], res["checks"]


def test_fp8_control_is_not_correct():
    res = run_cell(tiny(), SEED, 0.5, False, "cpu", controls=True)
    assert res["correct"], res["checks"]
    assert res["control_correct"] is False, res["control_checks"]


def test_traced_run_records_padded_launches_and_flops():
    """A traced run at the tiny size: no launch is padded there (the CPU
    runs the plain twin), the stretch's batches and the operations counted
    over the chained reference."""
    from perfbench.traffic import serve_chain

    rec = serve_chain.run(Context(tiny(), SEED, 1.0, True,
                                  torch.device("cpu")))
    assert rec["profile"]["k1_padded"] == {} or \
        not any(rec["profile"]["k1_padded"].values())
    assert rec["batches_profiled"] == rec["pages_profiled"] / 4
    assert rec["flops_per_page"] > 0
    assert 0.0 <= rec["flow_clamp_pct"] <= 100.0
    assert reader("k1_padded_launches.device_paced")(rec) == 0.0


# window 0-100 ms; one batch: dvd.cond 0-20, dvd.sample 20-100 with two
# steps, each with its blocks and decoder spans
EVENTS = [Ev("perfbench.window", 0, 100),
          *_launch("cond", 1, 1, 2, 10),
          *_launch("pyramid", 21, 2, 22, 24),
          *_launch("block_k1", 31, 3, 32, 40),
          *_launch("block_gemm", 33, 4, 40, 48),
          *_launch("decoder", 51, 5, 52, 56),
          *_launch("rewarp", 59, 6, 60, 61),
          *_launch("block_k1", 62, 7, 62, 70),
          *_launch("decoder", 81, 8, 82, 84),
          *_launch("decoder_tail", 89, 9, 95, 105)]
RECORDS = [_rec("dvd.cond", 0, 20, pages=4),
           _rec("dvd.sample", 20, 100, pages=4),
           _rec("dvd.sample.step", 30, 58, parent=1, step=1),
           _rec("dvd.dit.blocks", 30, 50, parent=2, blocks=28, streams=4,
                tokens=1024),
           _rec("dvd.dit.decoder", 50, 58, parent=2, width=4608),
           _rec("dvd.sample.step", 58, 99, parent=1, step=0),
           _rec("dvd.dit.blocks", 61, 80, parent=5, blocks=28, streams=4,
                tokens=1024),
           _rec("dvd.dit.decoder", 80, 99, parent=5, width=4608)]


@pytest.fixture
def spans(monkeypatch):
    from dvd_tpu_torch.utils import trace

    monkeypatch.setattr(trace, "records", lambda: list(RECORDS))


def test_nested_spans_read_the_known_split(spans):
    rec = {"profile": _profile(EVENTS)}
    # blocks: 8 + 8 + 8 ms; decoder: 4 + 2 + the 5 ms of 95-105 inside
    assert reader("dit.blocks_device_ms.device_paced")(rec) == \
        pytest.approx(24.0)
    assert reader("dit.decoder_device_ms.device_paced")(rec) == \
        pytest.approx(11.0)
    # the outermost span still gets every launch made inside it
    assert reader("xl.sampling_device_ms.device_paced")(rec) == \
        pytest.approx(2 + 24 + 11 + 1)
    assert nested_spans.readings(rec) == {"dvd.dit.blocks": 24 * 10 ** 6,
                                          "dvd.dit.decoder": 11 * 10 ** 6}


def test_nested_spans_read_nothing_without_the_span(monkeypatch):
    """A program older than the spans: the readers return None."""
    from dvd_tpu_torch.utils import trace

    monkeypatch.setattr(trace, "records", lambda: [
        r for r in RECORDS if not r[0].startswith("dvd.dit.")])
    rec = {"profile": _profile(EVENTS)}
    assert reader("dit.blocks_device_ms.device_paced")(rec) is None
    assert reader("dit.decoder_device_ms.device_paced")(rec) is None
    assert reader("xl.sampling_device_ms.device_paced")(rec) == \
        pytest.approx(38.0)


def test_padded_launches_a_batch():
    read = reader("k1_padded_launches.device_paced")
    rec = {"profile": {"k1_padded": {72: 6720, 96: 0}},
           "batches_profiled": 10.0}
    assert read(rec) == 672.0
    assert read({"profile": {"k1_padded": {}}, "batches_profiled": 3}) == 0.0
    assert read({"profile": {}, "batches_profiled": 3}) is None
    assert read({"profile": {"k1_padded": {72: 1}}}) is None
