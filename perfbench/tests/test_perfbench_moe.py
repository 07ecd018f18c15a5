"""The DiT-MoE cell at a tiny size on the CPU (the program on its plain CPU
path in float32): its check passes with the reference following the
served routes, and the float8 control fails it; the route capture hands
the check one tensor of experts per expert-layer call; a traced run
records the per-expert counter and counts the routed work.  And the
readers on hand-made records: device time inside the expert layer's
spans, the grouped GEMMs' roofline from the spans' attributes, the load
on the busiest expert, and nothing where the program has no such span or
counter."""

import copy

import pytest
import torch

from perfbench import harness, moe_spans
from perfbench.harness import reader
from perfbench.run import Context, run_cell
from perfbench.tests.test_perfbench_program_spans import (MS, Ev, _launch,
                                                          _profile, _rec)

CELL = "ditmoe-xl2-chain-serve-b4"
TINY_MODEL = dict(dit_variant="DiT-MoE-mini", image_size=16, source_size=128,
                  perception_size=64, compute_dtype="float32")
SEED = 2 ** 31 + 991


def tiny():
    cell = copy.deepcopy(harness.load_cell(CELL))
    cell.config["model"].update(TINY_MODEL)
    cell.traffic.update(pool_batches=2, warm_batches=1,
                        check_pages=cell.traffic["batch"])
    return cell


def test_run_and_fp8_control():
    res = run_cell(tiny(), SEED, 0.5, False, "cpu", controls=True)
    assert res["correct"], res["checks"]
    assert res["raw_checks"]["route_flip_pct"] == 0.0
    assert res["control_correct"] is False, res["control_checks"]
    assert set(res["metrics"]) == {m["name"] for m in
                                   harness.load_cell(CELL).end_to_end}


def test_capture_hands_the_routes_to_the_check(monkeypatch):
    """Each checked batch arrives with one (tokens, top_k) route a block
    and step; the reference follows them."""
    from perfbench.traffic import serve_moe

    seen = []
    batch = serve_moe._Check.batch

    def spy(self, src, x_t, flow, cond):
        seen.append([tuple(r.shape) for r in cond["routes"]])
        batch(self, src, x_t, flow, cond)
        assert self.ref.served is None
        assert self.flips["program"] == [0, 6 * 2048]

    monkeypatch.setattr(serve_moe._Check, "batch", spy)
    run_cell(tiny(), SEED, 0.3, False, "cpu")
    # 3 steps x 2 blocks; 4 streams x (4 pages x 2 hypotheses) x 64 tokens
    assert seen == [[(2048, 2)] * 6]


def test_traced_run_records_counts_and_flops():
    from perfbench.traffic import serve_moe

    rec = serve_moe.run(Context(tiny(), SEED, 1.0, True,
                                torch.device("cpu")))
    counts = rec["profile"]["moe_expert_tokens"]
    assert len(counts) == 8
    assert sum(counts) == rec["batches_profiled"] * 6 * 2048 * 2
    assert reader("moe.load_max_over_mean.device_paced")(rec) >= 1.0
    assert rec["flops_per_page"] > 0


# window 0-100 ms; one batch (dvd.cond 0-10, dvd.sample 10-90) of one
# step with two
# blocks' expert layers, each with its four parts
EVENTS = [Ev("perfbench.window", 0, 100),
          *_launch("attn", 11, 1, 12, 20),
          *_launch("router", 21, 2, 21, 22),
          *_launch("sort", 22, 3, 22, 23),
          *_launch("gemm1", 24, 4, 24, 30),
          *_launch("gemm2", 30, 5, 30, 33),
          *_launch("shared", 34, 6, 34, 36),
          *_launch("combine", 37, 7, 37, 38),
          *_launch("router", 51, 8, 51, 52),
          *_launch("gemm1", 54, 9, 54, 60),
          *_launch("combine", 67, 10, 67, 69),
          *_launch("decoder", 80, 11, 80, 85)]
ATTRS = dict(tokens=32768, experts=8, top_k=2, inner=4608, dim=1152,
             shared_inner=2304, itemsize=2)
RECORDS = [_rec("dvd.cond", 0, 10, pages=4),
           _rec("dvd.sample", 10, 90, pages=4),
           _rec("dvd.dit.blocks", 10, 79, parent=1, blocks=2, streams=4,
                tokens=1024),
           _rec("dvd.dit.moe", 20, 40, parent=2, **ATTRS),
           _rec("dvd.dit.moe.route", 20, 23.5, parent=3),
           _rec("dvd.dit.moe.experts", 23.5, 33.5, parent=3),
           _rec("dvd.dit.moe.shared", 33.5, 36.5, parent=3),
           _rec("dvd.dit.moe.combine", 36.5, 39, parent=3),
           _rec("dvd.dit.moe", 50, 70, parent=2, **ATTRS),
           _rec("dvd.dit.moe.route", 50, 53, parent=8),
           _rec("dvd.dit.moe.experts", 53, 61, parent=8),
           _rec("dvd.dit.moe.shared", 61, 66, parent=8),
           _rec("dvd.dit.moe.combine", 66, 70, parent=8)]


@pytest.fixture
def spans(monkeypatch):
    from dvd_tpu_torch.utils import trace

    monkeypatch.setattr(trace, "records", lambda: list(RECORDS))


def test_layer_spans_read_the_known_split(spans):
    rec = {"profile": _profile(EVENTS)}
    assert reader("moe.layer_device_ms.device_paced")(rec) == \
        pytest.approx(1 + 1 + 6 + 3 + 2 + 1 + 1 + 6 + 2)
    assert reader("moe.dispatch_device_ms.device_paced")(rec) == \
        pytest.approx(1 + 1 + 1 + 1 + 2)
    assert reader("moe.blocks_device_ms.device_paced")(rec) == \
        pytest.approx(8 + 14 + 9)
    # two calls' bounds over the 9 + 6 ms inside the experts' spans
    ops, nbytes = moe_spans.experts_cost(ATTRS)
    assert ops == 6.0 * 65536 * 1152 * 4608
    assert nbytes == 2 * (2 * 65536 * 1152 + 3 * 8 * 1152 * 4608)
    bound = max(ops / 989e12, nbytes / 3.35e12)
    assert reader("moe.gemm_roofline.device_paced")(rec) == \
        pytest.approx(100 * 2 * bound / (15 * MS / 1e9))


def test_readers_read_nothing_without_the_layer(monkeypatch):
    from dvd_tpu_torch.utils import trace

    monkeypatch.setattr(trace, "records", lambda: [
        r for r in RECORDS if not r[0].startswith("dvd.dit.moe")])
    rec = {"profile": _profile(EVENTS)}
    for name in ("layer_device_ms", "dispatch_device_ms", "gemm_roofline",
                 "load_max_over_mean"):
        assert reader(f"moe.{name}.device_paced")(rec) is None
    assert reader("moe.blocks_device_ms.device_paced")(rec) is not None


def test_load_over_the_mean():
    read = reader("moe.load_max_over_mean.device_paced")
    assert read({"profile": {"moe_expert_tokens": [3, 1, 2, 2]}}) == 1.5
    assert read({"profile": {"moe_expert_tokens": [5] * 8}}) == 1.0
    assert read({"profile": {"moe_expert_tokens": [0, 0]}}) is None
    assert read({"profile": {}}) is None
