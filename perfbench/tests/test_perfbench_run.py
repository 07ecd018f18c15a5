"""A whole run of each serving cell at a tiny size on the CPU (the card
check skipped, the program on its plain CPU path in float32), correct as
it stands and not correct with the timed path broken underneath: the
sampler handing back its starting state, half of each batch computed and
the rest copied from it, a flow or a page altered where it is produced.
And the frozen reference against the served package's CPU path."""

import copy

import pytest
import torch

from perfbench import harness, pages, serving, weights
from perfbench.reference import serve as R
from perfbench.run import run_cell

TINY_MODEL = dict(dit_variant="DiT-mini", image_size=16, source_size=128,
                  perception_size=64, compute_dtype="float32")
TINY_TRAFFIC = dict(pool_batches=2, pool_pages=4, sides=[100, 200],
                    canvas=256, warm_batches=1)
SERVE_CELLS = ["dits2-serve-b4", "dits2-dataset-2048"]
SEED = 2 ** 31 + 12345


def tiny(name):
    cell = copy.deepcopy(harness.load_cell(name))
    cell.config["model"].update(TINY_MODEL)
    cell.traffic.update(TINY_TRAFFIC, check_pages=cell.traffic["batch"])
    return cell


def test_reference_equals_the_served_cpu_path():
    from dvd_tpu_torch.evaluation.pipeline import unwarp_fixed, unwarp_native

    cell = tiny("dits2-serve-b4")
    pipe, _ = serving.build_pipeline(cell.config, SEED, "cpu")
    ref = serving.build_reference(cell.config, SEED, "cpu")
    src = pages.pages(2, 128, 128, torch.Generator().manual_seed(3))
    flow = pipe.dewarp_flow(src, generator=torch.Generator().manual_seed(9))
    rflow = ref.flow(src, ref.draw_xt(9, 2))
    assert flow.abs().max() > 0.05
    assert (flow - rflow).abs().max() <= 1e-5
    out = unwarp_fixed(src, flow)
    assert (out - R.unwarp_fixed(src, flow)).abs().max() <= 1e-3
    # a native-size page in a canvas, against the reference's page alone
    page = pages.photo_u8(150, 110, torch.Generator().manual_seed(4))
    canvas = torch.zeros((1, 256, 256, 3), dtype=torch.uint8)
    canvas[0, :150, :110] = page
    got = unwarp_native(canvas, torch.tensor([[150, 110]]), flow[:1])
    want = R.unwarp_fixed(page[None], flow[:1])[0]
    assert (got[0, :150, :110] - want).abs().max() <= 0.05


def test_weights_are_drawn_from_the_seed():
    shapes = R.state_shapes(TINY_MODEL)
    a = weights.draw_state(shapes, 5, "cpu")
    b = weights.draw_state(shapes, 5, "cpu")
    c = weights.draw_state(shapes, 6, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)
    var = [v for k, v in a.items() if k.endswith(".var")]
    assert var and all(((v >= 0.5) & (v <= 1.5)).all() for v in var)


@pytest.mark.parametrize("name", SERVE_CELLS)
def test_run_is_correct(name):
    res = run_cell(tiny(name), SEED, 1.0, False, "cpu")
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {m["name"] for m in
                                   harness.load_cell(name).end_to_end}
    assert list(res)[-1] == "checks"


def _state_unchanged(monkeypatch):
    from dvd_tpu_torch.diffusion import sampler
    from dvd_tpu_torch.evaluation import pipeline

    def loop(model_fn, sched, cond, init_flow, *a, **k):
        return sampler.SampleResult(flow=init_flow,
                                    hypotheses=init_flow[None])

    monkeypatch.setattr(pipeline, "ddim_sample_loop", loop)


def _half_batch(monkeypatch):
    from dvd_tpu_torch.evaluation.pipeline import DewarpPipeline

    real_s = DewarpPipeline.sampling_impl

    def half_s(self, cond, init_flow, init_feat, generator=None,
               init_noise=None):
        n = max(1, init_flow.shape[0] // 2)
        cut = {k: v[:n] for k, v in cond.items()}
        flow = real_s(self, cut, init_flow[:n], init_feat[:n], generator,
                      init_noise)
        return flow.repeat(-(-init_flow.shape[0] // n), 1, 1, 1)[
            :init_flow.shape[0]]

    monkeypatch.setattr(DewarpPipeline, "sampling_impl", half_s)


def _flow_altered(monkeypatch):
    from dvd_tpu_torch.evaluation.pipeline import DewarpPipeline

    real = DewarpPipeline.sampling_impl

    def altered(self, *a, **k):
        flow = real(self, *a, **k)
        flow[:, 3:7, 3:7] += 0.25
        return flow

    monkeypatch.setattr(DewarpPipeline, "sampling_impl", altered)


def _page_altered(monkeypatch):
    from dvd_tpu_torch.evaluation import driver, pipeline

    real_fixed, real_u8 = pipeline.unwarp_fixed, driver.unwarp_u8

    def fixed(source, flow, *a):
        out = real_fixed(source, flow, *a)
        return out.flip(1)

    def u8(padded, hw, flow):
        return real_u8(padded, hw, flow).flip(2)

    monkeypatch.setattr(pipeline, "unwarp_fixed", fixed)
    monkeypatch.setattr(driver, "unwarp_u8", u8)


def _mask_flipped(monkeypatch):
    """Seg's hard mask turned inside out where it is made; its soft mask
    is left as it was."""
    from dvd_tpu_torch.models import u2net

    def forward(self, x):
        d0, *pyramid = self.msk(x)
        mskx = (d0 <= 0.5).to(x.dtype) * x
        d0_up = u2net.resize_bilinear(d0, (self.mask_size,) * 2, True)
        return mskx, d0_up, tuple(pyramid)

    monkeypatch.setattr(u2net.Seg, "forward", forward)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "flow_altered": _flow_altered, "page_altered": _page_altered,
          "mask_flipped": _mask_flipped}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", SERVE_CELLS)
def test_broken_path_is_not_correct(monkeypatch, name, fault):
    FAULTS[fault](monkeypatch)
    res = run_cell(tiny(name), SEED, 0.5, False, "cpu")
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("name", SERVE_CELLS)
def test_fp8_control_is_not_correct(name):
    """The reference computed a precision below (float8 operands, the
    unwarp in bfloat16), put in the program's place, fails the cell's
    limits, while the program's own run passes them."""
    res = run_cell(tiny(name), SEED, 0.5, False, "cpu", controls=True)
    assert res["correct"], res["checks"]
    assert res["control_correct"] is False, res["control_checks"]
    assert set(res["control_checks"]) == set(res["checks"])


# --------------------------------------------------------- on the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cell runs the CUDA kernels")
    return "cuda:0"


@pytest.mark.cuda
def test_int8_control_is_not_correct_at_the_cells_size(card):
    """The program's own int8 path, the precision below the configured
    bf16, fails the check of the shipped batch-4 cell."""
    res = run_cell(harness.load_cell("dits2-serve-b4"), SEED, 3.0, False,
                   card, over={"model": {"quantize": "int8"}})
    assert not res["correct"], res["checks"]


@pytest.mark.cuda
def test_fp8_control_is_not_correct_at_the_cells_size(card):
    """The reference on float8 operands with its unwarp in bfloat16, in
    the program's place, fails the check of the shipped batch-4 cell."""
    res = run_cell(harness.load_cell("dits2-serve-b4"), SEED, 3.0, False,
                   card, controls=True)
    assert res["correct"], res["checks"]
    assert res["control_correct"] is False, res["control_checks"]
