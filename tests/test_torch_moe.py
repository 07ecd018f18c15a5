"""The DiT with routed experts (``models/moe.py``, the ``DiT-MoE-*``
variants) on the CPU in float32: ``DiT-MoE-mini`` served through
``DewarpPipeline.dewarp_flow`` against the benchmark's plain reference
(``perfbench/reference/dit_moe.py``) on weights drawn by
``perfbench.weights.draw_state``, the reference following the served
routes; the layer against a token-by-token sum; the grouped GEMM against
its plain twin with an expert that gets no token; the routed pairs and
the per-expert counter; the shared expert's share; the published widths'
parameter counts on the meta device; and the refusals (int8, training,
sharding)."""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import test_torch_common  # noqa: F401  (sets torch to 1 thread)
from dvd_tpu_torch.config import default_config
from dvd_tpu_torch.evaluation import driver
from dvd_tpu_torch.evaluation.pipeline import DewarpPipeline
from dvd_tpu_torch.models.dit import make_dit
from dvd_tpu_torch.models.moe import MoE, MoESpec
from dvd_tpu_torch.ops.kernels.grouped_mm import grouped_mm, grouped_mm_ref
from dvd_tpu_torch.parallel.mesh import make_mesh, shard_params
from dvd_tpu_torch.utils import trace
from perfbench import weights
from perfbench.reference import dit_chain, dit_moe
from test_torch_common import SRC, TINY_MODEL

MINI = "DiT-MoE-mini"


def _cfg(**over):
    return default_config().replace(
        model=dict(TINY_MODEL, dit_variant=MINI, chain_blocks=True, **over),
        diffusion={"n_batch": 2})


def _layer(seed=0, dim=16, spec=MoESpec()):
    layer = MoE(dim, spec)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(torch.randn(p.shape, generator=g)
                    / math.sqrt(p.shape[-1]))
    return layer.eval()


def _dense(layer, x):
    """Each token's top-2 experts weighted by its softmax, plus the shared
    expert, token by token."""
    w, idx = F.softmax(x @ layer.gate.weight.t(), dim=-1).topk(2, dim=-1)
    experts = layer.experts()
    return torch.stack([
        sum(w[i, j] * experts[int(idx[i, j])](x[i]) for j in range(2))
        + layer.shared_experts(x[i]) for i in range(x.shape[0])])


@pytest.fixture
def clean_trace():
    trace.disable()
    trace.clear()
    yield
    trace.disable()
    trace.clear()


@torch.no_grad()
def test_mini_pipeline_matches_the_reference():
    """dewarp_flow's flows against the reference's DDIM loop from the same
    source and x_T, the reference taking the served experts of every
    (step, block, token) and weighting them itself."""
    cfg = _cfg()
    m = dict(TINY_MODEL, dit_variant=MINI)
    d = {"diffusion_steps": 3, "n_batch": 2}
    state = weights.draw_state(dit_moe.state_shapes(m), 7, "cpu")
    pipe = DewarpPipeline.create(cfg, "cpu")
    for name in ("dit", "seg", "line", "geotr"):
        getattr(pipe, name).load_state_dict(
            {k[len(name) + 1:]: v for k, v in state.items()
             if k.startswith(name + ".")}, strict=True)
    routes = []
    for mod in pipe.dit.modules():
        if isinstance(mod, MoE):
            route = mod.route

            def wrapped(x, route=route):
                idx, w = route(x)
                routes.append(idx)
                return idx, w
            mod.route = wrapped
    src = torch.rand((2, SRC, SRC, 3),
                     generator=torch.Generator().manual_seed(1))
    ref = dit_moe.Reference(m, d, state, "cpu")
    flow = pipe.dewarp_flow(src, generator=torch.Generator().manual_seed(9))
    assert len(routes) == 3 * pipe.dit.depth
    ref.follow(routes)
    want = ref.flow(src, ref.draw_xt(9, 2))
    assert dit_moe.flips(routes, ref.runs[0]) == (0, sum(
        r.shape[0] for r in routes))
    scale = want.abs().max().item()
    assert 1e-3 < scale < 1.0        # off the sampler's clamp
    assert (flow - want).abs().max().item() <= 1e-4 * scale


@torch.no_grad()
def test_layer_matches_a_token_by_token_sum():
    """The permutation, grouped GEMMs and combine equal each token's own
    top-2 experts weighted by its softmax, plus the shared expert."""
    layer = _layer()
    x = torch.randn(50, 16, generator=torch.Generator().manual_seed(1))
    assert torch.allclose(layer(x), _dense(layer, x), atol=1e-5, rtol=1e-5)


def test_grouped_route_against_the_twin():
    """``torch._grouped_mm`` (the card's bf16 route) against the per-group
    loop, uneven groups and one empty; the wrapper's CPU route is the
    twin."""
    g = torch.Generator().manual_seed(2)
    a = torch.randn(37, 32, generator=g).bfloat16()
    b = torch.randn(4, 16, 32, generator=g).bfloat16().transpose(1, 2)
    ends = torch.tensor([5, 5, 30, 37], dtype=torch.int32)
    want = grouped_mm_ref(a, b, ends)
    assert torch.equal(want[5:30], a[5:30] @ b[2])
    assert torch.equal(grouped_mm(a, b, ends), want)
    got = torch._grouped_mm(a, b, offs=ends)
    assert (got.float() - want.float()).abs().max().item() <= \
        2 ** -7 * want.float().abs().max().item()


@torch.no_grad()
def test_an_expert_without_tokens(clean_trace):
    """The router never picks expert 3: its group is empty and the result
    still equals the dense formula."""
    layer = _layer(seed=3)
    layer.gate.weight[3] = -1.0
    x = torch.randn(40, 16, generator=torch.Generator().manual_seed(4)).abs()
    trace.enable()
    y = layer(x)
    trace.disable()
    counts = trace.counts()["dvd.dit.moe.expert_tokens"]
    assert counts[3] == 0 and counts.sum() == 80
    assert torch.allclose(y, _dense(layer, x), atol=1e-5, rtol=1e-5)


@torch.no_grad()
def test_routed_pairs_and_the_counter(clean_trace):
    """tokens x top_k pairs a call; the counter sums them over calls, per
    expert as the routes say, and only while tracing is active."""
    layer = _layer()
    x = torch.randn(64, 16, generator=torch.Generator().manual_seed(5))
    layer(x)
    assert trace.counts() == {}
    idx, _ = layer.route(x)
    assert idx.shape == (64, 2) and (idx[:, 0] != idx[:, 1]).all()
    trace.enable()
    layer(x)
    layer(x[:10])
    trace.disable()
    want = torch.bincount(idx.flatten(), minlength=8) + \
        torch.bincount(idx[:10].flatten(), minlength=8)
    counts = trace.counts()["dvd.dit.moe.expert_tokens"]
    assert torch.equal(counts, want) and int(counts.sum()) == 2 * 74
    moe = [r for r in trace.records() if r[0] == "dvd.dit.moe"]
    assert [r[5]["tokens"] for r in moe] == [64, 10]
    assert moe[0][5] == {"tokens": 64, "experts": 8, "top_k": 2, "inner": 64,
                         "dim": 16, "shared_inner": 32, "itemsize": 4}
    inner = [r[0] for r in trace.records() if r[4] == 0]
    assert inner == ["dvd.dit.moe.route", "dvd.dit.moe.experts",
                     "dvd.dit.moe.shared", "dvd.dit.moe.combine"]


@torch.no_grad()
def test_shared_expert_share():
    """With the routed experts' down projections at zero the layer is the
    shared expert; with the shared one's, the routed sum."""
    layer = _layer()
    x = torch.randn(30, 16, generator=torch.Generator().manual_seed(6))
    full = layer(x)
    shared = layer.shared_experts(x)
    for ex in layer.experts():
        ex.down_proj.weight.zero_()
    assert torch.allclose(layer(x), shared, atol=1e-6)
    layer = _layer()
    layer.shared_experts.down_proj.weight.zero_()
    assert torch.allclose(layer(x), full - shared, atol=1e-5)


def test_published_widths_on_meta():
    """DiT-MoE-XL/2-8E2A's blocks: 3,567,255,552 routed-expert and
    222,953,472 shared-expert parameters, a (8, 1152) router each; the
    dense DiT-XL/2 keeps the chained reference's names."""
    with torch.device("meta"):
        dit = make_dit("DiT-MoE-XL/2-8E2A", chain_blocks=True)
        dense = make_dit("DiT-XL/2", chain_blocks=True)
    dit.variant, dense.variant = "DiT-MoE-XL/2-8E2A", "DiT-XL/2"
    routed = shared = router = 0
    for name, p in dit.named_parameters():
        if ".moe.experts_" in name:
            assert p.dim() == 2
            routed += p.numel()
        elif ".moe.shared_experts." in name:
            shared += p.numel()
        elif ".moe.gate." in name:
            assert p.shape == (8, 1152)
            router += p.numel()
    assert routed == 3_567_255_552 and shared == 222_953_472
    assert router == 28 * 8 * 1152
    blocks = sum(p.numel() for n, p in dit.named_parameters()
                 if n.startswith("blocks_"))
    # DiT-MoE's 4.16 B and DvD's cross-attention, 4 x 1152^2 a block
    assert blocks - 28 * 4 * (1152 ** 2 + 1152) == pytest.approx(4.16e9,
                                                                 rel=2e-3)
    for net, ref in ((dit, dit_moe), (dense, dit_chain)):
        shapes = ref.state_shapes(dict(dit_variant=net.variant,
                                       image_size=64, source_size=512))
        assert {k[4:]: v for k, v in shapes.items()
                if k.startswith("dit.")} == \
            {k: tuple(v.shape) for k, v in net.state_dict().items()}


def test_refusals():
    with pytest.raises(NotImplementedError, match="quantize"):
        DewarpPipeline.create(_cfg(quantize="int8"), "cpu")
    with pytest.raises(NotImplementedError, match="balance loss"):
        DewarpPipeline.create(_cfg(), "cpu", train=True)
    with pytest.raises(NotImplementedError, match="int8"):
        make_dit(MINI, quant=True)
    with pytest.raises(NotImplementedError, match="routed experts"):
        shard_params(make_dit(MINI), make_mesh(1, 1))


@pytest.mark.parametrize("mode", ["seq", "one"])
def test_one_stream_modes_route_their_stream(clean_trace, mode):
    """'seq' and 'one' hand the layer their one stream: a call a block and
    step of (pages x hypotheses x tokens) tokens."""
    pipe = DewarpPipeline.create(_cfg(separate_cross_attn=mode), "cpu",
                                 generator=torch.Generator().manual_seed(3))
    src = torch.rand((2, SRC, SRC, 3),
                     generator=torch.Generator().manual_seed(1))
    trace.enable()
    flow = pipe.dewarp_flow(src, generator=torch.Generator().manual_seed(4))
    trace.disable()
    assert torch.isfinite(flow).all()
    calls = [r[5]["tokens"] for r in trace.records() if r[0] == "dvd.dit.moe"]
    assert calls == [2 * 2 * (TINY_MODEL["image_size"] // 2) ** 2] * (3 * 2)


class _Pages:
    """``run_benchmark``'s dataset contract over three random pages of
    three sizes in a 96^2 canvas."""

    def __init__(self):
        rng = np.random.RandomState(0)
        self.pages = [rng.randint(0, 256, (80 - 9 * i, 96, 3))
                      .astype(np.uint8) for i in range(3)]
        self.sources = [rng.rand(SRC, SRC, 3).astype(np.float32)
                        for _ in range(3)]

    def __len__(self):
        return len(self.pages)

    def batches(self, batch_size):
        for start in range(0, len(self), batch_size):
            idx = list(range(start, min(start + batch_size, len(self))))
            count = len(idx)
            idx += [idx[-1]] * (batch_size - count)
            padded = np.zeros((batch_size, 96, 96, 3), np.uint8)
            for j, i in enumerate(idx):
                padded[j, :self.pages[i].shape[0]] = self.pages[i]
            yield {"source_image": np.stack([self.sources[i] for i in idx]),
                   "source_padded": padded,
                   "hw": np.array([p.shape[:2] for p in
                                   (self.pages[i] for i in idx)], np.int32),
                   "paths": [f"page_{i}.png" for i in idx], "count": count}


def test_dataset_driver_serves_the_variant(tmp_path):
    """``run_benchmark`` over the MoE pipeline: every page's coordinate
    map, finite."""
    pipe = DewarpPipeline.create(_cfg(), "cpu",
                                 generator=torch.Generator().manual_seed(3))
    stats = driver.run_benchmark(pipe, _Pages(), str(tmp_path), batch_size=3,
                                 save_outputs=False, save_coord_maps=True,
                                 mesh=None)
    maps = sorted((tmp_path / "dewarped_pred").glob("*.npy"))
    assert [m.name for m in maps] == [f"coord_page_{i}.png.npy"
                                      for i in range(3)]
    assert all(np.isfinite(np.load(m)).all() for m in maps)
    assert stats["images"] == 3
