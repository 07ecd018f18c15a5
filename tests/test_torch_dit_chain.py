"""The port's chained 'para' DiT (``chain_blocks=True``) on the CPU in
float32: against the benchmark's plain chained reference
(``perfbench/reference/dit_chain.py``) on weights drawn by
``perfbench.weights.draw_state``, at DiT-mini and at a narrow size whose
head dim is DiT-XL's 72; block 0 live in the chain and dead without it;
and the DiT's ``dvd.dit.blocks`` and ``dvd.dit.decoder`` spans, once per
DDIM step with their attributes, none while tracing is off."""

import pytest
import torch

import test_torch_common  # noqa: F401  (sets torch to 1 thread)
from dvd_tpu_torch.config import default_config
from dvd_tpu_torch.evaluation.pipeline import DewarpPipeline
from dvd_tpu_torch.models.dit import DiT
from dvd_tpu_torch.utils import trace
from perfbench import weights
from perfbench.reference import dit_chain
from test_torch_common import SRC, TINY_MODEL

S = 16
# (patch, hidden, depth, heads): DiT-mini, and 144 wide in 2 heads of 72
SIZES = {"mini": dit_chain.SIZES["DiT-mini"], "dh72": (2, 144, 3, 2)}


def _pair(size: str, seed: int = 5):
    """(the port's chained DiT, the reference's), one drawn state."""
    patch, hidden, depth, heads = SIZES[size]
    ref = dit_chain.ChainDiT(S, patch, hidden, depth, heads).eval()
    state = weights.draw_state({k: tuple(v.shape) for k, v in
                                ref.state_dict().items()}, seed, "cpu")
    ref.load_state_dict(state, strict=True)
    net = DiT(input_size=S, patch_size=patch, hidden_size=hidden,
              depth=depth, num_heads=heads, chain_blocks=True, dropout=0.0)
    net.load_state_dict(state, strict=True)
    return net.eval(), ref


def _inputs(ref, n: int = 4, seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g)
    src_feat = r(n, 256, S, S)
    return dict(
        x=r(n, S, S, 2), t=torch.tensor([1000 * 2 / 3, 1000 / 3, 0.0,
                                         1000 * 2 / 3][:n]),
        init_flow=0.1 * r(n, S, S, 2), init_feat=r(n, 256, S, S),
        seed=torch.tensor([True, False, False, True][:n]), src_feat=src_feat,
        cond_tokens=ref.embed("c_embedder", src_feat),
        msk6_tokens=ref.embed("m_embedder", r(n, 384, S, S)),
        line_tokens=ref.embed("l_embedder", r(n, 64, S, S)))


@pytest.mark.parametrize("size", sorted(SIZES))
@torch.no_grad()
def test_chained_dit_matches_the_plain_reference(size):
    net, ref = _pair(size)
    a = _inputs(ref)
    want, want_feat = ref(a["x"], a["t"], init_flow=a["init_flow"],
                          init_feat=a["init_feat"], seed=a["seed"],
                          src_feat=a["src_feat"], cond_tokens=a["cond_tokens"],
                          msk6_tokens=a["msk6_tokens"],
                          line_tokens=a["line_tokens"])
    got, got_feat = net(a["x"], a["t"], init_flow=a["init_flow"],
                        init_feat=a["init_feat"], src_feat=a["src_feat"],
                        cond_tokens=a["cond_tokens"],
                        msk6_tokens=a["msk6_tokens"],
                        line_tokens=a["line_tokens"], seed_init_feat=a["seed"],
                        remap_timesteps=True)
    # the DiT's own part of the flow, beside the init_flow it adds
    delta = want - a["init_flow"]
    scale = delta.abs().max().item()
    assert scale > 1e-2
    assert (got - want).abs().max().item() <= 1e-5 * scale
    assert torch.equal(got_feat, want_feat)


def _pipe(chain: bool, variant: str = "DiT-mini"):
    cfg = default_config().replace(
        model=dict(TINY_MODEL, dit_variant=variant, chain_blocks=chain),
        diffusion={"n_batch": 2})
    return DewarpPipeline.create(cfg, "cpu",
                                 generator=torch.Generator().manual_seed(3))


def _flow(pipe, seed: int = 4):
    src = torch.rand((2, SRC, SRC, 3),
                     generator=torch.Generator().manual_seed(1))
    return pipe.dewarp_flow(src, generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("chain", [True, False])
def test_block_zero_is_live_only_in_the_chain(chain):
    pipe = _pipe(chain)
    before = _flow(pipe)
    with torch.no_grad():
        for p in pipe.dit.blocks_0.parameters():
            p.mul_(-1.5)
    moved = (_flow(pipe) - before).abs().max().item()
    if chain:
        assert moved > 1e-3
    else:
        assert moved == 0.0


@pytest.fixture
def clean_trace():
    trace.disable()
    trace.clear()
    yield
    trace.disable()
    trace.clear()


@pytest.mark.parametrize("chain", [True, False])
def test_dit_spans_once_a_step(clean_trace, chain):
    pipe = _pipe(chain)
    _flow(pipe)
    assert trace.records() == []     # tracing off: nothing recorded
    trace.enable()
    _flow(pipe)
    trace.disable()
    recs = trace.records()
    steps = [i for i, r in enumerate(recs) if r[0] == "dvd.sample.step"]
    assert len(steps) == pipe.cfg.diffusion.diffusion_steps
    dit = pipe.dit
    want = {"dvd.dit.blocks": {"blocks": dit.depth if chain else 1,
                               "streams": 4, "tokens": (S // 2) ** 2},
            "dvd.dit.decoder": {"width": 4 * dit.hidden_size}}
    for name, attrs in want.items():
        mine = [r for r in recs if r[0] == name]
        assert [r[4] for r in mine] == steps     # one in each step
        assert all(r[5] == attrs and r[2] is not None for r in mine)
    blocks, decoder = ([r for r in recs if r[0] == n] for n in want)
    assert all(b[2] <= d[1] for b, d in zip(blocks, decoder))
