"""The routed experts on the card (``models/moe.py``,
``ops/kernels/grouped_mm.py``): the grouped GEMM's bf16 route
(``torch._grouped_mm``, one launch a projection) against its plain twin
at DiT-MoE-XL/2's widths, about 8192 rows an expert in uneven groups and
one empty; and one served batch of the DiT-MoE-XL/2-8E2A configuration
with every expert layer under ``torch.cuda.set_sync_debug_mode("error")``
(no host synchronisation), tracing on so that the counter's path runs
too.  Every test is marked ``cuda`` and skips without a card; the file
imports neither JAX nor ``dvd_tpu``:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_moe_cuda.py
"""

import pytest
import torch

from dvd_tpu_torch.config import default_config
from dvd_tpu_torch.evaluation.pipeline import DewarpPipeline
from dvd_tpu_torch.models.moe import MoE
from dvd_tpu_torch.ops.kernels.grouped_mm import grouped_mm, grouped_mm_ref
from dvd_tpu_torch.utils import trace

pytestmark = pytest.mark.cuda
D, INNER, E = 1152, 4608, 8


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the grouped GEMM's route runs on "
                    "the card)")
    return torch.device("cuda")


@pytest.mark.parametrize("k, n", [(D, 2 * INNER), (INNER, D)])
def test_grouped_gemm_against_its_twin(card, k, n):
    g = torch.Generator(device=card).manual_seed(0)
    sizes = [8192, 11000, 0, 5000, 9000, 7000, 12000, 13344]
    a = torch.randn(sum(sizes), k, generator=g, device=card).bfloat16()
    b = (torch.randn(E, n, k, generator=g, device=card) / k ** 0.5) \
        .bfloat16().transpose(1, 2)
    ends = torch.tensor(sizes, device=card).cumsum(0).to(torch.int32)
    before = grouped_mm.launches
    got = grouped_mm(a, b, ends)
    assert grouped_mm.launches == before + 1
    want = grouped_mm_ref(a, b, ends)
    torch.cuda.synchronize()
    # both round an f32 sum to bf16: at most a unit of bf16 apart
    scale = want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= 2 ** -7 * scale


def test_served_batch_makes_no_host_sync(card):
    cfg = default_config().replace(model=dict(
        dit_variant="DiT-MoE-XL/2-8E2A", chain_blocks=True,
        compute_dtype="bfloat16"))
    pipe = DewarpPipeline.create(cfg, card)
    layers = [m for m in pipe.dit.modules() if isinstance(m, MoE)]
    assert len(layers) == 28
    calls = []
    for layer in layers:
        forward = layer.forward

        def checked(x, forward=forward):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return forward(x)
            finally:
                torch.cuda.set_sync_debug_mode(0)
                calls.append(x.shape[0])
        layer.forward = checked
    src = torch.rand((4, 512, 512, 3),
                     generator=torch.Generator().manual_seed(1)).to(card)
    pipe.dewarp_flow(src, generator=torch.Generator(card).manual_seed(2))
    trace.clear()
    trace.enable()
    launches = grouped_mm.launches
    try:
        flow = pipe.dewarp_flow(
            src, generator=torch.Generator(card).manual_seed(2))
    finally:
        trace.disable()
    steps = cfg.diffusion.diffusion_steps
    assert calls == [4 * 8 * 1024] * (2 * steps * 28)
    assert grouped_mm.launches - launches == 2 * steps * 28
    counts = trace.counts()["dvd.dit.moe.expert_tokens"].tolist()
    assert sum(counts) == steps * 28 * 4 * 8 * 1024 * 2
    assert torch.isfinite(flow).all()
    trace.clear()
