"""The hand-written CUDA kernels against their plain twins on the card.

These kernels have no CPU mode, so every test here is marked ``cuda`` and
skips without a CUDA device.  The file imports neither JAX nor the
``dvd_tpu`` package, so it runs on a GPU machine without them:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Shapes are small edge cases (ragged lengths, odd planes, every head dim
and dilation the kernels take, out-of-range coordinates); the serving and
training paths' full shapes are checked by ``chip_smoke.py``.  The
autograd Functions (attention, the trainable conv, ``warp_const_src``)
are checked against the autograd of the plain versions.
"""

import pytest
import torch

from dvd_tpu_torch.evaluation.pipeline import (native_grid, unwarp_fixed,
                                               unwarp_native)
from dvd_tpu_torch.models.layers import conv1x1_f32
from dvd_tpu_torch.ops.grid_sample import unnormalize, warp_const_src
from dvd_tpu_torch.ops.kernels.attention import HEAD_DIMS, attention, attention_ref
from dvd_tpu_torch.ops.kernels.conv3x3 import (conv3x3, conv3x3_ref,
                                               conv3x3_trainable,
                                               k_major_weights,
                                               k_major_weights_split,
                                               wgmma_plan)
from dvd_tpu_torch.ops.kernels.gather2d import gather2d, gather2d_ref
from dvd_tpu_torch.ops.kernels.grid_sample import (
    gather_bilinear, gather_bilinear_grad, gather_bilinear_grad_grid_ref,
    gather_bilinear_grid, gather_bilinear_grid_ref, gather_bilinear_ref)
from dvd_tpu_torch.ops.kernels.unwarp import unwarp, unwarp_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _gen():
    return torch.Generator().manual_seed(0)


def _routes():
    return attention.launches_wgmma, attention.launches_f32


@pytest.mark.parametrize("dh", HEAD_DIMS)
@pytest.mark.parametrize("tq,tk", [(64, 64), (37, 100), (130, 7)])
def test_attention_kernel(dev, dh, tq, tk):
    """f32: the split-product tensor-core kernel, at the f32 bar; Tk 100
    and 7 leave ragged 32- and 64-row tiles."""
    g = _gen()
    q = torch.randn(2, 3, tq, dh, generator=g).to(dev)
    k = torch.randn(2, 3, tk, dh, generator=g).to(dev)
    v = torch.randn(2, 3, tk, dh, generator=g).to(dev)
    before, (wgmma, f32) = attention.launches, _routes()
    got = attention(q, k, v, 0.3)
    assert attention.launches == before + 1
    assert _routes() == (wgmma, f32 + 1)
    torch.testing.assert_close(got, attention_ref(q, k, v, 0.3),
                               rtol=1e-4, atol=1e-4)


# ragged lengths: Tk below one 64-row K/V tile (7, 37), not a multiple of 8
# (7, 100, 1000), Tq over one 128-row block (130, 200, 1000)
@pytest.mark.parametrize("dh", HEAD_DIMS)
@pytest.mark.parametrize("tq,tk", [(64, 64), (37, 100), (130, 7), (200, 37),
                                   (1000, 1000)])
def test_attention_wgmma_kernel(dev, dh, tq, tk):
    """bf16: the tensor-core kernel, against the twin on the same bf16
    inputs; they differ where p rounds to bf16 (the twin rounds the
    normalised p, the kernel p relative to the running max)."""
    g = _gen()
    q = torch.randn(2, 3, tq, dh, generator=g).to(dev, torch.bfloat16)
    k = torch.randn(2, 3, tk, dh, generator=g).to(dev, torch.bfloat16)
    v = torch.randn(2, 3, tk, dh, generator=g).to(dev, torch.bfloat16)
    before, (wgmma, f32) = attention.launches, _routes()
    got = attention(q, k, v, 0.3)
    assert attention.launches == before + 1
    assert _routes() == (wgmma + 1, f32)
    want = attention_ref(q, k, v, 0.3)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=2e-2 * max(1.0, want.float().abs().max().item()))


@pytest.mark.parametrize("dh", [64, 256])
def test_attention_strided_bf16(dev, dh):
    """split_heads views (strided) in bf16; output in q's dtype."""
    g = _gen()
    x = torch.randn(2, 50, 3, 4, dh, generator=g).to(dev, torch.bfloat16)
    q, k, v = (x[:, :, i].transpose(1, 2) for i in range(3))
    wgmma = attention.launches_wgmma
    got = attention(q, k, v, 1 / 8)
    assert attention.launches_wgmma == wgmma + 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    torch.testing.assert_close(got.float(), attention_ref(q, k, v, 1 / 8).float(),
                               rtol=0, atol=2e-2)


def test_attention_f32_misaligned_views_are_copied(dev):
    """An f32 view 4 bytes off a 16-byte boundary, or with a row stride of
    65 elements, still launches the f32 kernel (on an aligned copy) and
    equals the twin at the f32 bar."""
    g = _gen()
    buf = torch.randn(1 + 2 * 8 * 64, generator=g).to(dev)
    wide = torch.randn(1, 2, 8, 65, generator=g).to(dev)
    for q in (buf[1:].view(1, 2, 8, 64), wide[..., :64]):
        f32 = attention.launches_f32
        got = attention(q, q, q)
        assert attention.launches_f32 == f32 + 1
        torch.testing.assert_close(got, attention_ref(q, q, q, 1 / 8),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cin,cout,hw,dil", [
    (3, 16, (17, 23), 1), (4, 64, (8, 40), 1), (16, 16, (9, 9), 2),
    (16, 16, (9, 9), 4), (64, 16, (9, 9), 8), (40, 1, (11, 5), 1),
    (130, 33, (6, 70), 1), (9, 40, (9, 9), 32)])   # largest halo that fits
@pytest.mark.parametrize("relu", [True, False])
def test_conv3x3_kernel(dev, cin, cout, hw, dil, relu):
    """f32: the split-product implicit GEMM, at the f32 bar."""
    g = _gen()
    x = torch.randn(2, cin, *hw, generator=g).to(dev)
    w = (torch.randn(cout, cin, 3, 3, generator=g) / (3 * cin ** 0.5)).to(dev)
    s = (1 + 0.1 * torch.randn(cout, generator=g)).to(dev)
    b = (0.1 * torch.randn(cout, generator=g)).to(dev)
    before, (wgmma, f32) = conv3x3.launches, _conv_routes()
    got = conv3x3(x, w, s, b, dil, relu)
    assert conv3x3.launches == before + 1
    assert _conv_routes() == (wgmma, f32 + 1)
    # the cached operand the aux nets pass gives the same result
    assert torch.equal(conv3x3(x, w, s, b, dil, relu, k_major_weights_split(w)),
                       got)
    torch.testing.assert_close(got, conv3x3_ref(x, w, s, b, dil, relu),
                               rtol=1e-4, atol=1e-5)
    plan = wgmma_plan(2, cin, cout, *hw, dil, torch.float32)
    assert plan["cc"] == (8 if cin <= 8 else 16) and plan["smem"] <= 232448


def _conv_routes():
    return conv3x3.launches_wgmma, conv3x3.launches_f32


# every block width (Cout 1 -> n8, 16 -> n16, 33..64 -> n64, 128 and 200 ->
# n128), Cin 3 and 4 (two taps per k16 step), 16, 130 and 1024 (a ragged
# and a deep chunk count), planes 9^2, 18^2, 36^2 (rows 4- and 2-byte
# aligned, odd: plain loads), an odd 17x23 and tiles across a wide 6x70 or
# a 16-byte aligned 40x72, dilations 1-32 (32: only the tap bands staged);
# the last four are large planes: 256-pixel blocks (mt 2) at n128 with
# chunks of 16 and 32 channels, and 128-pixel ones at n64
@pytest.mark.parametrize("cin,cout,hw,dil,mt", [
    (3, 16, (17, 23), 1, 1), (4, 64, (36, 36), 1, 1), (16, 16, (9, 9), 2, 1),
    (16, 16, (9, 9), 4, 1), (16, 16, (9, 9), 8, 1), (64, 1, (18, 18), 1, 1),
    (130, 33, (6, 70), 1, 1), (9, 40, (9, 9), 32, 1), (1024, 128, (9, 9), 1, 1),
    (32, 200, (18, 18), 2, 1), (64, 8, (36, 36), 32, 1),
    (128, 64, (40, 72), 3, 1), (16, 64, (40, 72), 8, 1),
    (32, 256, (128, 160), 1, 2), (16, 64, (256, 160), 2, 1),
    (16, 128, (160, 256), 1, 2), (64, 64, (256, 160), 1, 1)])
@pytest.mark.parametrize("relu", [True, False])
def test_conv3x3_wgmma_kernel(dev, cin, cout, hw, dil, mt, relu):
    """bf16: the tensor-core implicit GEMM, against the twin on the same
    bf16 inputs (the two sum in different orders: at most a bf16 rounding
    apart)."""
    g = _gen()
    x = torch.randn(2, cin, *hw, generator=g).to(dev, torch.bfloat16)
    w = (torch.randn(cout, cin, 3, 3, generator=g) / (3 * cin ** 0.5)).to(
        dev, torch.bfloat16)
    s = (1 + 0.1 * torch.randn(cout, generator=g)).to(dev)
    b = (0.1 * torch.randn(cout, generator=g)).to(dev)
    before, (wgmma, f32) = conv3x3.launches, _conv_routes()
    got = conv3x3(x, w, s, b, dil, relu)
    assert conv3x3.launches == before + 1
    assert _conv_routes() == (wgmma + 1, f32)
    # the cached operand the aux nets pass gives the same result
    assert torch.equal(conv3x3(x, w, s, b, dil, relu, k_major_weights(w)), got)
    want = conv3x3_ref(x, w, s, b, dil, relu)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=2e-2 * max(1.0, want.float().abs().max().item()))
    plan = wgmma_plan(2, cin, cout, *hw, dil)
    assert plan["bn"] == (8 if cout <= 8 else 16 if cout <= 16 else
                          64 if cout <= 64 else 128)
    assert plan["mt"] == mt and plan["smem"] <= 232448


# C: one group per channel up to 4, groups of 8 above (5 and 257 leave a
# ragged last group); P x Q: ragged (99, 199) and multiples of 4 (vector
# loads and stores); coordinates up to 1e9 pixels out of range
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
@pytest.mark.parametrize("c", [1, 2, 3, 5, 256, 257])
@pytest.mark.parametrize("pq", [(9, 11), (3, 200), (32, 64)])
def test_gather_kernel(dev, padding_mode, c, pq):
    """Both entries (the [-1, 1] grid and the pixel planes) of K3."""
    n, h, w = 2, 13, 17
    p, q = pq
    g = _gen()
    img = torch.rand(n, c, h, w, generator=g).to(dev)
    grid = torch.rand(n, p, q, 2, generator=g) * 2.8 - 1.4
    grid[0, 0, :3] = torch.tensor([[1e9, -1e9], [-1e9, 3.0], [2.0, 1e9]])
    grid = grid.to(dev)
    gx = unnormalize(grid[..., 0], w).contiguous()
    gy = unnormalize(grid[..., 1], h).contiguous()
    before = (gather_bilinear_grid.launches, gather_bilinear.launches)
    got = gather_bilinear_grid(img, grid, padding_mode)
    got_planes = gather_bilinear(img, gx, gy, padding_mode)
    assert (gather_bilinear_grid.launches, gather_bilinear.launches) == (
        before[0] + 1, before[1] + 1)
    torch.testing.assert_close(
        got, gather_bilinear_grid_ref(img, grid, padding_mode), rtol=0,
        atol=1e-5)
    torch.testing.assert_close(
        got_planes, gather_bilinear_ref(img, gx, gy, padding_mode), rtol=0,
        atol=1e-5)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    g = _gen()
    q = torch.randn(1, 2, 8, 264, generator=g).to(dev)     # Dh > 256
    with pytest.raises(ValueError):
        attention(q, q, q)
    buf = torch.randn(1 + 2 * 8 * 64, generator=g).to(dev, torch.bfloat16)
    q = buf[1:].view(1, 2, 8, 64)                           # off by one element
    with pytest.raises(ValueError):
        attention(q, q, q)
    q = torch.randn(1, 2, 8, 65, generator=g).to(dev, torch.bfloat16)[..., :64]
    with pytest.raises(ValueError):                         # row stride 65
        attention(q, q, q)
    x = torch.randn(1, 4, 8, 8, generator=g).to(dev)
    w = torch.randn(4, 4, 3, 3, generator=g).to(dev)
    one = torch.ones(4, device=dev)
    with pytest.raises(TypeError):                          # dtype mismatch
        conv3x3(x, w.double(), one, one)
    with pytest.raises(ValueError):                         # non-contiguous
        conv3x3(x.transpose(2, 3), w, one, one)
    with pytest.raises(ValueError):                         # halo too wide
        conv3x3(x, w, one, one, dilation=33)
    buf = torch.randn(1 + 4 * 8 * 8, generator=g).to(dev, torch.bfloat16)
    xb, wb = buf[1:].view(1, 4, 8, 8), w.bfloat16()          # off by one element
    with pytest.raises(ValueError):                         # bf16: 16-byte bases
        conv3x3(xb, wb, one, one)
    with pytest.raises(ValueError):                         # bf16: not wk of w
        conv3x3(xb.clone(), wb, one, one, wk=k_major_weights(wb)[:, :16])
    with pytest.raises(ValueError):                         # f32: not the split
        conv3x3(x, w, one, one, wk=k_major_weights(w))
    img = torch.rand(1, 2, 4, 4, generator=g).to(dev)
    with pytest.raises(TypeError):
        gather_bilinear(img.half(), img[:, 0], img[:, 1])
    grid = img.permute(0, 2, 3, 1).contiguous()              # (1, 4, 4, 2)
    with pytest.raises(ValueError):                         # K3: strided grid
        gather_bilinear_grid(img, img.permute(0, 2, 3, 1))
    with pytest.raises(TypeError):                          # K4: f64 ct
        gather_bilinear_grad(img, grid, img.double())
    with pytest.raises(ValueError):                         # K4: ct shape
        gather_bilinear_grad(img, grid, img[:, :1].contiguous())
    with pytest.raises(ValueError):                         # K4: strided
        gather_bilinear_grad(img, grid.transpose(1, 2), img)
    with pytest.raises(ValueError):                         # K4: mixed devices
        gather_bilinear_grad(img, grid, img.cpu())
    page = torch.zeros(1, 8, 8, 2, dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError):                         # unwarp: C 2
        unwarp(page, torch.zeros(1, 4, 4, 2, device=dev))


# C 1-4 (unrolled) and 5 (the run-time loop); ragged and vector P x Q
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
@pytest.mark.parametrize("shape", [(2, 3, 13, 17, 9, 11), (1, 2, 7, 129, 3, 200),
                                   (3, 1, 64, 64, 31, 33), (2, 4, 20, 24, 16, 8),
                                   (1, 5, 9, 10, 8, 12)])
def test_gather_grad_kernel(dev, padding_mode, shape):
    """K4 on the [-1, 1] grid: d/dgrid, (N, P, Q, 2)."""
    n, c, h, w, p, q = shape
    g = _gen()
    img = torch.rand(n, c, h, w, generator=g).to(dev)
    grid = (torch.rand(n, p, q, 2, generator=g) * 2.8 - 1.4).to(dev)
    ct = torch.randn(n, c, p, q, generator=g).to(dev)
    before = gather_bilinear_grad.launches
    got = gather_bilinear_grad(img, grid, ct, padding_mode)
    assert gather_bilinear_grad.launches == before + 1
    want = gather_bilinear_grad_grid_ref(img, grid, ct, padding_mode)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * max(1.0, want.abs().max().item()))


def _grads(fn, inputs, ct):
    """[fn's output, the gradient of sum(output * ct) for each input]."""
    leaves = [x.detach().clone().requires_grad_() for x in inputs]
    out = fn(*leaves)
    torch.autograd.backward(out, ct)
    return [out.detach()] + [x.grad for x in leaves]


def _close_grads(got, want, bar):
    for a, b in zip(got, want):
        torch.testing.assert_close(
            a.float(), b.float(), rtol=0,
            atol=bar * max(1.0, b.float().abs().max().item()))


def test_warp_const_src_grad(dev):
    """Forward K3, backward K4, against the autograd of the plain gather."""
    g = _gen()
    src = torch.rand(2, 2, 40, 70, generator=g).to(dev)
    grid = (torch.rand(2, 33, 65, 2, generator=g) * 2.2 - 1.1).to(dev)
    ct = torch.randn(2, 2, 33, 65, generator=g).to(dev)
    before = gather_bilinear_grad.launches
    got = _grads(lambda gr: warp_const_src(src, gr), [grid], ct)
    assert gather_bilinear_grad.launches == before + 1

    def plain(gr):
        return gather_bilinear_ref(src, unnormalize(gr[..., 0], 70),
                                   unnormalize(gr[..., 1], 40), "zeros")

    _close_grads(got, _grads(plain, [grid], ct), 1e-5)


@pytest.mark.parametrize("dtype,bar", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("dh", [64, 256])
def test_attention_function_grads(dev, dtype, bar, dh):
    """The Function (K1 forward, f32 recompute backward) against autograd
    of the plain twin; bf16 differs by the twin's bf16 probabilities."""
    g = _gen()
    q, k, v = (torch.randn(2, 3, t_, dh, generator=g).to(dev, dtype)
               for t_ in (50, 70, 70))
    ct = torch.randn(2, 3, 50, dh, generator=g).to(dev, dtype)
    before, (wgmma, f32) = attention.launches, _routes()
    got = _grads(lambda *a: attention(*a, 0.1), [q, k, v], ct)
    assert attention.launches == before + 1
    assert _routes() == ((wgmma + 1, f32) if dtype == torch.bfloat16
                         else (wgmma, f32 + 1))
    _close_grads(got, _grads(lambda *a: attention_ref(*a, 0.1), [q, k, v], ct),
                 bar)


@pytest.mark.parametrize("dtype,bar", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("dilation", [1, 2])
def test_conv3x3_function_grads(dev, dtype, bar, dilation):
    """The trainable conv (K2 forward on the live weights, cuDNN backward)
    against autograd of the plain twin, without the ReLU (its mask flips
    where the two forwards straddle zero); w and b stay f32."""
    g = _gen()
    x = torch.randn(2, 5, 19, 23, generator=g).to(dev, dtype)
    w = (torch.randn(7, 5, 3, 3, generator=g) / 6).to(dev)
    b = (0.1 * torch.randn(7, generator=g)).to(dev)
    ct = torch.randn(2, 7, 19, 23, generator=g).to(dev, dtype)
    before = conv3x3.launches
    got = _grads(lambda *a: conv3x3_trainable(*a, dilation, False),
                 [x, w, b], ct)
    assert conv3x3.launches == before + 1
    assert got[2].dtype == got[3].dtype == torch.float32
    want = _grads(lambda xx, ww, bb: conv3x3_ref(
        xx, ww, torch.ones_like(bb), bb, dilation, False), [x, w, b], ct)
    _close_grads(got, want, bar)


@pytest.mark.parametrize("hw,mn", [((64, 256), (8, 128)), ((1, 1), (1, 1)),
                                   ((33, 130), (17, 257)), ((2048, 3), (5, 3))])
def test_gather2d_kernel(dev, hw, mn):
    """K5 equals its twin bit for bit, out-of-range indices (0.0) included."""
    g = _gen()
    img = torch.randn(hw, generator=g).to(dev)
    y = torch.randint(-2, hw[0] + 2, mn, generator=g, dtype=torch.int32).to(dev)
    x = torch.randint(-2, hw[1] + 2, mn, generator=g, dtype=torch.int32).to(dev)
    before = gather2d.launches
    got = gather2d(img, y, x)
    assert gather2d.launches == before + 1
    assert torch.equal(got, gather2d_ref(img, y, x))
    with pytest.raises(TypeError):                          # int64 indices
        gather2d(img, y.long(), x.long())
    with pytest.raises(ValueError):                         # strided
        gather2d(torch.randn(4, 6, device=dev)[:, ::2], y, x)


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_gather2d_vector_tail_and_offset_views(dev, offset):
    """K5's four-a-thread path with its MN % 4 tail (offset 0) and its
    scalar path for index planes 4-12 bytes off a 16-byte boundary equal
    the twin bit for bit."""
    g = _gen()
    img = torch.randn((50, 70), generator=g).to(dev)
    m, n = 37, 101                      # 3737 = 4 * 934 + 1
    y, x = (torch.randint(-3, 75, (m * n + offset,), generator=g,
                          dtype=torch.int32).to(dev)[offset:].view(m, n)
            for _ in range(2))
    assert x.is_contiguous() and y.data_ptr() % 16 == 4 * offset
    assert torch.equal(gather2d(img, y, x), gather2d_ref(img, y, x))


@pytest.mark.parametrize("tf32", [False, True])
def test_unwarp_native_on_the_card(dev, tf32):
    """unwarp_native through K3 against the CPU (twin): two pages of
    different sizes in one canvas, a bf16 flow; the grid stays f32 with
    TF32 on."""
    g = _gen()
    hw = torch.tensor([[300, 211], [257, 320]], dtype=torch.int32)
    pad = (torch.rand(2, 320, 320, 3, generator=g) * 255).round().to(torch.uint8)
    flow = ((torch.rand(2, 64, 64, 2, generator=g) - 0.5) * 0.1).to(torch.bfloat16)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        got = unwarp_native(pad.to(dev), hw.to(dev), flow.to(dev)).cpu()
        grid = native_grid(hw.to(dev), flow.to(dev), 320)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    want = unwarp_native(pad, hw, flow)
    for a, b in zip(grid, native_grid(hw, flow, 320)):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-5)
    for i, (h, w) in enumerate(hw.tolist()):
        torch.testing.assert_close(got[i, :h, :w], want[i, :h, :w],
                                   rtol=0, atol=0.5)


def _pages(hws, p, c, dtype, g):
    """A (B, p, p, c) canvas with seeded pages of sizes ``hws`` at the top
    left (uint8 levels, or f32 on [0, 255])."""
    pad = torch.zeros(len(hws), p, p, c)
    for i, (h, w) in enumerate(hws):
        pad[i, :h, :w] = (torch.rand(h, w, c, generator=g) * 255).round()
    return pad.to(dtype)


# odd canvas and page widths (the scalar tail), a canvas whose pixel count
# is a multiple of 4 (whole-word stores), one and four channels
@pytest.mark.parametrize("p,hws,c", [(97, [(97, 61), (40, 97)], 3),
                                     (128, [(100, 128), (128, 77)], 3),
                                     (45, [(45, 45), (31, 17)], 1),
                                     (64, [(64, 50), (33, 64)], 4)])
@pytest.mark.parametrize("src_dtype", [torch.uint8, torch.float32])
def test_unwarp_native_kernel(dev, p, hws, c, src_dtype):
    """The fused unwarp against its plain version: f32 out within 0.5 on
    [0, 255], uint8 out within 1 level (a sum that lands on .5 may round
    the other way)."""
    g = _gen()
    pad = _pages(hws, p, c, src_dtype, g)
    hw = torch.tensor(hws, dtype=torch.int32)
    flow = (torch.rand(2, 16, 16, 2, generator=g) - 0.5) * 0.1
    before = unwarp.launches
    got = unwarp(pad.to(dev), flow.to(dev), hw.to(dev)).cpu()
    got_u8 = unwarp(pad.to(dev), flow.to(dev), hw.to(dev), out_u8=True).cpu()
    assert unwarp.launches == before + 2 and got_u8.dtype == torch.uint8
    want = unwarp_ref(pad, flow, hw)
    want_u8 = unwarp_ref(pad, flow, hw, out_u8=True)
    for i, (h, w) in enumerate(hws):
        torch.testing.assert_close(got[i, :h, :w], want[i, :h, :w], rtol=0,
                                   atol=0.5)
        d = (got_u8[i, :h, :w].int() - want_u8[i, :h, :w].int()).abs()
        assert d.max().item() <= 1


@pytest.mark.parametrize("hw", [(45, 60), (512, 512), (33, 130)])
def test_unwarp_fixed_kernel(dev, hw):
    """``unwarp_fixed`` through the fused kernel: the page at its own
    size, H != W and odd sizes, against the plain composition.  There the
    flow is resized by a matmul and the base grid comes from a vectorised
    linspace, either of which may put a coordinate one f32 ulp away (about
    3e-5 px at 512), which a unit-gradient random page turns into as much
    of value: 1e-4 on [0, 1]."""
    g = _gen()
    src = torch.rand(2, *hw, 3, generator=g)
    flow = (torch.rand(2, 64, 64, 2, generator=g) - 0.5) * 0.1
    before = unwarp.launches
    got = unwarp_fixed(src.to(dev), flow.to(dev)).cpu()
    assert unwarp.launches == before + 1
    torch.testing.assert_close(got, unwarp_fixed(src, flow), rtol=0, atol=1e-4)


@pytest.mark.parametrize("p,hws", [(97, [(97, 61), (40, 97)]),
                                   (256, [(255, 200), (256, 256)])])
def test_unwarp_coordinates_through_a_ramp(dev, p, hws):
    """The kernel's coordinates: a source whose channels are its own column
    and row index returns, wherever all four corners are valid, the pixel
    coordinate it sampled; in [-1, 1] canvas units it meets the plain
    ``native_grid`` within 1e-5 with no extra output."""
    g = _gen()
    idx = torch.arange(p, dtype=torch.float32)
    ramp = torch.stack([idx[None, :].expand(p, p), idx[:, None].expand(p, p),
                        torch.zeros(p, p)], -1)[None].repeat(2, 1, 1, 1)
    hw = torch.tensor(hws, dtype=torch.int32)
    flow = (torch.rand(2, 16, 16, 2, generator=g) - 0.5) * 0.1
    got = unwarp_native(ramp.to(dev), hw.to(dev), flow.to(dev)).cpu()
    px, py = native_grid(hw, flow, p)
    gx, gy = unnormalize(px, p), unnormalize(py, p)
    inside = (gx >= 0) & (gx < p - 1) & (gy >= 0) & (gy < p - 1)
    for i, (h, w) in enumerate(hws):
        keep = inside[i, :h, :w]
        assert keep.float().mean() > 0.5
        for e, want in ((0, px), (1, py)):
            coord = got[i, :h, :w, e] / (0.5 * (p - 1)) - 1.0
            torch.testing.assert_close(coord[keep], want[i, :h, :w][keep],
                                       rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype,bar", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_attention_head_dim_72(dev, dtype, bar):
    """DiT-XL's head dim, 72, zero-padded to the 128 instance of the route
    its dtype takes; scale 1/sqrt(72)."""
    g = _gen()
    q, k, v = (torch.randn(2, 16, t_, 72, generator=g).to(dev, dtype)
               for t_ in (100, 130, 130))
    before, (wgmma, f32) = attention.launches, _routes()
    got = attention(q, k, v)
    assert attention.launches == before + 1 and got.shape == q.shape
    assert _routes() == ((wgmma + 1, f32) if dtype == torch.bfloat16
                         else (wgmma, f32 + 1))
    want = attention_ref(q, k, v, 72 ** -0.5)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=bar * max(1.0, want.float().abs().max().item()))


@pytest.mark.parametrize("dtype,bar", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,h,t_,dh", [(8, 4, 4096, 32), (8, 4, 256, 96),
                                       (8, 4, 64, 128), (8, 8, 1024, 32)])
def test_attention_alt_denoiser_shapes(dev, dtype, bar, b, h, t_, dh):
    """K1 at the alternative denoisers' shapes: the transformer denoiser's
    4096 tokens and GeoTr2's 1024 at Dh 32, the UNet's AttentionBlock at
    Dh 96 (zero-padded to the 128 instance, scale 1/sqrt(96)) and Dh 128,
    q/k/v the split_heads views of one fused qkv projection."""
    g = _gen()
    qkv = torch.randn(b, t_, 3 * h * dh, generator=g).to(dev, dtype)
    q, k, v = (z.view(b, t_, h, dh).transpose(1, 2)
               for z in qkv.chunk(3, dim=-1))
    padded = attention.launches_padded[dh]
    before, (wgmma, f32) = attention.launches, _routes()
    got = attention(q, k, v, dh ** -0.5)
    assert attention.launches == before + 1 and got.shape == q.shape
    assert _routes() == ((wgmma + 1, f32) if dtype == torch.bfloat16
                         else (wgmma, f32 + 1))
    assert attention.launches_padded[dh] == padded + (dh == 96)
    want = attention_ref(q, k, v, dh ** -0.5)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=bar * max(1.0, want.float().abs().max().item()))


def test_conv1x1_f32_ignores_tf32(dev):
    """``conv1x1_f32`` (U2NetP's ``outconv``, the line UNet's ``outc``) is
    an f32 matmul: the same bits with cuDNN's TF32 switch on and off, and
    within f32 rounding of a float64 reference (a TF32 convolution keeps
    about three decimal digits)."""
    g = _gen()
    conv = torch.nn.Conv2d(64, 1, 1).to(dev)
    x = torch.randn(2, 64, 31, 47, generator=g).to(dev)
    outs = []
    for tf32 in (False, True):
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            outs.append(conv1x1_f32(conv, x))
        finally:
            torch.backends.cudnn.allow_tf32 = False
    assert torch.equal(outs[0], outs[1])
    want = torch.nn.functional.conv2d(x.double(), conv.weight.double(),
                                      conv.bias.double())
    torch.testing.assert_close(outs[1].double(), want, rtol=0,
                               atol=1e-5 * want.abs().max().item())


@pytest.mark.parametrize("dtype,bar", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("kind,dim,heads,tokens",
                         [("dit", 384, 6, 1024), ("satrn", 1536, 6, 1024)])
def test_attention_on_tp_local_heads(dev, monkeypatch, dtype, bar, kind, dim,
                                     heads, tokens):
    """Under tensor parallelism (model=2) rank 0's attention runs K1 on its
    local heads as ``split_heads`` makes them: strided views into the
    column-parallel fused qkv (DiT-S/2's 3 local heads of Dh 64, the
    row stride 3 x 192) or into separate projections (the SATRN decoder's
    3 of Dh 256).  The module's output against the same module with its
    attention bound to the twin."""
    from dvd_tpu_torch.models import layers, satrn
    from dvd_tpu_torch.parallel.mesh import Mesh, shard_params

    g = _gen()
    with torch.no_grad():
        mod = layers.SelfAttention(dim, heads) if kind == "dit" else \
            satrn.SATRNAttention(heads, dim, 256, 256, dropout=0.0)
        layers.seeded_init_(mod, g)
    # under the parameter names the rules match (blocks_*.attn.qkv,
    # decoder.*.attn.linear_q): rank 0 of model=2, with no group
    root = torch.nn.Module()
    if kind == "dit":
        root.attn = mod
    else:
        root.decoder = torch.nn.Module()
        root.decoder.layer_stack_0 = torch.nn.Module()
        root.decoder.layer_stack_0.attn = mod
    shard_params(root, Mesh(data=1, model=2))
    mod = mod.to(dev, dtype)
    assert getattr(mod, "num_heads", getattr(mod, "n_head", None)) == 3
    x = torch.randn(2, tokens, dim, generator=g).to(dev, dtype)
    with torch.no_grad():
        before = attention.launches
        got = mod(x)
        assert attention.launches == before + 1
        monkeypatch.setattr(layers, "attention", lambda q, k, v, scale: (
            attention_ref(q, k, v, q.shape[-1] ** -0.5 if scale is None
                          else scale)))
        want = mod(x)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=bar * max(1.0, want.float().abs().max()
                                              .item()))


def test_one_rank_nccl_step_equals_plain_step(dev, monkeypatch):
    """A 1-rank NCCL world's train step (the data-parallel path: the
    global batch's draws sliced, the loss over the all-reduced mask sum,
    BN moments and gradients all-reduced over one rank) against the plain
    step, from the same weights, batch and generator: bit for bit, with
    cuDNN's deterministic algorithms (the trainable conv's weight
    gradient takes cuDNN's)."""
    import torch.distributed as dist

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)

    from dvd_tpu_torch.config import default_config
    from dvd_tpu_torch.diffusion.schedule import make_schedule
    from dvd_tpu_torch.models.dit import make_dit
    from dvd_tpu_torch.models.layers import seeded_init_
    from dvd_tpu_torch.parallel.mesh import init_distributed, make_mesh
    from dvd_tpu_torch.training.train_state import (create_train_state,
                                                    make_train_step,
                                                    shard_train_state)

    cfg = default_config().replace(model={
        "image_size": 16, "source_size": 128, "perception_size": 64,
        "compute_dtype": "float32", "dit_variant": "DiT-mini"})
    g = _gen()
    b = 2
    batch = {"y512": torch.rand(b, 3, 128, 128, generator=g),
             "mask_cat": torch.ones(b, 1, 128, 128),
             "mask_y512": 0.1 * torch.randn(b, 384, 16, 16, generator=g),
             "line_msk": 0.1 * torch.randn(b, 64, 16, 16, generator=g),
             "flow64": 0.05 * torch.randn(b, 16, 16, 2, generator=g),
             "flow_inter": torch.zeros(b, 128, 128, 2),
             "mask": torch.ones(b, 128, 128, 1)}
    batch = {k: v.to(dev) for k, v in batch.items()}
    sd = seeded_init_(make_dit("DiT-mini", input_size=16),
                      _gen()).state_dict()
    sched = make_schedule(steps=3, device=dev)
    init_distributed("nccl", dev, rank=0, world_size=1,
                     init_method="tcp://127.0.0.1:29531")
    try:
        runs = []
        for sharded in (False, True):
            net = make_dit("DiT-mini", input_size=16)
            net.load_state_dict(sd)
            state = create_train_state(cfg, net.to(dev))
            mesh = make_mesh() if sharded else None
            if sharded:
                state = shard_train_state(cfg, state, mesh)
            step = make_train_step(cfg, sched, mesh=mesh)
            gen = torch.Generator(device=dev).manual_seed(5)
            state, m = step(state, batch, gen)
            runs.append((m, state.model.state_dict()))
        (m0, s0), (m1, s1) = runs
        for k in ("loss", "grad_norm", "mse_per_sample", "t"):
            assert torch.equal(m0[k], m1[k]), k
        for k in s0:
            assert torch.equal(s0[k], s1[k]), k
    finally:
        dist.destroy_process_group()
