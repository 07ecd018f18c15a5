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

from dvd_tpu_torch.evaluation.pipeline import native_grid, unwarp_native
from dvd_tpu_torch.ops.grid_sample import unnormalize, warp_const_src
from dvd_tpu_torch.ops.kernels.attention import HEAD_DIMS, attention, attention_ref
from dvd_tpu_torch.ops.kernels.conv3x3 import (conv3x3, conv3x3_ref,
                                               conv3x3_trainable)
from dvd_tpu_torch.ops.kernels.gather2d import gather2d, gather2d_ref
from dvd_tpu_torch.ops.kernels.grid_sample import (gather_bilinear,
                                                   gather_bilinear_grad,
                                                   gather_bilinear_grad_ref,
                                                   gather_bilinear_ref)

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


@pytest.mark.parametrize("dh", HEAD_DIMS)
@pytest.mark.parametrize("tq,tk", [(64, 64), (37, 100), (130, 7)])
def test_attention_kernel(dev, dh, tq, tk):
    g = _gen()
    q = torch.randn(2, 3, tq, dh, generator=g).to(dev)
    k = torch.randn(2, 3, tk, dh, generator=g).to(dev)
    v = torch.randn(2, 3, tk, dh, generator=g).to(dev)
    before = attention.launches
    got = attention(q, k, v, 0.3)
    assert attention.launches == before + 1
    torch.testing.assert_close(got, attention_ref(q, k, v, 0.3),
                               rtol=1e-4, atol=1e-4)


def test_attention_strided_bf16(dev):
    """split_heads views (strided) in bf16; output in q's dtype."""
    g = _gen()
    x = torch.randn(2, 50, 3, 4, 64, generator=g).to(dev, torch.bfloat16)
    q, k, v = (x[:, :, i].transpose(1, 2) for i in range(3))
    got = attention(q, k, v, 1 / 8)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    torch.testing.assert_close(got.float(), attention_ref(q, k, v, 1 / 8).float(),
                               rtol=0, atol=2e-2)


@pytest.mark.parametrize("cin,cout,hw,dil", [
    (3, 16, (17, 23), 1), (4, 64, (8, 40), 1), (16, 16, (9, 9), 2),
    (16, 16, (9, 9), 4), (64, 16, (9, 9), 8), (40, 1, (11, 5), 1),
    (130, 33, (6, 70), 1), (9, 40, (9, 9), 32)])   # largest halo that fits
@pytest.mark.parametrize("relu", [True, False])
def test_conv3x3_kernel(dev, cin, cout, hw, dil, relu):
    g = _gen()
    x = torch.randn(2, cin, *hw, generator=g).to(dev)
    w = (torch.randn(cout, cin, 3, 3, generator=g) / (3 * cin ** 0.5)).to(dev)
    s = (1 + 0.1 * torch.randn(cout, generator=g)).to(dev)
    b = (0.1 * torch.randn(cout, generator=g)).to(dev)
    before = conv3x3.launches
    got = conv3x3(x, w, s, b, dil, relu)
    assert conv3x3.launches == before + 1
    torch.testing.assert_close(got, conv3x3_ref(x, w, s, b, dil, relu),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
@pytest.mark.parametrize("shape", [(2, 3, 13, 17, 9, 11), (1, 5, 7, 129, 3, 200)])
def test_gather_kernel(dev, padding_mode, shape):
    n, c, h, w, p, q = shape
    g = _gen()
    img = torch.rand(n, c, h, w, generator=g).to(dev)
    gx = (torch.rand(n, p, q, generator=g) * (w + 6) - 3).to(dev)
    gy = (torch.rand(n, p, q, generator=g) * (h + 6) - 3).to(dev)
    before = gather_bilinear.launches
    got = gather_bilinear(img, gx, gy, padding_mode)
    assert gather_bilinear.launches == before + 1
    torch.testing.assert_close(got, gather_bilinear_ref(img, gx, gy, padding_mode),
                               rtol=0, atol=1e-5)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    g = _gen()
    q = torch.randn(1, 2, 8, 24, generator=g).to(dev)      # Dh 24: no kernel
    with pytest.raises(ValueError):
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
    img = torch.rand(1, 2, 4, 4, generator=g).to(dev)
    with pytest.raises(TypeError):
        gather_bilinear(img.half(), img[:, 0], img[:, 1])
    gx = img[:, 0].contiguous()
    with pytest.raises(TypeError):                          # K4: f64 ct
        gather_bilinear_grad(img, gx, gx, img.double())
    with pytest.raises(ValueError):                         # K4: ct shape
        gather_bilinear_grad(img, gx, gx, img[:, :1].contiguous())
    with pytest.raises(ValueError):                         # K4: strided
        gather_bilinear_grad(img, gx.transpose(1, 2), gx, img)
    with pytest.raises(ValueError):                         # K4: mixed devices
        gather_bilinear_grad(img, gx, gx, img.cpu())


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
@pytest.mark.parametrize("shape", [(2, 3, 13, 17, 9, 11), (1, 2, 7, 129, 3, 200),
                                   (3, 1, 64, 64, 31, 33)])
def test_gather_grad_kernel(dev, padding_mode, shape):
    n, c, h, w, p, q = shape
    g = _gen()
    img = torch.rand(n, c, h, w, generator=g).to(dev)
    gx = (torch.rand(n, p, q, generator=g) * (w + 6) - 3).to(dev)
    gy = (torch.rand(n, p, q, generator=g) * (h + 6) - 3).to(dev)
    ct = torch.randn(n, c, p, q, generator=g).to(dev)
    before = gather_bilinear_grad.launches
    got = gather_bilinear_grad(img, gx, gy, ct, padding_mode)
    assert gather_bilinear_grad.launches == before + 1
    for a, b in zip(got, gather_bilinear_grad_ref(img, gx, gy, ct, padding_mode)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


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
    before = attention.launches
    got = _grads(lambda *a: attention(*a, 0.1), [q, k, v], ct)
    assert attention.launches == before + 1
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
