"""The hand-written CUDA kernels against their plain twins on the card.

These kernels have no CPU mode, so every test here is marked ``cuda`` and
skips without a CUDA device.  The file imports neither JAX nor the
``dvd_tpu`` package, so it runs on a GPU machine without them:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Shapes are small edge cases (ragged lengths, odd planes, every head dim
and dilation the kernels take, out-of-range coordinates); the serving
path's full shapes are checked by ``chip_smoke.py``.
"""

import pytest
import torch

from dvd_tpu_torch.ops.kernels.attention import HEAD_DIMS, attention, attention_ref
from dvd_tpu_torch.ops.kernels.conv3x3 import conv3x3, conv3x3_ref
from dvd_tpu_torch.ops.kernels.grid_sample import (gather_bilinear,
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
