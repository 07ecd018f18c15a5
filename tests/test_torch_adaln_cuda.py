"""adaLN-Zero's fused passes on the card (``csrc/adaln.cu`` through
``ops/kernels/adaln.py``): each entry at the DiT cells' shapes, (8, 1024,
1152), (32, 1024, 384) and (8, 1024, 384), at the 'para' final layer's
4608 (four warps a row) and at widths that leave lanes, warps and rows of
a block idle, in bf16 and f32, against float32 math of the same formula
(bf16 within one bf16 unit in the last place of it, give or take f32
rounding of the terms it adds; f32 within 1e-5 of max|ref|) and against
today's eager chain (the plain twin on the card); ``out=`` into a slice;
the 8-byte units where a wide width's operands do not allow 16-byte ones;
strided operands copied, and the calls the kernel cannot take raising;
gradients under autograd equal to the twin's; an f32 x beside bf16
conditioners (autocast in training); one DiT-XL/2 'para' block
against the eager block and a float32 one.
Each launch is followed by ``torch.cuda.synchronize()`` and a zero
``cudaGetLastError()``, and moves its launch counter by one.
Every test is marked ``cuda`` and skips without a card; the file imports
neither JAX nor ``dvd_tpu``:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_adaln_cuda.py
"""

import pytest
import torch
import torch.nn.functional as F

from dvd_tpu_torch.models import dit
from dvd_tpu_torch.models.dit import DiTBlock
from dvd_tpu_torch.ops.kernels import adaln, build

pytestmark = pytest.mark.cuda
SHAPES = [(8, 1024, 1152), (32, 1024, 384), (8, 1024, 384), (8, 1024, 4608),
          (3, 7, 40), (2, 33, 2056), (1, 9, 11264)]
DTYPES = [torch.bfloat16, torch.float32]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the adaLN kernels have no CPU "
                    "mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(shape, dtype, dev, seed=0):
    """x, y (N, T, D) with a mean off zero, and the six (N, D) column
    slices of an adaLN output (N, 6D)."""
    n, _, d = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(shape, generator=g, device=dev) * 2 + 0.5).to(dtype)
    y = torch.randn(shape, generator=g, device=dev).to(dtype)
    ada = (torch.randn(n, 6 * d, generator=g, device=dev) * 0.5).to(dtype)
    return x, y, ada.chunk(6, dim=-1)


def _checked(fn, *args, **kw):
    """One call of an entry that must launch its kernel once."""
    before = fn.launches
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    assert build.load_library().lib.dvd_last_error() == 0
    assert fn.launches == before + 1
    return out


def _within_ulp(got, ref, terms):
    """Whether bf16 ``got`` lies within one bf16 unit in the last place of
    the float32 ``ref``, everywhere, give or take 2^-18 of ``terms``, the
    magnitudes that the formula adds and subtracts (where they cancel, f32
    rounding of the kernel and of the reference alone exceeds a bf16 unit
    of the small result)."""
    _, e = torch.frexp(ref)
    ulp = torch.ldexp(torch.ones_like(ref), e - 8)
    return bool(((got.float() - ref).abs() <= ulp + 2.0 ** -18 * terms).all())


def _err(a, b):
    return (a.float() - b.float()).abs().max().item()


def _against(got, ref, terms, eager, dtype):
    """``got`` against the float32 ``ref`` (the bar of its dtype;
    ``terms``: see ``_within_ulp``) and against the eager chain's result
    ``eager``: no farther from it than the eager chain's own rounding,
    twice."""
    if dtype == torch.bfloat16:
        assert _within_ulp(got, ref, terms), _err(got, ref)
        assert _err(got, eager) <= 2 * _err(eager, ref)
    else:
        assert _err(got, ref) <= 1e-5 * ref.abs().max().item()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_ln_modulate(card, shape, dtype):
    x, _, (shift, scale, *_) = _inputs(shape, dtype, card)
    xf = x.float()
    norm = F.layer_norm(xf, (shape[-1],), eps=adaln.EPS)
    gain = 1 + scale.float()[:, None]
    ref = norm * gain + shift.float()[:, None]
    mean = xf.mean(-1, keepdim=True)
    # x - mean cancels too: its terms, as far as the norm carries them
    centred = (xf.abs() + mean.abs()) / (xf - mean).square().mean(
        -1, keepdim=True).add(adaln.EPS).sqrt()
    got = _checked(adaln.ln_modulate, x, shift, scale)
    assert got.dtype == dtype and got.shape == x.shape
    _against(got, ref, centred * gain.abs() + shift.float().abs()[:, None],
             adaln.ln_modulate_ref(x, shift, scale), dtype)
    plain = _checked(adaln.ln_modulate, x)
    _against(plain, norm, centred, adaln.ln_modulate_ref(x), dtype)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_gate_residual(card, shape, dtype):
    x, y, (_, _, gate, *_) = _inputs(shape, dtype, card)
    gated = gate.float()[:, None] * y.float()
    ref = x.float() + gated
    got = _checked(adaln.gate_residual, x, gate, y)
    assert got.dtype == dtype and got.shape == x.shape
    _against(got, ref, x.float().abs() + gated.abs(),
             adaln.gate_residual_ref(x, gate, y), dtype)


def test_out_into_a_slice(card):
    shape = (8, 1024, 1152)
    x, _, (shift, scale, *_) = _inputs(shape, torch.bfloat16, card)
    buf = torch.full((32,) + shape[1:], 3.0, dtype=torch.bfloat16,
                     device=card)
    got = _checked(adaln.ln_modulate, x, shift, scale, out=buf[16:24])
    assert got.data_ptr() == buf[16:24].data_ptr()
    assert torch.equal(buf[16:24], adaln.ln_modulate(x, shift, scale))
    assert (buf[:16] == 3).all() and (buf[24:] == 3).all()


def test_strided_operands_and_refusals(card):
    """A transposed x and y and conditioner rows at an odd stride are
    copied and launched; D not a multiple of 4, f64 and a strided
    ``out`` raise, with nothing launched."""
    shape = (8, 64, 384)
    x, y, (shift, scale, gate, *_) = _inputs(shape, torch.bfloat16, card)
    xt, yt = (t.transpose(0, 1).contiguous().transpose(0, 1) for t in (x, y))
    gate_odd = torch.cat([gate, gate[:, :1]], dim=1)[:, :-1]
    assert not xt.is_contiguous() and gate_odd.stride(0) % 4
    assert torch.equal(_checked(adaln.ln_modulate, xt, shift, scale),
                       _checked(adaln.ln_modulate, x, shift, scale))
    assert torch.equal(_checked(adaln.gate_residual, xt, gate_odd, yt),
                       _checked(adaln.gate_residual, x, gate, y))
    before = (adaln.ln_modulate.launches, adaln.gate_residual.launches)
    with pytest.raises(ValueError):
        adaln.ln_modulate(x[..., :382])
    with pytest.raises(TypeError):
        adaln.gate_residual(*(t.double() for t in (x, gate, y)))
    with pytest.raises(ValueError):
        adaln.ln_modulate(x, shift, scale, out=torch.empty_like(xt))
    assert (adaln.ln_modulate.launches,
            adaln.gate_residual.launches) == before


def test_narrow_units_at_a_wide_width(card):
    """At 1152 bf16 the norm reads 16-byte units; an x 8 bytes off a
    16-byte boundary, or conditioner rows at a stride of 4 values, take
    the 8-byte units instead: each result within one bf16 unit of float32
    math, and within one of the other."""
    shape = (4, 64, 1152)
    x, _, (shift, scale, *_) = _inputs(shape, torch.bfloat16, card)
    ref = (F.layer_norm(x.float(), (shape[-1],), eps=adaln.EPS)
           * (1 + scale.float()[:, None]) + shift.float()[:, None])
    wide = _checked(adaln.ln_modulate, x, shift, scale)
    buf = torch.empty(x.numel() + 4, dtype=x.dtype, device=card)
    x_off = buf[4:].view(shape)
    x_off.copy_(x)
    assert x_off.data_ptr() % 16 == 8
    conds = torch.empty(shape[0], 2 * 1156, dtype=x.dtype, device=card)
    shift4, scale4 = conds[:, :1152], conds[:, 1156:1156 + 1152]
    shift4.copy_(shift)
    scale4.copy_(scale)
    for got in (_checked(adaln.ln_modulate, x_off, shift, scale),
                _checked(adaln.ln_modulate, x, shift4, scale4)):
        for a, b in ((got, ref), (got, wide.float())):
            _, e = torch.frexp(b.float())
            ulp = torch.ldexp(torch.ones_like(b.float()), e - 8)
            assert bool(((a.float() - b.float()).abs() <= ulp + 2.0 ** -18
                         * (x.float().abs().max() + ref.abs().max())).all())


@pytest.mark.parametrize("dtype", DTYPES)
def test_gradients_are_the_twins(card, dtype):
    """Training's route: under autograd each entry launches its kernel
    once and its gradients (x, y, the adaLN output the conditioners are
    sliced from) equal the twin's bit for bit.  The three calls take leaf
    operands and are summed, so no call's input is another's (the
    kernel's result is not the twin's, so a chain would part)."""
    shape = (4, 256, 1152)

    def grads(ln, gr, launched):
        x, y, _ = _inputs(shape, dtype, card)
        ada = (torch.randn(shape[0], 6 * shape[2], device=card,
                           generator=torch.Generator(device=card)
                           .manual_seed(3)) * 0.5).to(dtype)
        x, y, ada = (t.requires_grad_() for t in (x, y, ada))
        shift, scale, gate, *_ = ada.chunk(6, dim=-1)
        before = (adaln.ln_modulate.launches, adaln.gate_residual.launches)
        out = gr(x, gate, y) + ln(x, shift, scale) + ln(y)
        g = torch.randn(shape, device=card, generator=torch.Generator(
            device=card).manual_seed(4)).to(dtype)
        out.backward(g)
        torch.cuda.synchronize()
        assert (adaln.ln_modulate.launches - before[0],
                adaln.gate_residual.launches - before[1]) == launched
        return x.grad, y.grad, ada.grad

    got = grads(adaln.ln_modulate, adaln.gate_residual, (2, 1))
    want = grads(adaln.ln_modulate_ref, adaln.gate_residual_ref, (0, 0))
    assert build.load_library().lib.dvd_last_error() == 0
    for a, b in zip(got, want):
        assert a is not None and torch.equal(a, b)


def test_mixed_dtypes(card):
    """Training under autocast: an f32 x beside bf16 conditioners and y.
    The calls launch the f32 kernel on the operands cast up (exactly), so
    the results equal the all-f32 calls bit for bit and come back in f32
    as the twin's do; under autograd the bf16 leaves get bf16 gradients."""
    shape = (8, 64, 384)
    x, y, _ = _inputs(shape, torch.float32, card)
    ada = (torch.randn(shape[0], 6 * shape[2], device=card,
                       generator=torch.Generator(device=card).manual_seed(2))
           * 0.5).to(torch.bfloat16)
    y = y.to(torch.bfloat16)
    shift, scale, gate, *_ = ada.chunk(6, dim=-1)
    up = [t.float() for t in (shift, scale, gate, y)]
    h = _checked(adaln.ln_modulate, x, shift, scale)
    assert h.dtype == torch.float32
    assert adaln.ln_modulate_ref(x, shift, scale).dtype == torch.float32
    assert torch.equal(h, _checked(adaln.ln_modulate, x, up[0], up[1]))
    r = _checked(adaln.gate_residual, x, gate, y)
    assert r.dtype == adaln.gate_residual_ref(x, gate, y).dtype
    assert torch.equal(r, _checked(adaln.gate_residual, x, up[2], up[3]))
    x, ada = x.requires_grad_(), ada.requires_grad_()
    shift, scale, gate, *_ = ada.chunk(6, dim=-1)
    out = _checked(adaln.ln_modulate, x, shift, scale) + _checked(
        adaln.gate_residual, x, gate, y)
    out.sum().backward()
    assert x.grad.dtype == torch.float32 and ada.grad.dtype == torch.bfloat16
    assert torch.isfinite(ada.grad.float()).all()
    assert ada.grad[:, :3 * shape[2]].abs().sum() > 0


@torch.no_grad()
def test_ditxl_block_against_eager(card, monkeypatch):
    """One DiT-XL/2 'para' block over four streams: 9 norms (the shared
    cross-attention's and each stream's two) and 8 gated residuals
    launched; its outputs against the same block with the twins (today's
    eager block) and against the block in float32, within the bf16 bar."""
    torch.manual_seed(0)
    block = DiTBlock(1152, 16).to(card)
    n, t, d = 2, 1024, 1152
    g = torch.Generator(device=card).manual_seed(1)
    x, cond, msk6, line, r = (torch.randn(n, t, d, generator=g, device=card)
                              for _ in range(5))
    t_emb = torch.randn(n, d, generator=g, device=card)
    args = (x, t_emb, cond, msk6, line, r)

    def run(dtype, fused):
        with monkeypatch.context() as m:
            if not fused:
                m.setattr(dit, "ln_modulate", adaln.ln_modulate_ref)
                m.setattr(dit, "gate_residual", adaln.gate_residual_ref)
            return block.to(dtype)(*(a.to(dtype) for a in args))

    ref = run(torch.float32, False)
    eager = run(torch.bfloat16, False)
    before = (adaln.ln_modulate.launches, adaln.gate_residual.launches)
    got = run(torch.bfloat16, True)
    torch.cuda.synchronize()
    assert build.load_library().lib.dvd_last_error() == 0
    assert (adaln.ln_modulate.launches - before[0],
            adaln.gate_residual.launches - before[1]) == (9, 8)
    for o_got, o_eager, o_ref in zip(got, eager, ref):
        bar = 2e-2 * max(1.0, o_ref.abs().max().item())
        assert _err(o_got, o_ref) <= bar and _err(o_got, o_eager) <= bar
