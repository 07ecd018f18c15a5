"""adaLN-Zero's fused passes (``ops/kernels/adaln.py``) on the CPU: the
plain twins are today's expressions bit for bit (the conditioners strided
column slices of an adaLN output, ``out=`` a slice of a larger buffer);
the kernel route (what a CUDA tensor takes) with the kernel's C entry
replaced by a recorder: its arguments, its copies and casts and its
refusals, and the autograd Function's gradients against the twin's.  The kernels
themselves: ``tests/test_torch_adaln_cuda.py`` on a card."""

import pytest
import torch
import torch.nn.functional as F

from dvd_tpu_torch.ops.kernels import adaln, build


def _inputs(shape, dtype, seed=0):
    """x, y (N, T, D) and the six (N, D) column slices of an adaLN output
    (N, 6D), as ``DiTBlock.forward`` chunks it."""
    n, t, d = shape
    g = torch.Generator().manual_seed(seed)
    x, y = (torch.randn(shape, generator=g).to(dtype) for _ in range(2))
    ada = torch.randn(n, 6 * d, generator=g).to(dtype)
    return x, y, ada.chunk(6, dim=-1)


@pytest.mark.parametrize("shape", [(2, 16, 48), (3, 5, 20)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
def test_twin_route_is_todays_expressions(shape, dtype):
    x, y, (shift, scale, gate, *_) = _inputs(shape, dtype)
    assert shift.stride() == (6 * shape[2], 1)
    norm = F.layer_norm(x if dtype == torch.float64 else x.float(),
                        (shape[2],), eps=1e-6).to(dtype)
    want = norm * (1.0 + scale[:, None, :]) + shift[:, None, :]
    before = (adaln.ln_modulate.launches, adaln.gate_residual.launches)
    assert torch.equal(adaln.ln_modulate(x, shift, scale), want)
    assert torch.equal(adaln.ln_modulate(x), norm)
    assert torch.equal(adaln.gate_residual(x, gate, y),
                       x + gate[:, None] * y)
    buf = torch.full((2 * shape[0],) + shape[1:], 7.0, dtype=dtype)
    got = adaln.ln_modulate(x, shift, scale, out=buf[shape[0]:])
    assert got.data_ptr() == buf[shape[0]:].data_ptr()
    assert torch.equal(buf[shape[0]:], want) and (buf[:shape[0]] == 7).all()
    # the CPU takes the twin: nothing launched
    assert (adaln.ln_modulate.launches,
            adaln.gate_residual.launches) == before


@pytest.fixture
def recorder(monkeypatch):
    """The C entries replaced by a recorder of their arguments (their
    output left unwritten), on stream 0."""
    calls = []

    def entry(name):
        return lambda *args: calls.append((name, args)) or 0

    monkeypatch.setattr(adaln, "_entry", entry)
    monkeypatch.setattr(build, "stream_ptr", lambda t: 0)
    return calls


@pytest.mark.parametrize("case", ["fused", "no_grad", "grad", "copied",
                                  "mixed", "width", "dtype", "out"])
def test_routing_rule(case, recorder):
    """The kernel route launches the kernel or raises: an operand that
    needs a gradient goes through the autograd Function and still
    launches; a non-contiguous x or y, or conditioner rows at a stride
    that is not a multiple of 4, are copied first; bf16 conditioners and y
    beside an f32 x (autocast in training) are cast up and launch in f32,
    as the twin's result promotes; D not a multiple of 4, a dtype without
    an instance and a non-contiguous ``out`` raise."""
    shape = (2, 16, 10 if case == "width" else 48)
    x, y, (shift, scale, gate, *_) = _inputs(
        shape, torch.float64 if case == "dtype" else torch.float32)
    if case in ("grad", "no_grad"):
        x.requires_grad_()
    if case == "copied":
        x = torch.randn(shape[1], shape[0], shape[2]).transpose(0, 1)
        gate = torch.randn(shape[0], shape[2] + 1)[:, 1:]
    if case == "mixed":
        y, shift, scale, gate = (t.to(torch.bfloat16)
                                 for t in (y, shift, scale, gate))
    before = (adaln.ln_modulate.launches, adaln.gate_residual.launches)
    with torch.set_grad_enabled(case != "no_grad"):
        if case in ("width", "dtype"):
            with pytest.raises(TypeError if case == "dtype" else ValueError):
                adaln.ln_modulate_kernel(x, shift, scale)
            with pytest.raises(TypeError if case == "dtype" else ValueError):
                adaln.gate_residual_kernel(x, gate, y)
        elif case == "out":
            buf = torch.empty(shape[1], shape[0], shape[2]).transpose(0, 1)
            with pytest.raises(ValueError):
                adaln.ln_modulate_kernel(x, shift, scale, out=buf)
            with pytest.raises(ValueError):
                adaln.ln_modulate_kernel(x, shift, scale,
                                         out=torch.empty_like(x).double())
        else:
            h = adaln.ln_modulate_kernel(x, shift, scale)
            r = adaln.gate_residual_kernel(x, gate, y)
    after = (adaln.ln_modulate.launches, adaln.gate_residual.launches)
    if case in ("width", "dtype", "out"):
        assert recorder == [] and after == before
        return
    assert [name for name, _ in recorder] == ["dvd_ln_modulate",
                                              "dvd_gate_residual"]
    ln_args, gr_args = recorder[0][1], recorder[1][1]
    # rows, tokens, D, the conditioners' row strides (a cast conditioner
    # is a contiguous copy), the dtype code
    cond_stride = 48 if case == "mixed" else 288
    assert ln_args[4:9] == (32, 16, 48, cond_stride, cond_stride)
    assert gr_args[4:8] == (2, 16, 48, 48 if case in ("copied", "mixed")
                            else 288)
    assert ln_args[10] == gr_args[8] == build.DTYPE_CODES[torch.float32]
    assert after == (before[0] + 1, before[1] + 1)
    assert (h.dtype, r.dtype) == (torch.float32, torch.float32)
    assert (h.requires_grad, r.requires_grad) == ((case == "grad",) * 2)
    # x's pointer: x itself where the kernel reads it in place
    assert (ln_args[0] == x.data_ptr()) == (case != "copied")
    assert (ln_args[1:3] == (shift.data_ptr(), scale.data_ptr())) == (
        case != "mixed")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("entry", ["modulated", "norm", "residual"])
def test_backward_is_the_twins(entry, dtype, recorder):
    """Under autograd the kernel route's gradients (x, y and the adaLN
    output the conditioners are sliced from) are the plain twin's bit for
    bit: the Function's backward differentiates the twin, recomputed."""
    shape = (2, 16, 48)

    def grads(fn):
        x, y, _ = _inputs(shape, dtype)
        ada = torch.randn(shape[0], 6 * shape[2],
                          generator=torch.Generator().manual_seed(1)).to(dtype)
        x, y, ada = (t.requires_grad_() for t in (x, y, ada))
        shift, scale, gate, *_ = ada.chunk(6, dim=-1)
        if entry == "modulated":
            out = fn[0](x, shift, scale)
        elif entry == "norm":
            out = fn[0](x)
        else:
            out = fn[1](x, gate, y)
        g = torch.randn(shape, generator=torch.Generator().manual_seed(2))
        out.backward(g.to(dtype))
        return [t.grad for t in (x, y, ada)]

    kernel = grads((adaln.ln_modulate_kernel, adaln.gate_residual_kernel))
    twin = grads((adaln.ln_modulate_ref, adaln.gate_residual_ref))
    assert len(recorder) == 1
    for got, want in zip(kernel, twin):
        assert (got is None) == (want is None)
        assert got is None or torch.equal(got, want)
