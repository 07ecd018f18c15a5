"""adaLN-Zero's elementwise passes in the DiT block (``csrc/adaln.cu``),
beside their plain twins.

Two entries, the two halves of one pattern around each sublayer of
``models/dit.py``'s blocks (and its final layer):

- :func:`ln_modulate`: ``modulate(layer_norm(x), shift, scale)``, or with
  no conditioners ``layer_norm(x)``: statistics in f32, eps 1e-6, no
  affine;
- :func:`gate_residual`: ``x + gate[:, None] * y``.

x is (N, T, D), the conditioners (N, D), and they may be strided views
(the column slices of the block's adaLN output): the kernel reads them in
place.  The kernel computes in f32 and rounds to x's dtype once, where the
plain twins (today's eager expressions, exactly) round after each
operation in a bf16 pipeline: fewer roundings, never fewer bits.

CPU tensors take the plain twin; CUDA tensors launch the kernel or raise
(:func:`ln_modulate_kernel`, :func:`gate_residual_kernel`): every operand
on x's device and of its shape, D a multiple of 4 and at most
``MAX_WIDTH``, and the operands' dtypes promoting, as in the twin, to bf16
or f32 (under autocast in training an f32 x meets bf16 conditioners: they
are cast up, exactly).  An x or y that is not contiguous or not aligned to
4 elements, and a conditioner whose rows are not, is copied first; ``out``
is written in place or the call raises.  When a gradient is needed the
call goes through an autograd Function whose backward differentiates the
plain twin, recomputed.

Counters: ``ln_modulate.launches`` and ``gate_residual.launches``.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from dvd_tpu_torch.ops.kernels import build
from dvd_tpu_torch.utils.dtypes import at_least_f32

EPS = 1e-6
# csrc/adaln.cu: 4 values a unit x kMaxUnits (11) units a lane x 256
# threads a row at most
MAX_WIDTH = 11264


def modulate(x: torch.Tensor, shift: torch.Tensor,
             scale: torch.Tensor) -> torch.Tensor:
    """adaLN modulation ``x * (1 + scale) + shift`` with (N, D) conditioners."""
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


def layer_norm(x: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """LayerNorm without affine, statistics in f32, result in x's dtype."""
    return F.layer_norm(at_least_f32(x), (x.shape[-1],), eps=eps).to(x.dtype)


def ln_modulate_ref(x: torch.Tensor, shift: Optional[torch.Tensor] = None,
                    scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain twin of :func:`ln_modulate`."""
    h = layer_norm(x)
    return h if shift is None else modulate(h, shift, scale)


def gate_residual_ref(x: torch.Tensor, gate: torch.Tensor,
                      y: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`gate_residual`."""
    return x + gate[:, None] * y


def ln_modulate(x: torch.Tensor, shift: Optional[torch.Tensor] = None,
                scale: Optional[torch.Tensor] = None,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``modulate(layer_norm(x), shift, scale)``, or ``layer_norm(x)``
    without ``shift`` and ``scale``, in the operands' promoted dtype (x's
    where they share it), into ``out`` (a tensor of x's shape, a slice of
    a larger buffer, say) where given."""
    if x.device.type == "cpu":
        return _written(ln_modulate_ref(x, shift, scale), out)
    return ln_modulate_kernel(x, shift, scale, out)


def gate_residual(x: torch.Tensor, gate: torch.Tensor,
                  y: torch.Tensor) -> torch.Tensor:
    """``x + gate[:, None] * y``, a new tensor in the operands' promoted
    dtype."""
    if x.device.type == "cpu":
        return gate_residual_ref(x, gate, y)
    return gate_residual_kernel(x, gate, y)


def ln_modulate_kernel(x, shift=None, scale=None, out=None) -> torch.Tensor:
    """:func:`ln_modulate` through ``dvd_ln_modulate``, or raise."""
    if (shift is None) != (scale is None):
        raise ValueError("ln_modulate: shift and scale go together")
    conds = () if shift is None else (shift, scale)
    dtype = _check("ln_modulate", x, (), conds, out)
    if shift is not None:
        shift, scale = (_row_aligned(t.to(dtype)) for t in conds)
    return _run(_launch_ln, ln_modulate_ref, out, _aligned(x.to(dtype)),
                shift, scale)


def gate_residual_kernel(x, gate, y) -> torch.Tensor:
    """:func:`gate_residual` through ``dvd_gate_residual``, or raise."""
    dtype = _check("gate_residual", x, (y,), (gate,))
    return _run(_launch_gr, gate_residual_ref, None, _aligned(x.to(dtype)),
                _row_aligned(gate.to(dtype)), _aligned(y.to(dtype)))


def _check(name: str, x: torch.Tensor, rows, conds,
           out: Optional[torch.Tensor] = None) -> torch.dtype:
    """The dtype of the twin's result (the operands' promoted), after
    raising unless the kernel takes x (N, T, D) with ``rows`` (y: x's
    shape), ``conds`` ((N, D) conditioners) and ``out``."""
    dtype = functools.reduce(torch.promote_types,
                             (t.dtype for t in (*rows, *conds)), x.dtype)
    if dtype not in build.DTYPE_CODES:
        raise TypeError(f"{name}: bf16 or f32 only, not {dtype}")
    if x.dim() != 3 or x.shape[2] % 4 or not 0 < x.shape[2] <= MAX_WIDTH:
        raise ValueError(f"{name}: x must be (N, T, D) with D a multiple of "
                         f"4 up to {MAX_WIDTH}, not {tuple(x.shape)}")
    n, d = x.shape[0], x.shape[2]
    for t in (*rows, *conds, *(() if out is None else (out,))):
        if t.device != x.device:
            raise ValueError(f"{name}: an operand on {t.device}, x on "
                             f"{x.device}")
    for t in (*rows, *(() if out is None else (out,))):
        if t.shape != x.shape:
            raise ValueError(f"{name}: {tuple(t.shape)} against x's "
                             f"{tuple(x.shape)}")
    for t in conds:
        if t.shape != (n, d):
            raise ValueError(f"{name}: a conditioner {tuple(t.shape)}, not "
                             f"({n}, {d})")
    if out is not None and out.dtype != dtype:
        raise ValueError(f"{name}: out in {out.dtype}, the result in {dtype}")
    return dtype


def _base_aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % (4 * t.element_size()) == 0


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t where the kernel reads it in place (contiguous, 4-value aligned),
    else a contiguous copy."""
    if t.is_contiguous() and _base_aligned(t):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _row_aligned(t: torch.Tensor) -> torch.Tensor:
    """An (N, D) conditioner where the kernel reads it in place (unit
    columns, rows at a stride of 4-value units, aligned), else a copy."""
    if t.stride(1) == 1 and t.stride(0) % 4 == 0 and _base_aligned(t):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _written(result: torch.Tensor,
             out: Optional[torch.Tensor]) -> torch.Tensor:
    return result if out is None else out.copy_(result)


class _Fused(torch.autograd.Function):
    """A kernel's result; the gradients are the plain twin's, recomputed."""

    @staticmethod
    def forward(ctx, launch, twin, x, a, b):
        ctx.twin = twin
        ctx.save_for_backward(x, a, b)
        out = torch.empty_like(x)
        launch(x, a, b, out)
        return out

    @staticmethod
    def backward(ctx, g):
        ops = [None if t is None else t.detach().requires_grad_(need)
               for t, need in zip(ctx.saved_tensors,
                                  ctx.needs_input_grad[2:])]
        wanted = [t for t in ops if t is not None and t.requires_grad]
        with torch.enable_grad():
            grads = iter(torch.autograd.grad(ctx.twin(*ops), wanted, g))
        return (None, None, *(next(grads) if t is not None and
                              t.requires_grad else None for t in ops))


def _run(launch, twin, out, x, a, b) -> torch.Tensor:
    """``launch(x, a, b, out)``, into a new tensor or ``out``; through
    :class:`_Fused` where an operand needs a gradient."""
    if out is not None and not (out.is_contiguous() and _base_aligned(out)):
        raise ValueError("adaLN kernels write only a contiguous, 4-value "
                         "aligned out")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, a, b)):
        return _written(_Fused.apply(launch, twin, x, a, b), out)
    if out is None:
        out = torch.empty_like(x)
    launch(x, a, b, out)
    return out


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    """A C entry, fetched from the library once."""
    return getattr(build.load_library().lib, name)


def _launched(fn, name: str, err: int) -> None:
    if err:
        build.check_launch(build.load_library(), err, name)
    fn.launches += 1


def _launch_ln(x, shift, scale, out) -> None:
    d = x.shape[-1]
    n_rows = x.numel() // d
    err = _entry("dvd_ln_modulate")(
        x.data_ptr(), None if shift is None else shift.data_ptr(),
        None if scale is None else scale.data_ptr(), out.data_ptr(), n_rows,
        n_rows // x.shape[0], d, 0 if shift is None else shift.stride(0),
        0 if scale is None else scale.stride(0), EPS,
        build.DTYPE_CODES[x.dtype], build.stream_ptr(x))
    _launched(ln_modulate, "dvd_ln_modulate", err)


def _launch_gr(x, gate, y, out) -> None:
    n, d = x.shape[0], x.shape[-1]
    err = _entry("dvd_gate_residual")(
        x.data_ptr(), gate.data_ptr(), y.data_ptr(), out.data_ptr(), n,
        x.numel() // (n * d), d, gate.stride(0), build.DTYPE_CODES[x.dtype],
        build.stream_ptr(x))
    _launched(gate_residual, "dvd_gate_residual", err)


ln_modulate.launches = 0
gate_residual.launches = 0
