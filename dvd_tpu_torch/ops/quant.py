"""Dynamic W8A8 matmuls for int8 serving (``model.quantize="int8"``); port
of ``dvd_tpu/ops/quant.py``.

Per-row (token) activation scales, per-output-channel weight scales from
the f32 weights, an exact int32 product, an f32 rescale:

    y_ij = sum_k x_ik w_kj  ~=  xs_i * ws_j * sum_k q(x)_ik q(w)_kj

The arithmetic is ``dvd_tpu``'s step for step: the f32 row max of |x|,
``max(s, 1e-8) / 127``, round half to even, clip to +-127, int8; then
``(acc * xs) * ws``, ``+ bias`` in f32, the cast to the output dtype.
The product is ``torch._int_mm`` on both devices (the JAX package's is
``lax.dot_general``, outside any Pallas kernel): an exact int32 sum of at
most a few thousand products of at most 127^2.  On a card it is counted
in this module's ``launches``; a shape that ``_int_mm`` refuses there raises
``ValueError`` and nothing falls back to a float matmul.  The quantize
pass and the rescale are plain elementwise torch.

Weights are quantized once per weight set (:func:`int8_weight`, cached on
the layer and keyed by the storage and version counter of its weight, so
loading weights in place invalidates it).  Serving only: nothing here has
a gradient.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

_EPS = 1e-8

# _int_mm launches on a card (the CPU runs the same call, uncounted)
launches = 0


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize along the last axis: (int8 codes, per-row f32 scale with a
    trailing 1).  Shared by callers that project one tensor several times
    (q/k/v), so it is quantized once."""
    x32 = x.float()
    s = torch.clamp(x32.abs().amax(dim=-1, keepdim=True), min=_EPS)
    # divided by a tensor: CUDA divides by a Python scalar as a product
    # with its reciprocal, a different rounding from the CPU's quotient
    s = s / torch.full_like(s, 127.0)
    q = torch.clamp(torch.round(x32 / s), -127, 127).to(torch.int8)
    return q, s


def int8_weight(layer: nn.Module) -> Tuple[torch.Tensor, torch.Tensor]:
    """(codes (N, K) int8, scales (N,) f32) of ``layer.weight`` (a Linear's
    (N, K), or a 1x1 conv's (N, K, 1, 1)), quantized per output channel
    from its f32 values.  Cached on the layer, keyed by the weight's
    device, storage and version counter: ``load_state_dict`` and an EMA
    snapshot copy in place and bump the counter."""
    w = layer.weight
    key = (w.device, w.data_ptr(), w._version)
    cached = layer.__dict__.get("_int8_weight")
    if cached is not None and cached[0] == key:
        return cached[1]
    if w.dtype != torch.float32:
        raise TypeError(f"int8_weight: {type(layer).__name__} weight is "
                        f"{w.dtype}; int8 serving quantizes from f32 weights")
    with torch.no_grad():
        wq, ws = quantize_rows(w.detach().flatten(1))
    codes = (wq, ws.flatten())
    layer.__dict__["_int8_weight"] = (key, codes)
    return codes


def _check_int_mm(a: torch.Tensor, b: torch.Tensor, name: str) -> None:
    """``_int_mm``'s shape rules on a card: more than 16 rows, K and N
    positive multiples of 8."""
    m, k = a.shape
    n = b.shape[1]
    if m <= 16 or k <= 0 or k % 8 or n <= 0 or n % 8:
        raise ValueError(
            f"{name}: torch._int_mm on a card takes (M, K) x (K, N) with "
            f"M > 16 and K, N multiples of 8; got M={m}, K={k}, N={n}")


def int_mm(a: torch.Tensor, b: torch.Tensor,
           name: str = "int8_dense") -> torch.Tensor:
    """(M, K) int8 x (K, N) int8 -> (M, N) int32, exact; counted on a
    card."""
    global launches
    if a.is_cuda:
        _check_int_mm(a, b, name)
        try:
            out = torch._int_mm(a, b)
        except RuntimeError as e:
            raise ValueError(f"{name}: torch._int_mm refused (M, K, N) = "
                             f"{(a.shape[0], a.shape[1], b.shape[1])}: {e}"
                             ) from e
        launches += 1
        return out
    return torch._int_mm(a, b)


def int8_dense(x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor] = None,
               prequant: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
               out_dtype: Optional[torch.dtype] = None,
               qweight: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
               name: str = "int8_dense") -> torch.Tensor:
    """W8A8 ``F.linear(x, weight, bias)``: x (..., K), weight (N, K) (as
    ``nn.Linear``); the result in ``out_dtype`` (default x's).
    ``prequant``: ``quantize_rows(x)``, shared by several projections of
    x; ``qweight``: :func:`int8_weight`'s codes and scales of ``weight``
    (else quantized here, from its f32 values)."""
    xq, xs = prequant if prequant is not None else quantize_rows(x)
    if qweight is None:
        wq, ws = quantize_rows(weight.float())
        ws = ws.flatten()
    else:
        wq, ws = qweight
    lead = xq.shape[:-1]
    acc = int_mm(xq.reshape(-1, xq.shape[-1]), wq.t(), name)
    y = (acc.reshape(*lead, -1).float() * xs) * ws
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype if out_dtype is not None else x.dtype)


def qlinear(layer: nn.Module, x: torch.Tensor,
            prequant=None) -> torch.Tensor:
    """``layer(x)`` for a Linear (or a bias-free 1x1 conv on channel-last
    x) through :func:`int8_dense` with the layer's cached int8 weights and
    its f32 bias; the result in x's dtype.  Errors name the layer by its
    ``qname`` (set by the model that owns it), else its type."""
    return int8_dense(x, layer.weight, layer.bias, prequant=prequant,
                      qweight=int8_weight(layer),
                      name=getattr(layer, "qname", type(layer).__name__))
