"""The routed experts' grouped GEMM, beside its plain twin.

``grouped_mm(a, b, ends)`` multiplies consecutive row groups of ``a``
(M, K) by one matrix each of ``b`` (G, K, N): rows ``ends[g-1]:ends[g]``
by ``b[g]`` (``ends`` (G,) int32 on ``a``'s device, the groups' cumulative
ends, the last one M; a group may be empty).  It replaces no TPU kernel:
``dvd_tpu`` has no sparse experts.  The MoE layer (``models/moe.py``)
calls it twice a block, for the experts' fused gate/up projection and
their down projection, with the rows already in expert order.

Routes:

- bf16 CUDA tensors: one launch of ``torch._grouped_mm`` with the group
  ends on the device, so no size crosses to the host (counted in
  ``grouped_mm.launches``).  At the DiT-MoE-XL/2 shapes (65536 rows,
  K 1152, N 9216 and K 4608, N 1152) the products are bound by the tensor
  cores' operations, not by bytes; ``b`` as the transposed view of stacked
  ``nn.Linear`` weights (column-major (K, N) blocks) reads them as
  stored, which ran faster on an H100 than a row-major copy (PERF.md §6).
- every other tensor (the CPU, f32 on a card): :func:`grouped_mm_ref`,
  one ``matmul`` per group, whose slices read the ends on the host.
"""

from __future__ import annotations

import torch


def grouped_mm_ref(a: torch.Tensor, b: torch.Tensor,
                   ends: torch.Tensor) -> torch.Tensor:
    """The plain twin: one ``matmul`` per group, (M, N) in a's dtype."""
    out = a.new_empty((a.shape[0], b.shape[-1]))
    start = 0
    for g, end in enumerate(ends.tolist()):
        if end > start:
            torch.matmul(a[start:end], b[g], out=out[start:end])
        start = end
    return out


def grouped_mm(a: torch.Tensor, b: torch.Tensor,
               ends: torch.Tensor) -> torch.Tensor:
    """(M, K) rows in group order x (G, K, N) -> (M, N); see the module's
    docstring for the routes."""
    if a.dim() != 2 or b.dim() != 3 or a.shape[1] != b.shape[1] \
            or ends.shape != (b.shape[0],):
        raise ValueError(f"grouped_mm: a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}, ends {tuple(ends.shape)}")
    if a.is_cuda and a.dtype == torch.bfloat16 and b.dtype == torch.bfloat16:
        grouped_mm.launches += 1
        return torch._grouped_mm(a, b, offs=ends.to(torch.int32))
    return grouped_mm_ref(a, b, ends)


grouped_mm.launches = 0
