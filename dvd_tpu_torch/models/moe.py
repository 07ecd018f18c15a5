"""Routed experts in the DiT block's MLP place: DiT-MoE's sparse MoE layer
(Fei et al., "Scaling Diffusion Transformers to 16 Billion Parameters",
arXiv:2407.11633; code github.com/feizc/DiT-MoE ``models.py``:
``MoEGate``, ``MoeMLP``, ``SparseMoeBlock``), at inference.

- the router ``gate`` (experts, D), no bias, in the compute dtype; the
  softmax over the experts in f32; the ``top_k`` experts a token, their
  softmax weights used as they are (``norm_topk_prob`` off: not
  renormalised); no capacity limit, so no token is dropped;
- each routed expert a bias-free SwiGLU, ``down_proj(silu(gate_proj(x)) *
  up_proj(x))`` of width ``inner``; one shared SwiGLU of width
  ``shared_inner`` that every token passes, added to the routed sum.
  The expert-level balance loss is training's, which is not ported.

Every expert keeps its own 2-D leaves (``experts_<e>.gate_proj.weight``
...), so a state_dict holds no stacked (experts, out, in) leaf.

The layer takes the tokens of the whole call at once, (P, D): the DiT
block hands it its four streams together.  Its steps:

1. :meth:`MoE.route`: the router, the softmax and ``topk``; (P, top_k)
   experts and weights;
2. a stable sort of the P * top_k (token, expert) pairs into expert order;
   each expert's end in the sorted pairs from ``searchsorted`` (on the
   device), and the input rows gathered in that order;
3. two grouped GEMMs over all experts (``ops/kernels/grouped_mm.py``):
   the fused gate/up projection, SwiGLU, the down projection;
4. the shared expert over every token;
5. the combine: the expert rows put back in pair order, weighted, summed
   over a token's ``top_k`` in f32, plus the shared expert's output.

No step needs a size on the host: on a card the layer makes no host
synchronisation (bf16; f32 takes the grouped GEMM's plain twin, which
reads the ends on the host).

Spans (``utils/trace.py``): ``dvd.dit.moe`` around the layer
(``tokens``, ``experts``, ``top_k``, ``inner``, ``dim``,
``shared_inner``, ``itemsize``) and, inside it, ``dvd.dit.moe.route``
(steps 1-2), ``.experts`` (3), ``.shared`` (4) and ``.combine`` (5);
while tracing is active, the counter ``dvd.dit.moe.expert_tokens`` adds
the tokens routed to each expert.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from dvd_tpu_torch.ops.kernels.grouped_mm import grouped_mm
from dvd_tpu_torch.utils import trace
from dvd_tpu_torch.utils.dtypes import at_least_f32


@dataclasses.dataclass(frozen=True)
class MoESpec:
    """A MoE layer's shape: routed experts, experts a token, and the
    routed and shared SwiGLU widths over the hidden size."""

    experts: int = 8
    top_k: int = 2
    inner_ratio: float = 4.0
    shared_ratio: float = 2.0


class SwiGLU(nn.Module):
    """DiT-MoE's ``MoeMLP``: ``down_proj(silu(gate_proj(x)) * up_proj(x))``,
    bias-free."""

    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.gate_proj = nn.Linear(dim, inner, bias=False)
        self.up_proj = nn.Linear(dim, inner, bias=False)
        self.down_proj = nn.Linear(inner, dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class MoE(nn.Module):
    """DiT-MoE's ``SparseMoeBlock`` at inference: (P, D) -> (P, D) in x's
    dtype.  See the module's docstring."""

    def __init__(self, dim: int, spec: MoESpec):
        super().__init__()
        self.spec = spec
        self.inner = int(dim * spec.inner_ratio)
        self.gate = nn.Linear(dim, spec.experts, bias=False)
        for e in range(spec.experts):
            setattr(self, f"experts_{e}", SwiGLU(dim, self.inner))
        self.shared_experts = SwiGLU(dim, int(dim * spec.shared_ratio))

    def experts(self):
        return [getattr(self, f"experts_{e}")
                for e in range(self.spec.experts)]

    def route(self, x: torch.Tensor):
        """(P, D) -> (experts (P, top_k) int64, weights (P, top_k) f32):
        the router in x's dtype, its softmax in f32, the ``top_k`` largest
        (largest first)."""
        scores = at_least_f32(F.linear(x, self.gate.weight)).softmax(dim=-1)
        weights, idx = torch.topk(scores, self.spec.top_k, dim=-1)
        return idx, weights

    def stacked(self, dtype: torch.dtype):
        """The experts' weights as the grouped GEMM reads them, in
        ``dtype``: gate/up (E, D, 2 inner) and down (E, inner, D), each
        the transposed view of the experts' ``nn.Linear`` weights stacked.
        Cached on the layer, keyed by the dtype and the weights' storage
        and version counters (as ``layers.fold_conv_bn``), so it is built
        again only after the weights are replaced, moved or loaded."""
        leaves = [lin.weight for ex in self.experts()
                  for lin in (ex.gate_proj, ex.up_proj, ex.down_proj)]
        key = (dtype,) + tuple((p.data_ptr(), p._version) for p in leaves)
        cached = self.__dict__.get("_stacked")
        if cached is not None and cached[0] == key:
            return cached[1]
        self.__dict__.pop("_stacked", None)     # free the old copy first
        with torch.no_grad():
            w13 = torch.stack([torch.cat([ex.gate_proj.weight,
                                          ex.up_proj.weight]).to(dtype)
                               for ex in self.experts()]).transpose(1, 2)
            w2 = torch.stack([ex.down_proj.weight.to(dtype)
                              for ex in self.experts()]).transpose(1, 2)
        self.__dict__["_stacked"] = (key, (w13, w2))
        return w13, w2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p, d = x.shape
        n, k = self.spec.experts, self.spec.top_k
        shared_inner = self.shared_experts.gate_proj.out_features
        with trace.span("dvd.dit.moe", tokens=p, experts=n, top_k=k,
                        inner=self.inner, dim=d, shared_inner=shared_inner,
                        itemsize=x.element_size()):
            with trace.span("dvd.dit.moe.route"):
                idx, weights = self.route(x)
                expert, order = torch.sort(idx.flatten(), stable=True)
                ends = torch.searchsorted(
                    expert, torch.arange(n, device=x.device), right=True,
                    out_int32=True)
                if trace.active():
                    trace.count("dvd.dit.moe.expert_tokens",
                                torch.diff(ends, prepend=ends.new_zeros(1)))
                rows = x.index_select(0, order // k)
            with trace.span("dvd.dit.moe.experts"):
                w13, w2 = self.stacked(x.dtype)
                gate, up = grouped_mm(rows, w13, ends).chunk(2, dim=-1)
                y = grouped_mm(F.silu(gate) * up, w2, ends)
            with trace.span("dvd.dit.moe.shared"):
                shared = self.shared_experts(x)
            with trace.span("dvd.dit.moe.combine"):
                routed = torch.empty_like(y).index_copy_(0, order, y)
                out = (at_least_f32(routed.view(p, k, d))
                       * weights[..., None]).sum(dim=1) + at_least_f32(shared)
        return out.to(x.dtype)
