"""The chained 'para' DiT with routed experts (DiT-MoE) in plain PyTorch:
``dit_chain.ChainDiT`` whose blocks hold DiT-MoE's sparse MoE layer in
the MLP's place.

DiT-MoE (Fei et al., arXiv:2407.11633; github.com/feizc/DiT-MoE
``models.py``): a router ``gate`` (experts, D) without bias, a softmax
over the experts, the ``top_k`` experts a token with their softmax weights
as they are (not renormalised), each expert a bias-free SwiGLU
``down_proj(silu(gate_proj(x)) * up_proj(x))``, one shared SwiGLU added
for every token, no capacity limit.  Here each expert is a loop step:
``index_select`` of its tokens, its SwiGLU, ``index_add_`` of the
weighted rows; every product goes through ``models.Linear``
(``models.OPERANDS``), so the float8 control reaches the router and the
experts as it reaches every other product.  Run in float32 with TF32 off
(``perfbench.serving.reference_precision``); nothing here fuses, batches
or caches; the module and parameter names are the served package's, so
one state_dict loads into both.

Departures from DiT-MoE, as the served package has them: four token
streams (image, seg pyramid, text line, recurrent) through each block's
shared cross-attention and self-attention, their MoE inputs routed in one
call (a token's result does not depend on the others: no capacity), the
streams' mean handed to the next block; the SATRN decoder over the last
block's four streams in place of a per-token final layer; the
sampling-time timestep remap (t > 600 -> 2, t > 300 -> 1).

Routes.  :meth:`Reference.follow` hands the reference the served routes
of a batch: one (tokens, top_k) tensor of expert indices per call of an
expert layer, in the served order (DDIM step, then block).  Each later
:meth:`Reference.sample` then takes, at each (step, block, token), the
served experts, and weights them with its own float32 softmax at them,
as the serving check follows the served hard mask; it keeps its own top-k
experts of every call in ``Reference.runs`` (one list a ``sample``).
Without served routes it routes itself.  On the meta device (operations
counted by ``FlopCounterMode``, which cannot route) each token passes
``top_k`` experts and the shared one, as a routed token does.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from perfbench.reference import dit_chain
from perfbench.reference import models as M
from perfbench.reference import serve as R

unwarp_fixed = R.unwarp_fixed

# (patch, hidden, depth, heads, (experts, top_k, inner, shared inner))
SIZES = {"DiT-MoE-XL/2-8E2A": dit_chain.SIZES["DiT-XL/2"]
         + ((8, 2, 4 * 1152, 2 * 1152),),
         "DiT-MoE-mini": dit_chain.SIZES["DiT-mini"] + ((8, 2, 192, 96),)}


class SwiGLU(nn.Module):
    def __init__(self, dim, inner):
        super().__init__()
        self.gate_proj = M.Linear(dim, inner, bias=False)
        self.up_proj = M.Linear(dim, inner, bias=False)
        self.down_proj = M.Linear(inner, dim, bias=False)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class Book:
    """One ``sample``'s routes: the served ones to follow (or None) and
    the reference's own top-k of each call."""

    def __init__(self, served: Optional[List[torch.Tensor]]):
        self.served, self.own = served, []

    def take(self, own: torch.Tensor) -> torch.Tensor:
        """The experts to use at this call: the served ones where given
        for a call of this shape, else ``own``."""
        i = len(self.own)
        self.own.append(own)
        if self.served is None or i >= len(self.served) \
                or self.served[i].shape != own.shape:
            return own
        return self.served[i].to(own.device)


class MoE(nn.Module):
    def __init__(self, dim, experts, top_k, inner, shared_inner):
        super().__init__()
        self.top_k = top_k
        self.gate = M.Linear(dim, experts, bias=False)
        for e in range(experts):
            setattr(self, f"experts_{e}", SwiGLU(dim, inner))
        self.shared_experts = SwiGLU(dim, shared_inner)
        self.book = Book(None)

    def forward(self, x):
        """(P, D) -> (P, D)."""
        n = self.gate.out_features
        experts = [getattr(self, f"experts_{e}") for e in range(n)]
        scores = self.gate(x).softmax(dim=-1)
        if x.is_meta:       # the work of a routed token, for the count
            return sum(experts[e](x) for e in range(self.top_k)) \
                + self.shared_experts(x)
        idx = self.book.take(torch.topk(scores, self.top_k, dim=-1).indices)
        weights = scores.gather(1, idx)
        y = torch.zeros_like(x)
        for e in range(n):
            tok, slot = (idx == e).nonzero(as_tuple=True)
            if tok.numel():
                y.index_add_(0, tok, experts[e](x.index_select(0, tok))
                             * weights[tok, slot, None])
        return y + self.shared_experts(x)


class MoEBlock(nn.Module):
    """``models.DiTBlock`` with the MoE layer in the MLP's place: the
    streams' MoE inputs routed in one call."""

    def __init__(self, dim, heads, moe):
        super().__init__()
        self.adaLN_modulation_1 = M.Linear(dim, 6 * dim)
        self.cross_attn = M.CrossAttention(dim, heads)
        self.attn = M.SelfAttention(dim, heads)
        self.moe = MoE(dim, *moe)

    def forward(self, x, t_emb, streams):
        sm, cm, gm, sf, cf, gf = self.adaLN_modulation_1(
            F.silu(t_emb)).chunk(6, dim=-1)
        xq = M.layer_norm(x)
        xs = []
        for s in streams:
            xi = x + self.cross_attn(xq, s, s)
            xs.append(xi + gm[:, None] * self.attn(
                M.modulate(M.layer_norm(xi), sm, cm)))
        h = torch.cat([M.modulate(M.layer_norm(xi), sf, cf) for xi in xs])
        y = self.moe(h.reshape(-1, h.shape[-1])).reshape(h.shape)
        return [xi + gf[:, None] * yi for xi, yi in zip(xs, y.chunk(len(xs)))]


def build_nets(model_cfg: dict) -> dict:
    """The served networks of a configuration, by the program's names, with
    the chained DiT-MoE of ``model_cfg["dit_variant"]``."""
    patch, hidden, depth, heads, moe = SIZES[model_cfg["dit_variant"]]
    dit = dit_chain.ChainDiT(model_cfg["image_size"], patch, hidden, depth,
                             heads)
    for i in range(depth):
        setattr(dit, f"blocks_{i}", MoEBlock(hidden, heads, moe))
    return {"dit": dit, "seg": M.Seg(), "line": M.TextLineUNet(),
            "geotr": M.GeoTrSegInf(model_cfg["source_size"])}


def state_shapes(model_cfg: dict) -> dict:
    """{"<net>.<leaf>": shape} of every weight and statistic."""
    with torch.device("meta"):
        nets = build_nets(model_cfg)
    return {f"{n}.{k}": tuple(v.shape) for n, net in nets.items()
            for k, v in net.state_dict().items()}


class Reference(R.Reference):
    """``serve.Reference`` whose networks are :func:`build_nets`'s, which
    follows the served routes given to :meth:`follow`."""

    def __init__(self, model_cfg: dict, diffusion_cfg: dict,
                 state: Optional[dict], device):
        self.m, self.d = model_cfg, diffusion_cfg
        self.device = torch.device(device)
        with torch.device(self.device):
            nets = build_nets(model_cfg)
        for name, net in nets.items():
            if state is not None:
                net.load_state_dict(
                    {k[len(name) + 1:]: v for k, v in state.items()
                     if k.startswith(name + ".")}, strict=True)
            setattr(self, name, net.to(self.device).float().eval()
                    .requires_grad_(False))
        acp, prev, ts = R.cosine_schedule(diffusion_cfg["diffusion_steps"])
        self.acp, self.acp_prev, self.ts = (x.to(self.device)
                                            for x in (acp, prev, ts))
        self.served = None
        self.runs: List[List[torch.Tensor]] = []

    def follow(self, routes: Optional[List[torch.Tensor]]) -> None:
        """Follow ``routes`` (see the module's docstring) in the next
        samples, and forget the runs' own routes."""
        self.served, self.runs = routes, []

    def sample(self, cond: dict, x_t: torch.Tensor) -> torch.Tensor:
        book = Book(self.served)
        self.runs.append(book.own)
        for mod in self.dit.modules():
            if isinstance(mod, MoE):
                mod.book = book
        return super().sample(cond, x_t)


def flips(a: List[torch.Tensor], b: List[torch.Tensor]):
    """(decisions whose top-k expert sets differ, decisions) between two
    runs' routes, call by call; a call that one run lacks or holds in
    another shape counts every decision of the other's as differing."""
    differ = total = 0
    for i in range(max(len(a), len(b))):
        x = a[i] if i < len(a) else None
        y = b[i] if i < len(b) else None
        n = max(t.shape[0] for t in (x, y) if t is not None)
        total += n
        if x is None or y is None or x.shape != y.shape:
            differ += n
            continue
        y = y.to(x.device)
        differ += int((x.sort(dim=-1).values != y.sort(dim=-1).values)
                      .any(dim=-1).sum())
    return differ, total
