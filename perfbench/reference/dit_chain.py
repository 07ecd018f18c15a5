"""The chained 'para' DiT in plain PyTorch, at any DiT size: every block
runs, each reading the mean of the previous block's streams, and the SATRN
decoder fuses the last block's streams.

Built from ``models.py``'s ``DiTBlock``, ``Decoder``, ``FinalLayer`` and
``Linear`` (whose operands follow ``models.OPERANDS``, so the float8
control reaches every product here), with the module and parameter names
of the served package: one state_dict loads into both.  Run in float32
with TF32 off (``perfbench.serving.reference_precision``); nothing here
fuses, batches or caches.

Departures from the published DiT (Peebles & Xie, arXiv:2212.09748), as
the served package has them: four token streams (image, seg pyramid, text
line, recurrent) through the shared cross-attention of each block, their
mean handed to the next block; the SATRN decoder over the last block's
four streams in place of a per-token final layer; the sampling-time
timestep remap (t > 600 -> 2, t > 300 -> 1).

``Reference`` is ``serve.Reference`` with these networks; ``state_shapes``
and ``unwarp_fixed`` are this module's as ``serve``'s are, so that the
serving harness can take this module in the place of ``serve``.
"""

from __future__ import annotations

from typing import Optional

import torch

from perfbench.reference import models as M
from perfbench.reference import serve as R

unwarp_fixed = R.unwarp_fixed

# (patch, hidden, depth, heads) of DvD's size registry (``DiT_models2``;
# DiT, arXiv:2212.09748, Table 1) and the CPU tests' mini size
SIZES = {f"DiT-{name}/{p}": (p, hidden, depth, heads)
         for name, depth, hidden, heads in (("XL", 28, 1152, 16),
                                            ("L", 24, 1024, 16),
                                            ("B", 12, 768, 12),
                                            ("S", 12, 384, 6))
         for p in (2, 4, 8)}
SIZES["DiT-mini"] = (2, 48, 2, 3)


class ChainDiT(M.DiT):
    """``models.DiT`` with every block live: block i + 1 reads the mean of
    block i's four streams."""

    def forward(self, x, t, *, init_flow, init_feat, seed, src_feat,
                cond_tokens, msk6_tokens, line_tokens, remap=True, gen=None):
        """As ``models.DiT.forward``."""
        tokens = self.embed("obs_embedder", x.permute(0, 3, 1, 2))
        if remap:
            t = torch.where(t > 600.0, torch.full_like(t, 2.0),
                            torch.where(t > 300.0, torch.full_like(t, 1.0), t))
        t_emb = self.t_embedder(t)
        init_feat = torch.where(seed.reshape(-1, 1, 1, 1), src_feat, init_feat)
        r = self.embed("r_embedder", torch.cat(
            [init_flow.permute(0, 3, 1, 2), init_feat], dim=1))
        streams = (cond_tokens, msk6_tokens, line_tokens, r)
        for i in range(self.depth):
            outs = getattr(self, f"blocks_{i}")(tokens, t_emb, streams)
            tokens = sum(outs) / len(outs)
        fused = torch.cat(outs, dim=-1)
        n, tt, d = fused.shape
        g = int(round(tt ** 0.5))
        out = self.final_layer2(self.decoder(fused.reshape(n, g, g, d), gen),
                                t_emb)
        p, c = self.patch, self.cin
        pred = out.reshape(n, g, g, p, p, c).permute(0, 1, 3, 2, 4, 5) \
            .reshape(n, g * p, g * p, c)
        return pred + init_flow, src_feat


def build_nets(model_cfg: dict) -> dict:
    """The served networks of a configuration, by the program's names, with
    the chained DiT of ``model_cfg["dit_variant"]``."""
    patch, hidden, depth, heads = SIZES[model_cfg["dit_variant"]]
    return {"dit": ChainDiT(model_cfg["image_size"], patch, hidden, depth,
                            heads),
            "seg": M.Seg(), "line": M.TextLineUNet(),
            "geotr": M.GeoTrSegInf(model_cfg["source_size"])}


def state_shapes(model_cfg: dict) -> dict:
    """{"<net>.<leaf>": shape} of every weight and statistic."""
    with torch.device("meta"):
        nets = build_nets(model_cfg)
    return {f"{n}.{k}": tuple(v.shape) for n, net in nets.items()
            for k, v in net.state_dict().items()}


class Reference(R.Reference):
    """``serve.Reference`` whose networks are :func:`build_nets`'s: the
    chained DiT at the configuration's size."""

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
