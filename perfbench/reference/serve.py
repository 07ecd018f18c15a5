"""The shipped serving path in plain PyTorch: conditioning, the DDIM loop
with the recurrent re-warp, and both unwarps (a page at the source's own
size, and pages at their native sizes).

``Reference(model_cfg, diffusion_cfg, state, device)`` builds the nets
from a state_dict (the weights the benchmark drew); ``flow`` serves a
batch from the x_T that ``draw_xt`` draws from the seed the served path
was given.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference import models as M

SHRINK = 0.987    # the DvD reference's grid factor ((flow + base) * 2 - 1) * 0.987


def cosine_schedule(steps: int, rescale: bool = True):
    """(alphas_cumprod, alphas_cumprod_prev, model-facing t) of the cosine
    schedule with every step kept, in float64, as f32 tensors."""
    def abar(t):
        return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

    betas = np.array([min(1 - abar((i + 1) / steps) / abar(i / steps), 0.999)
                      for i in range(steps)])
    acp = np.cumprod(1.0 - betas)
    prev = np.append(1.0, acp[:-1])
    ts = np.arange(steps, dtype=np.float64) * (1000.0 / steps if rescale else 1)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32))
    return f32(acp), f32(prev), f32(ts)


def base_grid(h: int, w: int, device) -> torch.Tensor:
    ys = torch.linspace(0.0, 1.0, h, dtype=torch.float64, device=device)
    xs = torch.linspace(0.0, 1.0, w, dtype=torch.float64, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1).float()


def flow_to_grid(flow, shrink: float = 1.0):
    """(N, H, W, 2) offsets -> the [-1, 1] grid ((flow + base) * 2 - 1) *
    shrink."""
    g = (flow + base_grid(flow.shape[1], flow.shape[2], flow.device)) * 2 - 1
    return g * shrink


def warp(img, grid):
    return F.grid_sample(img, grid, mode="bilinear", padding_mode="zeros",
                         align_corners=True)


DIT_SIZES = {"DiT-S/2": (2, 384, 12, 6), "DiT-mini": (2, 48, 2, 3)}


def build_nets(model_cfg: dict) -> dict:
    """The served networks of a configuration, by the program's names."""
    patch, hidden, depth, heads = DIT_SIZES[model_cfg["dit_variant"]]
    return {"dit": M.DiT(model_cfg["image_size"], patch, hidden, depth, heads),
            "seg": M.Seg(), "line": M.TextLineUNet(),
            "geotr": M.GeoTrSegInf(model_cfg["source_size"])}


def state_shapes(model_cfg: dict) -> dict:
    """{"<net>.<leaf>": shape} of every weight and statistic."""
    with torch.device("meta"):
        nets = build_nets(model_cfg)
    return {f"{n}.{k}": tuple(v.shape) for n, net in nets.items()
            for k, v in net.state_dict().items()}


class Reference:
    """The served networks and schedule of one configuration, from a
    state_dict (the weights the benchmark drew); ``state`` None builds
    them as they come (on the meta device, to count operations)."""

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
        acp, prev, ts = cosine_schedule(diffusion_cfg["diffusion_steps"])
        self.acp, self.acp_prev, self.ts = (x.to(self.device)
                                            for x in (acp, prev, ts))

    def draw_xt(self, seed: int, b: int) -> torch.Tensor:
        """x_T of a batch of ``b`` pages, hypothesis-major, from a
        generator on the device seeded with ``seed``."""
        s, nb = self.m["image_size"], self.d["n_batch"]
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return torch.randn((nb * b, s, s, 2), generator=gen,
                           device=self.device)

    @torch.no_grad()
    def conditioning(self, source: torch.Tensor, mask=None) -> dict:
        """(B, H, W, 3) in [0, 1] -> the conditioning streams, NCHW:
        ``y512`` (the source), ``mask_cat`` (GeoTr's soft mask at the
        source size), ``seg_d0`` (Seg's soft mask at the perception size),
        ``mask_y512`` (Seg's six side features at the latent size) and
        ``line_msk`` (the line UNet's features there, from the source
        under Seg's hard mask, or under ``mask`` where given)."""
        s, per = self.m["image_size"], self.m["perception_size"]
        x = source.to(self.device, torch.float32).permute(0, 3, 1, 2)
        xa = M.resize(x, (per, per), True)
        if mask is not None:
            mask = mask.to(self.device)
        mskx, pyramid, d0 = self.seg(xa, mask)
        return {"y512": x, "mask_cat": self.geotr(xa), "seg_d0": d0,
                "mask_y512": torch.cat([M.resize(f, (s, s), False)
                                        for f in pyramid], 1),
                "line_msk": M.resize(self.line(mskx), (s, s), False)}

    @torch.no_grad()
    def pyramid(self, y512, mask_cat) -> torch.Tensor:
        """The DiT's image-stream features from the source and the soft
        mask."""
        return self.dit.pyramid(torch.cat([
            y512.to(self.device, torch.float32),
            mask_cat.to(self.device, torch.float32)], 1))

    @torch.no_grad()
    def sample(self, cond: dict, x_t: torch.Tensor) -> torch.Tensor:
        """Conditioning streams and x_T (``draw_xt``) -> (B, S, S, 2): the
        DiT's pyramid once (unless ``cond`` holds its ``src_feat``), then
        the DDIM loop over the hypotheses with the recurrent features
        re-warped by each step's flow."""
        cond = {k: v.to(self.device, torch.float32) for k, v in cond.items()}
        s, b = self.m["image_size"], cond["y512"].shape[0]
        src_feat = cond["src_feat"] if "src_feat" in cond else \
            self.pyramid(cond["y512"], cond["mask_cat"])
        streams = dict(
            cond_tokens=self.dit.embed("c_embedder", src_feat),
            msk6_tokens=self.dit.embed("m_embedder", cond["mask_y512"]),
            line_tokens=self.dit.embed("l_embedder", cond["line_msk"]))
        nb = self.d["n_batch"]
        rep = lambda t: t.repeat((nb,) + (1,) * (t.dim() - 1))
        streams = {k: rep(v) for k, v in streams.items()}
        feat = rep(src_feat)
        init_flow = torch.zeros((nb * b, s, s, 2), device=self.device)
        fl, ft, pred = init_flow, torch.zeros_like(feat), init_flow
        T = len(self.ts)
        for i in range(T - 1, -1, -1):
            if i != T - 1:
                fl, ft = pred, warp(feat, flow_to_grid(pred))
            tv = torch.full((nb * b,), i, dtype=torch.long, device=self.device)
            pred, _ = self.dit(
                x_t, self.ts[tv], init_flow=fl, init_feat=ft,
                seed=torch.full((nb * b,), i == T - 1, device=self.device),
                src_feat=feat, **streams)
            ab, ab_prev = self.acp[i], self.acp_prev[i]
            eps = (x_t / torch.sqrt(ab) - pred) / torch.sqrt(1 / ab - 1)
            x_t = pred * torch.sqrt(ab_prev) + torch.sqrt(1 - ab_prev) * eps
        return pred.reshape(nb, b, s, s, 2).mean(0).clamp(-1.0, 1.0)

    def flow(self, source: torch.Tensor, x_t: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) in [0, 1] and x_T -> (B, S, S, 2)."""
        return self.sample(self.conditioning(source), x_t)


@torch.no_grad()
def unwarp_fixed(source: torch.Tensor, flow: torch.Tensor,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, H, W, C) at its own size, (B, S, S, 2) flow -> (B, H, W, C) f32,
    computed in ``dtype``."""
    h, w = source.shape[1:3]
    fl = M.resize(flow.to(dtype).permute(0, 3, 1, 2), (h, w), True)
    grid = flow_to_grid(fl.permute(0, 2, 3, 1), SHRINK).to(dtype)
    img = source.to(dtype).permute(0, 3, 1, 2)
    return warp(img, grid).permute(0, 2, 3, 1).float()


@torch.no_grad()
def unwarp_page_u8(page: torch.Tensor, flow: torch.Tensor,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """One page (h, w, C) uint8 at its native size, one (S, S, 2) flow ->
    (h, w, C) uint8: the unwarp rounded half to even and clipped."""
    out = unwarp_fixed(page[None], flow[None], dtype)[0]
    return torch.round(out).clamp(0, 255).to(torch.uint8)
