"""Set-up and check shared by the serving cells: the served pipeline with
weights drawn from the seed, the reference with the same weights, and the
comparison of served flows and pages with the reference's."""

from __future__ import annotations

import contextlib
import gc

import torch

from perfbench import weights
from perfbench.harness import program_config, subseed
from perfbench.reference import models as M
from perfbench.reference import serve as R


def model_dicts(config: dict, over=None):
    """(model, diffusion) settings the reference reads."""
    m = dict(config["model"])
    d = dict(config["diffusion"])
    for k, v in (over or {}).get("model", {}).items():
        m[k] = v
    return m, d


def build_pipeline(config: dict, seed: int, device, over=None):
    """The served ``DewarpPipeline`` of the configuration, with the
    weights drawn on the device from ``seed`` loaded into it."""
    from dvd_tpu_torch.evaluation.pipeline import DewarpPipeline

    cfg = program_config(config, over)
    pipe = DewarpPipeline.create(cfg, device)
    state = weights.draw_state(R.state_shapes(model_dicts(config)[0]),
                               subseed(seed, "weights"), device)
    for name in ("dit", "seg", "line", "geotr"):
        getattr(pipe, name).load_state_dict(
            {k[len(name) + 1:]: v for k, v in state.items()
             if k.startswith(name + ".")}, strict=True)
    del state
    return pipe, cfg


def capture(pipe, seen: dict) -> None:
    """Leave in ``seen["cond"]`` (device tensors, no copy) the streams of
    the pipeline's last batch that the check compares: those of
    ``build_conditioning``, Seg's soft mask ``seg_d0`` (from which the
    served hard mask follows) and the DiT pyramid's ``src_feat``, which
    ``sampling_impl`` hoists out of the DDIM loop."""
    build, hoist = pipe.build_conditioning, pipe._hoist_pyramid
    seg = pipe.seg.msk
    seg_forward = seg.forward

    def seg_d0(x):
        out = seg_forward(x)
        seen["seg_d0"] = out[0]
        return out

    def build_conditioning(source512):
        cond, init_flow, init_feat = build(source512)
        seen["cond"] = {k: cond[k] for k in COND_KEYS[:3]}
        seen["cond"]["seg_d0"] = seen.pop("seg_d0")
        return cond, init_flow, init_feat

    def hoist_pyramid(cond):
        out = hoist(cond)
        if "cond" in seen:
            seen["cond"]["src_feat"] = out["src_feat"]
        return out

    seg.forward = seg_d0
    pipe.build_conditioning = build_conditioning
    pipe._hoist_pyramid = hoist_pyramid


@contextlib.contextmanager
def reference_precision():
    """float32 matmuls and convolutions without TF32 while the reference
    runs; the program's own switches are restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def free_program(*objs) -> None:
    """Drop the program's state before the reference runs."""
    del objs
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def build_reference(config: dict, seed: int, device) -> R.Reference:
    """The reference with the weights drawn again from ``seed``."""
    m, d = model_dicts(config)
    state = weights.draw_state(R.state_shapes(m), subseed(seed, "weights"),
                               device)
    return R.Reference(m, d, state, device)


COND_KEYS = ("mask_cat", "mask_y512", "line_msk", "seg_d0", "src_feat")
# a flow value counts as off when it lies farther than this share of the
# largest reference flow from the reference's
OFF = 0.0075


class Gaps:
    """One side's checked numbers (the program's, or a control's in its
    place), gathered over the sampled batches: each the widest gap between
    that side's output and the reference's over the largest magnitude of
    the reference's (pages: the widest gap in [0, 1] units)."""

    def __init__(self):
        self.gap, self.scale = {}, {}
        self.flows = []          # (|got - reference| flat, max |reference|)

    def add(self, name, got, want, relative=True):
        if got.shape != want.shape:     # an output of the wrong shape
            d = float("inf")
        else:
            d = (got.float() - want.float()).abs().max().item()
        self.gap[name] = max(self.gap.get(name, 0.0), d)
        if relative:
            r = want.float().abs().max().item()
            self.scale[name] = max(self.scale.get(name, 0.0), r)

    def flow(self, got, want):
        self.add("flow_gap", got, want)
        self.flows.append(((got - want).abs().flatten().cpu(),
                           want.abs().max().item()))

    def result(self) -> dict:
        """``cond_gap`` (the worst stream; each stream also under
        ``cond_gap.<stream>``), ``flow_gap``, ``flow_off_pct`` and
        ``page_gap``."""
        out = {}
        for name, d in self.gap.items():
            val = d / self.scale[name] if name in self.scale else d
            if name.startswith("cond_gap."):
                out[name] = val
                name = "cond_gap"
            out[name] = max(out.get(name, 0.0), val)
        if self.flows:
            d = torch.cat([f for f, _ in self.flows])
            top = max(m for _, m in self.flows)
            out["flow_off_pct"] = 100.0 * (d > OFF * top).float().mean().item()
        return out


class Check:
    """The comparison with the reference, which follows the served path
    stage by stage:

    - ``cond_gap``: the conditioning streams (``build_conditioning``'s,
      Seg's soft mask and the DiT pyramid's ``src_feat``) against the
      reference's from the same source; the reference's line UNet reads
      the source under the served hard mask (``seg_d0 > 0.5``), so that a
      pixel whose soft mask lies at the threshold may fall on either side
      of it, and the pyramid reads the served soft mask;
    - ``flow_gap``: the flows against the reference's DDIM loop, DiT and
      re-warps run from the served streams and the same x_T;
      ``flow_off_pct``: the share of flow values farther from the
      reference's than ``OFF`` of the largest reference flow;
    - ``page_gap``: the unwarped pages against the reference's unwarp of
      the served flows.

    With ``controls`` the control takes the program's place under the
    same names (``control``): the reference computed a precision below,
    every product of its conditioning and DDIM loop on float8 operands,
    its unwarp in bfloat16."""

    def __init__(self, ref: R.Reference, controls: bool = False):
        self.ref = ref
        self.program = Gaps()
        self.control = Gaps() if controls else None

    def _cond(self, side: Gaps, src, cond, mask_cat):
        """``side``'s streams ``cond`` against the reference's, which
        follow its hard mask; returns the reference's streams."""
        ref = self.ref
        rc = ref.conditioning(src, cond["seg_d0"] > 0.5)
        rc["src_feat"] = ref.pyramid(rc["y512"], mask_cat)
        for k in COND_KEYS:
            side.add(f"cond_gap.{k}", cond[k].to(ref.device), rc[k])
        return rc

    def batch(self, src, x_t, flow, cond):
        """One batch's conditioning and flows: the source (B, S, S, 3) on
        the reference's device, its x_T, the served flows and streams."""
        ref = self.ref
        b = src.shape[0]
        if flow.shape[0] != b or any(v.shape[0] != b for v in cond.values()):
            # served outputs for another number of pages than were sent
            self.program.gap["flow_gap"] = float("inf")
            self.program.flows.append((torch.full((1,), float("inf")), 1.0))
            return
        rc = self._cond(self.program, src, cond, cond["mask_cat"])
        served = dict(cond, y512=rc["y512"])
        want = ref.sample(served, x_t)
        self.program.flow(flow.to(ref.device), want)
        if self.control is not None:
            M.OPERANDS["round"] = "fp8"
            try:
                low = ref.conditioning(src)
                low["src_feat"] = ref.pyramid(low["y512"], cond["mask_cat"])
                low_flow = ref.sample(served, x_t)
            finally:
                M.OPERANDS["round"] = None
            self._cond(self.control, src, low, cond["mask_cat"])
            self.control.flow(low_flow, want)

    def pages(self, got, ref_pages):
        """Served pages in [0, 1] against ``ref_pages(dtype)``, the
        reference's unwarp of the served flows."""
        want = ref_pages(torch.float32)
        self.program.add("page_gap", got.to(want.device), want,
                         relative=False)
        if self.control is not None:
            self.control.add("page_gap", ref_pages(torch.bfloat16), want,
                             relative=False)

    def result(self) -> dict:
        return self.program.result()

    def control_result(self):
        return None if self.control is None else self.control.result()


def meta_flops(config: dict, batch: int) -> float:
    """Model operations of one served batch of ``batch`` pages at the
    configuration's shapes, counted over the reference on the meta
    device."""
    from perfbench.harness import model_flops

    m, d = model_dicts(config)
    ref = R.Reference(m, d, None, "meta")
    src = torch.empty((batch, m["source_size"], m["source_size"], 3),
                      device="meta")
    xt = torch.empty((d["n_batch"] * batch, m["image_size"],
                      m["image_size"], 2), device="meta")
    return model_flops(lambda: R.unwarp_fixed(src, ref.flow(src, xt)))
