#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``dvd_tpu_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its lines; a failing phase raises and the script
exits non-zero -- nothing is caught):

1. env      the card's name and power limit, torch/CUDA versions, the TF32
            settings; builds the kernels from ``dvd_tpu_torch/csrc`` for
            sm_90a and prints nvcc's ``-Xptxas -v`` report.
2. kernels  each hand-written kernel against its plain PyTorch twin on the
            card at the serving path's shapes, f32 and bf16, with the
            stated tolerances; then each kernel's time beside its twin's.
3. slice32  the serving slice at full DiT-S/2 width and 512^2, batch 1, in
            f32: once on the card through the kernels (launch counts must
            all be > 0) and once on the CPU through the twins, with the
            same weights and the same pinned x_T; flow and unwarped image
            compared.
4. shipped  the shipped config (bf16, batch 4, 3 DDIM steps x 2
            hypotheses) through ``DewarpPipeline.dewarp_flow`` +
            ``unwarp_fixed`` and through the single-image CLI function on a
            600x450 page; outputs checked; imgs/s and ms per stage; one
            run under torch.profiler for device time by kernel and the
            device's busy share.

The line before the last is the per-kernel JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device the script
raises before printing any result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0

# tolerances (max abs error unless stated), kernel vs its twin on the card
TOL = {
    "attention_f32": 1e-4,     # unit-scale inputs
    "conv3x3_f32_rel": 1e-4,   # max|err| / max|ref|
    "gather_f32": 1e-5,
    "bf16": 2e-2,              # x max(1, max|ref|), same bf16 inputs
    "slice_flow": 1e-3,        # f32 slice, card vs CPU
    "slice_image": 1e-3,       # unwarped image in [0, 1]
}

# the case whose time goes into the per-kernel JSON record: the serving
# path's heaviest shape for each kernel, in the shipped dtype
RECORD_CASE = {
    "attention": "(8, 6, 1024, 256) scale 0.0625 bfloat16",
    "conv3x3": "256->256 @128^2 d1 b4 bfloat16",
    "gather_bilinear": "(4, 3, 512, 512) zeros",
}

KERNELS = {
    # name -> (source, replaced TPU kernel)
    "attention": ("dvd_tpu_torch/csrc/attention.cu",
                  "dvd_tpu/ops/pallas/attention.py:49"),
    "conv3x3": ("dvd_tpu_torch/csrc/conv3x3.cu",
                "dvd_tpu/ops/pallas/planar_conv.py:247"),
    "gather_bilinear": ("dvd_tpu_torch/csrc/grid_sample.cu",
                        "dvd_tpu/ops/pallas/grid_sample.py:122"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_label() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_report(log_text: str):
    """(kernel<args>, registers, spills) per entry function in nvcc's
    ``-Xptxas -v`` output."""
    import re

    out, entry, spills = [], None, ""
    names = {"13__nv_bfloat16": "bf16", "f": "f32", "Lb1": "zeros",
             "Lb0": "border"}
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"(attention_fwd_kernel|conv3x3_kernel|"
                          r"gather_bilinear_kernel)I(.*?)EE", m.group(1))
            args = re.findall(r"13__nv_bfloat16|Li\d+|Lb\d|f", k.group(2)) \
                if k else []
            args = [names.get(a, a[2:] if a.startswith("Li") else a)
                    for a in args]
            entry = f"{k.group(1)}<{','.join(args)}>" if k else m.group(1)
        elif entry and "spill stores" in line:
            spills = line.split("info    :")[-1].strip()
        elif entry and "Used" in line and "registers" in line:
            out.append((entry, line.split("info    :")[-1].strip(), spills))
            entry = None
    return out


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def compare(name, got, want, bar, rel=False):
    err = (got.float() - want.float()).abs().max().item()
    ref = want.float().abs().max().item()
    val = err / max(ref, 1e-30) if rel else err
    ok = math.isfinite(val) and val <= bar
    log(f"  {name}: max_abs_err={err:.3e} max_rel_err={err / max(ref, 1e-30):.3e}"
        f" ({'rel' if rel else 'abs'} bar {bar:.1e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: error {val:.3e} above {bar:.1e}")
    return err


# ---------------------------------------------------------------- phase 1
def phase_env(state):
    from dvd_tpu_torch.ops.kernels import build

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on a GPU only")
    state["label"] = card_label()
    log(state["label"])   # the card's name and power limit, as nvidia-smi
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}; devices {torch.cuda.device_count()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"[env] cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    t0 = time.perf_counter()
    kl = build.load_library()
    how = (f"built in {time.perf_counter() - t0:.1f} s (nvcc "
           f"{kl.build_seconds:.1f} s)" if kl.build_seconds else
           "loaded from an earlier build of the same sources")
    log(f"[env] kernels from dvd_tpu_torch/csrc for sm_90a {how} -> "
        f"{kl.path.relative_to(build.PKG_DIR.parent)}")
    for entry, regs, spills in ptxas_report(kl.build_log):
        log(f"[env] ptxas -v {entry}: {regs}; {spills}")
    # every kernel's shared memory is dynamic, which ptxas does not report
    from dvd_tpu_torch.ops.kernels.attention import HEAD_DIMS
    kib = lambda n: f"{n / 1024:.1f} KiB"
    log("[env] dynamic shared memory per block: attention_fwd_kernel " + ", ".join(
        f"Dh {dh} {kib(kl.lib.dvd_attention_smem_bytes(dh))}" for dh in HEAD_DIMS))
    log("[env] dynamic shared memory per block: conv3x3_kernel " + ", ".join(
        f"<{cot}> d{d} {kib(kl.lib.dvd_conv3x3_smem_bytes(cot, d))}"
        for cot in (16, 32) for d in (1, 2, 4, 8)) + "; gather_bilinear_kernel 0")


# ---------------------------------------------------------------- phase 2
def _qkv(b, h, t, dh, dtype, gen, dev):
    # the split_heads views of a fused (B, T, 3, H, Dh) projection:
    # strided, as the main path hands them to the kernel
    qkv = torch.randn((b, t, 3, h, dh), generator=gen, device=dev).to(dtype)
    return tuple(qkv[:, :, i].transpose(1, 2) for i in range(3))


def _smooth_grid(n, p, q, gen, dev):
    """A dewarp-like grid in [-1, 1] with a smooth random flow that pushes
    the border coordinates out of range."""
    yy, xx = torch.meshgrid(torch.linspace(-1, 1, p, device=dev),
                            torch.linspace(-1, 1, q, device=dev), indexing="ij")
    a = torch.rand((n, 4, 1, 1), generator=gen, device=dev) * 0.15
    gx = xx * 1.08 + a[:, 0] * torch.sin(3 * yy) + a[:, 1] * xx * yy
    gy = yy * 1.08 + a[:, 2] * torch.cos(3 * xx) + a[:, 3] * xx * xx
    return torch.stack([gx, gy], dim=-1)


def phase_kernels(state):
    from dvd_tpu_torch.ops.grid_sample import unnormalize
    from dvd_tpu_torch.ops.kernels.attention import attention, attention_ref
    from dvd_tpu_torch.ops.kernels.conv3x3 import conv3x3, conv3x3_ref
    from dvd_tpu_torch.ops.kernels.grid_sample import (gather_bilinear,
                                                       gather_bilinear_ref)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    errs = {k: 0.0 for k in KERNELS}
    times = {}
    bf16 = torch.bfloat16
    with torch.inference_mode():
        log("[kernels] K1 attention (B, H, T, Dh), strided split_heads views")
        for shape, scale in (((8, 6, 1024, 64), 1 / 8), ((8, 6, 1024, 256), 1 / 16)):
            for dt in (torch.float32, bf16):
                q, k, v = _qkv(*shape, dt, gen, dev)
                got = attention(q, k, v, scale)
                want = attention_ref(q, k, v, scale)
                bar = TOL["attention_f32"] if dt == torch.float32 else \
                    TOL["bf16"] * max(1.0, want.float().abs().max().item())
                case = f"{shape} scale {scale:g} {str(dt)[6:]}"
                errs["attention"] = max(errs["attention"],
                                        compare(case, got, want, bar))
                if dt == bf16:
                    times[("attention", case)] = (
                        cuda_time_ms(lambda: attention(q, k, v, scale)),
                        cuda_time_ms(lambda: attention_ref(q, k, v, scale)))

        log("[kernels] K2 conv3x3 (B, Cin, H, W) -> Cout, dilation")
        for b, cin, cout, hw, d in ((4, 3, 16, 288, 1), (4, 64, 16, 9, 8),
                                    (4, 4, 64, 512, 1), (4, 256, 256, 128, 1),
                                    (4, 1024, 512, 36, 1), (4, 64, 1, 288, 1)):
            for dt in (torch.float32, bf16):
                x = torch.randn((b, cin, hw, hw), generator=gen, device=dev).to(dt)
                w = (torch.randn((cout, cin, 3, 3), generator=gen, device=dev)
                     / math.sqrt(9 * cin)).to(dt)
                s = 1 + 0.1 * torch.randn((cout,), generator=gen, device=dev)
                bi = 0.1 * torch.randn((cout,), generator=gen, device=dev)
                got = conv3x3(x, w, s, bi, d, True)
                want = conv3x3_ref(x, w, s, bi, d, True)
                name = f"{cin}->{cout} @{hw}^2 d{d} b{b} {str(dt)[6:]}"
                if dt == torch.float32:
                    errs["conv3x3"] = max(errs["conv3x3"], compare(
                        name, got, want, TOL["conv3x3_f32_rel"], rel=True))
                else:
                    bar = TOL["bf16"] * max(1.0, want.float().abs().max().item())
                    errs["conv3x3"] = max(errs["conv3x3"],
                                          compare(name, got, want, bar))
                    times[("conv3x3", name)] = (
                        cuda_time_ms(lambda: conv3x3(x, w, s, bi, d, True)),
                        cuda_time_ms(lambda: conv3x3_ref(x, w, s, bi, d, True)))

        log("[kernels] K3 gather_bilinear (N, C, H, W) at a smooth flow grid")
        for n, c, hw, modes in ((4, 3, 512, ("zeros", "border")),
                                (8, 256, 64, ("zeros",))):
            img = torch.rand((n, c, hw, hw), generator=gen, device=dev)
            grid = _smooth_grid(n, hw, hw, gen, dev)
            gx = unnormalize(grid[..., 0], hw)
            gy = unnormalize(grid[..., 1], hw)
            oor = ((gx < 0) | (gx > hw - 1)).float().mean().item()
            for mode in modes:
                got = gather_bilinear(img, gx, gy, mode)
                want = gather_bilinear_ref(img, gx, gy, mode)
                case = f"({n}, {c}, {hw}, {hw}) {mode}"
                errs["gather_bilinear"] = max(errs["gather_bilinear"], compare(
                    f"{case} (out of range {oor:.1%})", got, want,
                    TOL["gather_f32"]))
                times[("gather_bilinear", case)] = (
                    cuda_time_ms(lambda: gather_bilinear(img, gx, gy, mode)),
                    cuda_time_ms(lambda: gather_bilinear_ref(img, gx, gy, mode)))

    log(f"[kernels] times, CUDA events, warm, mean of 20 launches "
        f"({state['label']}):")
    for (name, case), (ms, plain) in times.items():
        log(f"  {name} {case}: kernel {ms:.4f} ms, plain twin {plain:.4f} ms "
            f"({plain / ms:.2f}x)")
    state["kernel_errs"] = errs
    state["kernel_times"] = times


# ---------------------------------------------------------------- phases 3-4
def _page(b: int, h: int, w: int, gen: torch.Generator) -> torch.Tensor:
    """Synthetic document photos (B, H, W, 3) in [0, 1]: a light page with
    dark, slightly tilted text lines on a darker background."""
    yy, xx = torch.meshgrid(torch.linspace(0, 1, h), torch.linspace(0, 1, w),
                            indexing="ij")
    tilt = torch.rand((b, 1, 1), generator=gen) * 0.1 - 0.05
    lines = torch.sin((yy + tilt * xx) * 60.0) > 0.8
    page = (xx > 0.08) & (xx < 0.92) & (yy > 0.06) & (yy < 0.94)
    img = 0.25 + 0.55 * page.float() - 0.45 * (lines & page).float()
    noise = 0.03 * torch.randn((b, h, w, 3), generator=gen)
    return (img[..., None] + noise).clamp(0, 1)


def _kernel_fns():
    from dvd_tpu_torch.ops.kernels.attention import attention
    from dvd_tpu_torch.ops.kernels.conv3x3 import conv3x3
    from dvd_tpu_torch.ops.kernels.grid_sample import gather_bilinear

    return {"attention": attention, "conv3x3": conv3x3,
            "gather_bilinear": gather_bilinear}


def reset_launches() -> None:
    for fn in _kernel_fns().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in _kernel_fns().items()}


def _mask_logit_shift(pipe, source512: torch.Tensor,
                      margin_logit: float = 0.3) -> float:
    """Bias shift for Seg's U2NetP ``outconv`` that puts every soft-mask
    pixel at sigmoid >= sigmoid(margin_logit): with random weights a pixel
    near the hard 0.5 threshold could flip between the card and the CPU."""
    d0 = _soft_mask(pipe, source512).double().clamp(1e-7, 1 - 1e-7)
    return margin_logit - torch.log(d0 / (1 - d0)).min().item()


def _soft_mask(pipe, source512: torch.Tensor) -> torch.Tensor:
    from dvd_tpu_torch.ops.resize import resize_bilinear

    per = pipe.cfg.model.perception_size
    x = source512.to(pipe.device).permute(0, 3, 1, 2)
    with torch.inference_mode():
        x = resize_bilinear(x, (per, per), True).to(pipe.dtype).contiguous()
        return pipe.seg.msk(x)[0].float().cpu()


def phase_slice32(state):
    from dvd_tpu_torch.config import default_config
    from dvd_tpu_torch.evaluation.pipeline import DewarpPipeline, unwarp_fixed

    cfg = default_config().replace(model={"compute_dtype": "float32"},
                                   diffusion={"n_batch": 2})
    m = cfg.model
    gen = torch.Generator().manual_seed(SEED + 1)
    src = _page(1, m.source_size, m.source_size, gen)
    noise = torch.randn((cfg.diffusion.n_batch, m.image_size, m.image_size, 2),
                        generator=gen)
    # one weight set (drawn on the CPU from one seed), on both devices
    pipes = {dev: DewarpPipeline.create(
        cfg, dev, generator=torch.Generator().manual_seed(SEED + 2))
        for dev in ("cpu", "cuda")}
    for pipe in pipes.values():
        # a small final projection keeps the flow inside the [-1, 1] clamp,
        # so the comparison below sees it rather than the clamp
        with torch.no_grad():
            pipe.dit.final_layer2.linear.weight.mul_(0.1)
    shift = _mask_logit_shift(pipes["cpu"], src)
    runs = {}
    for dev in ("cuda", "cpu"):
        pipe = pipes[dev]
        with torch.no_grad():
            pipe.seg.msk.outconv.bias += shift
        margin = (_soft_mask(pipe, src) - 0.5).abs().min().item()
        if margin <= 0.05:
            raise AssertionError(f"{dev}: soft-mask margin {margin:.3f} <= 0.05")
        if dev == "cuda":
            torch.cuda.synchronize()
            reset_launches()
        t0 = time.perf_counter()
        flow = pipe.dewarp_flow(src.to(dev), init_noise=noise.to(dev))
        image = unwarp_fixed(src.to(dev), flow)
        if dev == "cuda":
            torch.cuda.synchronize()
            counts = read_launches()
        runs[dev] = (flow.cpu(), image.cpu())
        log(f"[slice32] {dev}: {m.dit_variant} {m.compute_dtype} batch 1, "
            f"{m.source_size}^2, {cfg.diffusion.diffusion_steps} steps x "
            f"{cfg.diffusion.n_batch} "
            f"hypotheses in {time.perf_counter() - t0:.2f} s (outconv bias "
            f"shift {shift:+.3f}, soft-mask margin {margin:.3f})")
    del pipes
    log(f"[slice32] kernel launches in the card run: {counts}")
    if min(counts.values()) <= 0:
        raise AssertionError(f"a kernel of the path did not launch: {counts}")
    (fc, ic), (fp, ip) = runs["cuda"], runs["cpu"]
    if not (torch.isfinite(fc).all() and fc.abs().max() <= 1):
        raise AssertionError("card flow not finite or outside [-1, 1]")
    log(f"[slice32] flow |max| {fc.abs().max().item():.4f}, mean |flow| "
        f"{fc.abs().mean().item():.4f}, clamped at +-1: "
        f"{(fc.abs() >= 1).float().mean().item():.2%}")
    compare("flow card vs CPU", fc, fp, TOL["slice_flow"])
    compare("unwarped image card vs CPU", ic, ip, TOL["slice_image"])


def phase_shipped(state):
    from dvd_tpu_torch.cli.run_sampling import dewarp_image
    from dvd_tpu_torch.config import default_config
    from dvd_tpu_torch.evaluation.pipeline import DewarpPipeline, unwarp_fixed

    cfg = default_config()
    m, d = cfg.model, cfg.diffusion
    batch = cfg.data.eval_device_batch
    pipe = DewarpPipeline.create(
        cfg, "cuda", generator=torch.Generator().manual_seed(SEED + 3))
    gen = torch.Generator().manual_seed(SEED + 4)
    src = _page(batch, m.source_size, m.source_size, gen).cuda()
    cuda_gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    log(f"[shipped] {m.dit_variant} {m.compute_dtype} quantize={m.quantize} "
        f"batch {batch}, {m.source_size}^2, {d.diffusion_steps} DDIM steps x "
        f"{d.n_batch} hypotheses ({state['label']})")

    # the main path, once, counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    flow = pipe.dewarp_flow(src, generator=cuda_gen)
    out = unwarp_fixed(src, flow)
    torch.cuda.synchronize()
    state["launches"] = read_launches()
    log(f"[shipped] kernel launches in one main-path run: {state['launches']}")
    if min(state["launches"].values()) <= 0:
        raise AssertionError(f"a kernel of the path did not launch: "
                             f"{state['launches']}")
    if flow.shape != (batch, m.image_size, m.image_size, 2) \
            or out.shape != src.shape:
        raise AssertionError(f"shapes flow {tuple(flow.shape)} "
                             f"out {tuple(out.shape)}")
    if not (torch.isfinite(flow).all() and torch.isfinite(out).all()
            and flow.abs().max() <= 1):
        raise AssertionError("shipped outputs not finite / flow outside [-1, 1]")
    log(f"[shipped] flow |max| {flow.abs().max().item():.4f}; unwarped "
        f"image range [{out.min().item():.3f}, {out.max().item():.3f}]")

    # warm timing, stage by stage (host clock around synchronised work)
    iters = 5
    stage = {"conditioning": 0.0, "sampling": 0.0, "unwarp": 0.0}
    with torch.inference_mode():
        for _ in range(iters):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cond, init_flow, init_feat = pipe.build_conditioning(src)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            flow = pipe.sampling_impl(cond, init_flow, init_feat, cuda_gen)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            unwarp_fixed(src, flow)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            stage["conditioning"] += (t1 - t0) / iters
            stage["sampling"] += (t2 - t1) / iters
            stage["unwarp"] += (t3 - t2) / iters
    total = sum(stage.values())
    state["imgs_per_sec"] = batch / total
    log(f"[shipped] {batch / total:.2f} imgs/s at batch {batch} "
        f"({total * 1e3:.1f} ms per batch, mean of {iters} warm runs; "
        f"{state['label']})")
    for k, v in stage.items():
        log(f"[shipped]   {k}: {v * 1e3:.2f} ms per batch, "
            f"{v * 1e3 / batch:.2f} ms/img ({state['label']})")
    log(f"[shipped] peak device memory of the shipped runs "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    _profile(pipe, src, cuda_gen, state["label"])

    # the CLI's array function on a 600x450 page (the unwarp runs K3 at a
    # size the TPU kernel's gate rejects)
    page = (_page(1, 450, 600, gen)[0] * 255).round().numpy()
    before = read_launches()["gather_bilinear"]
    t0 = time.perf_counter()
    out_img, out_flow = dewarp_image(pipe, page, seed=SEED)
    torch.cuda.synchronize()
    if out_img.shape != (450, 600, 3) or out_flow.shape != (m.image_size, m.image_size, 2) \
            or not np.isfinite(out_img).all() or np.abs(out_flow).max() > 1:
        raise AssertionError("CLI outputs malformed")
    if read_launches()["gather_bilinear"] <= before:
        raise AssertionError("the CLI unwarp did not launch K3")
    log(f"[shipped] cli dewarp_image 600x450 page: {out_img.shape} in "
        f"{time.perf_counter() - t0:.3f} s, K3 launched "
        f"{read_launches()['gather_bilinear'] - before}x")


def _profile(pipe, src, gen, label, top=25):
    """One warm main-path run under torch.profiler: device time by kernel
    and the device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    from dvd_tpu_torch.evaluation.pipeline import unwarp_fixed

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        unwarp_fixed(src, pipe.dewarp_flow(src, generator=gen))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    from torch.autograd import DeviceType

    # kernel (device-side) events only: an aten op's own device time repeats
    # the kernels it launched
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if not rows:
        raise RuntimeError("the profiler recorded no device time")
    busy = sum(r[1] for r in rows) / 1e3
    log(f"[profile] one main-path run: wall {wall * 1e3:.1f} ms (profiled), "
        f"device busy {busy:.1f} ms ({busy / (wall * 1e3):.1%}); {label}")
    for key, us, n in sorted(rows, key=lambda r: -r[1])[:top]:
        log(f"[profile]   {us / 1e3:9.3f} ms {us / 1e3 / busy:6.1%} x{n:<5d} "
            f"{key[:110]}")


# ---------------------------------------------------------------- main
def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on a GPU only")
    state: dict = {}
    for phase in (phase_env, phase_kernels, phase_slice32, phase_shipped):
        phase(state)
    kernels = []
    for name, (src, replaces) in KERNELS.items():
        ms, plain = state["kernel_times"][(name, RECORD_CASE[name])]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": state["launches"][name],
            "max_abs_err": state["kernel_errs"][name],
            "ms": ms, "plain_ms": plain,
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
