#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``dvd_tpu_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its lines; a failing phase raises and the script
exits non-zero -- nothing is caught):

1. env      the card's name and power limit, torch/CUDA versions, the TF32
            settings; builds the kernels from ``dvd_tpu_torch/csrc`` for
            sm_90a and prints nvcc's ``-Xptxas -v`` report.
2. kernels  each hand-written kernel (K1-K4) against its plain PyTorch twin
            on the card at the serving and training paths' shapes, f32 and
            bf16, with the stated tolerances; the autograd Functions
            (attention, the trainable conv, warp_const_src) against the
            autograd of the plain versions; then each kernel's time beside
            its twin's, one PyTorch library call's and its bound.
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
5. train32  one f32 train step of the shipped training config at full
            DiT-S/2 width, batch 2, 512^2: its loss and every gradient on
            the card through the kernels (K1-K4 launch counts must all be
            > 0) against the CPU through the twins, same weights (the
            zero-initialised layers drawn small), batch, t and noise,
            dropout off.
6. train    the shipped training config (bf16 compute, f32 parameters,
            batch 10, 512^2, time-variant loss with its rollout) through
            ``training.train_loop.train`` on seeded synthetic float-wire
            batches: samples/s over 15 warm steps timed end to end, ms
            per step by stage over 4 more (each stage synchronised),
            loss, parameters and EMA moved, launches per step, peak
            memory, and one profiled step (device time by kernel, the
            device's busy share).

The line before the last is the per-kernel JSON record (launches from the
training run, which drives all four kernels); the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device the script
raises before printing any result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 0

# tolerances (max abs error unless stated), kernel vs its twin on the card
TOL = {
    "attention_f32": 1e-4,     # unit-scale inputs
    "conv3x3_f32_rel": 1e-4,   # max|err| / max|ref|
    "gather_f32": 1e-5,
    "gather_grad_f32": 1e-5,   # x max(1, max|ref|)
    "function_f32": 1e-4,      # Function gradients, x max(1, max|ref|)
    "bf16": 2e-2,              # x max(1, max|ref|), same bf16 inputs
    "slice_flow": 1e-3,        # f32 slice, card vs CPU
    "slice_image": 1e-3,       # unwarped image in [0, 1]
    "train_loss_rel": 1e-4,    # f32 train step, card vs CPU, relative
    "train_grad": 1e-3,        # every gradient, x max(1, max|g|)
}

# the card's published peaks (NVIDIA H100 SXM data sheet, dense): the
# bound of a kernel is max(bytes / rate, operations / peak of their type)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# the case whose time goes into the per-kernel JSON record: the serving
# path's heaviest shape for each kernel, in the shipped dtype
RECORD_CASE = {
    "attention": "(8, 6, 1024, 256) scale 0.0625 bfloat16",
    "conv3x3": "256->256 @128^2 d1 b4 bfloat16",
    "gather_bilinear": "(4, 3, 512, 512) zeros",
    "gather_bilinear_grad": "(10, 2, 512, 512) zeros",
}

KERNELS = {
    # name -> (source, replaced TPU kernel)
    "attention": ("dvd_tpu_torch/csrc/attention.cu",
                  "dvd_tpu/ops/pallas/attention.py:49"),
    "conv3x3": ("dvd_tpu_torch/csrc/conv3x3.cu",
                "dvd_tpu/ops/pallas/planar_conv.py:247"),
    "gather_bilinear": ("dvd_tpu_torch/csrc/grid_sample.cu",
                        "dvd_tpu/ops/pallas/grid_sample.py:122"),
    "gather_bilinear_grad": ("dvd_tpu_torch/csrc/grid_sample.cu",
                             "dvd_tpu/ops/pallas/grid_sample.py:253"),
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
                          r"gather_bilinear_grad_kernel|"
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
        for cot in (16, 32) for d in (1, 2, 4, 8))
        + "; gather_bilinear_kernel 0; gather_bilinear_grad_kernel 0")


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


def _record(times, name, case, fn, plain, library, nbytes, flops, dtype):
    """Time ``fn`` (the kernel), ``plain`` (its twin) and ``library`` (one
    PyTorch call computing the same function, or None) and keep them
    beside the bound reckoned from the case's bytes and operations."""
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops = flops / PEAK_FLOPS[dtype] * 1e3
    times[(name, case)] = dict(
        ms=cuda_time_ms(fn), plain_ms=cuda_time_ms(plain),
        library_ms=cuda_time_ms(library) if library else None,
        bound_ms=max(bound_bytes, bound_ops),
        bound_by="bytes" if bound_bytes >= bound_ops else "operations")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _grads_vs(name, fn, ref, inputs, ct, bar_rel):
    """fn's output and the gradients of sum(fn(*inputs) * ct) against
    ref's, each within ``bar_rel * max(1, max|ref's|)``; returns the
    output's max abs error (the kernel's, as the path runs it) and the
    gradients' largest."""
    a = [x.detach().clone().requires_grad_() for x in inputs]
    b = [x.detach().clone().requires_grad_() for x in inputs]
    out_a, out_b = fn(*a), ref(*b)
    bar = bar_rel * max(1.0, out_b.detach().float().abs().max().item())
    err_out = compare(f"{name} forward", out_a.detach(), out_b.detach(), bar)
    torch.autograd.backward(out_a, ct)
    torch.autograd.backward(out_b, ct)
    err = 0.0
    for i, (ga, gb) in enumerate(zip(a, b)):
        bar = bar_rel * max(1.0, gb.grad.float().abs().max().item())
        err = max(err, compare(f"{name} d/dinput{i}", ga.grad, gb.grad, bar))
    return err_out, err


def phase_kernels(state):
    import torch.nn.functional as F

    from dvd_tpu_torch.ops.grid_sample import unnormalize, warp_const_src
    from dvd_tpu_torch.ops.kernels.attention import attention, attention_ref
    from dvd_tpu_torch.ops.kernels.conv3x3 import (conv3x3, conv3x3_ref,
                                                   conv3x3_trainable)
    from dvd_tpu_torch.ops.kernels.grid_sample import (
        gather_bilinear, gather_bilinear_grad, gather_bilinear_grad_ref,
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
                    b, h, tq, dh = shape
                    _record(times, "attention", case,
                            lambda: attention(q, k, v, scale),
                            lambda: attention_ref(q, k, v, scale),
                            lambda: F.scaled_dot_product_attention(
                                q, k, v, scale=scale),
                            _nbytes(q, k, v, got), 4 * b * h * tq * tq * dh, dt)

        log("[kernels] K2 conv3x3 (B, Cin, H, W) -> Cout, dilation")
        # serving's batch 4, then the frozen aux nets' shapes at the
        # training batch (the pyramid's are the Function's, below)
        for b, cin, cout, hw, d in ((4, 3, 16, 288, 1), (4, 64, 16, 9, 8),
                                    (4, 4, 64, 512, 1), (4, 256, 256, 128, 1),
                                    (4, 1024, 512, 36, 1), (4, 64, 1, 288, 1),
                                    (10, 3, 16, 288, 1), (10, 64, 16, 9, 8),
                                    (10, 64, 1, 288, 1)):
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
                    bl = bi.to(dt)
                    _record(times, "conv3x3", name,
                            lambda: conv3x3(x, w, s, bi, d, True),
                            lambda: conv3x3_ref(x, w, s, bi, d, True),
                            lambda: F.conv2d(x, w, bl, 1, d, d),
                            _nbytes(x, w, s, bi, got),
                            2 * b * cout * cin * 9 * hw * hw, dt)

        log("[kernels] K3 gather_bilinear (N, C, H, W) at a smooth flow grid")
        # the serving unwarp and re-warp, then the training loss's warp and
        # the rollout's re-warps at batch 10
        for n, c, hw, modes in ((4, 3, 512, ("zeros", "border")),
                                (8, 256, 64, ("zeros",)),
                                (10, 2, 512, ("zeros",)),
                                (10, 256, 64, ("zeros",))):
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
                _record(times, "gather_bilinear", case,
                        lambda: gather_bilinear(img, gx, gy, mode),
                        lambda: gather_bilinear_ref(img, gx, gy, mode),
                        lambda: F.grid_sample(img, grid, mode="bilinear",
                                              padding_mode=mode,
                                              align_corners=True),
                        _nbytes(img, gx, gy, got), n * hw * hw * (8 * c + 12),
                        torch.float32)

        log("[kernels] K4 gather_bilinear_grad (N, C, H, W): d/d(gx, gy) of "
            "sum_c ct_c * sample_c, the training loss's backward")
        n, c, hw = 10, 2, 512
        img = torch.rand((n, c, hw, hw), generator=gen, device=dev)
        grid = _smooth_grid(n, hw, hw, gen, dev)
        gx = unnormalize(grid[..., 0], hw)
        gy = unnormalize(grid[..., 1], hw)
        ct = torch.randn((n, c, hw, hw), generator=gen, device=dev)
        oor = ((gx < 0) | (gx > hw - 1)).float().mean().item()
        for mode in ("zeros", "border"):
            got = gather_bilinear_grad(img, gx, gy, ct, mode)
            want = gather_bilinear_grad_ref(img, gx, gy, ct, mode)
            case = f"({n}, {c}, {hw}, {hw}) {mode}"
            for axis, g, wnt in zip("xy", got, want):
                bar = TOL["gather_grad_f32"] * max(1.0, wnt.abs().max().item())
                errs["gather_bilinear_grad"] = max(
                    errs["gather_bilinear_grad"],
                    compare(f"{case} d/dg{axis} (out of range {oor:.1%})", g,
                            wnt, bar))
            pad = {"zeros": 0, "border": 1}[mode]
            _record(times, "gather_bilinear_grad", case,
                    lambda: gather_bilinear_grad(img, gx, gy, ct, mode),
                    lambda: gather_bilinear_grad_ref(img, gx, gy, ct, mode),
                    lambda: torch.ops.aten.grid_sampler_2d_backward(
                        ct, img, grid, 0, pad, True, [False, True]),
                    _nbytes(img, gx, gy, ct, *got), n * hw * hw * (16 * c + 20),
                    torch.float32)

    log("[kernels] autograd Functions against the autograd of the plain "
        "versions, at the training path's shapes (batch 10): the forward "
        "(the kernel) and every input's gradient")
    for shape, scale in (((10, 6, 1024, 64), 1 / 8), ((10, 6, 1024, 256), 1 / 16)):
        for dt in (torch.float32, bf16):
            q, k, v = _qkv(*shape, dt, gen, dev)
            ct = torch.randn(shape, generator=gen, device=dev).to(dt)
            bar = TOL["function_f32"] if dt == torch.float32 else TOL["bf16"]
            err, _ = _grads_vs(f"attention {shape} {str(dt)[6:]}",
                               lambda *a: attention(*a, scale),
                               lambda *a: attention_ref(*a, scale),
                               (q, k, v), ct, bar)
            errs["attention"] = max(errs["attention"], err)
    for b, cin, cout, hw in ((10, 4, 64, 512), (10, 256, 256, 128)):
        for dt in (torch.float32, bf16):
            x = torch.randn((b, cin, hw, hw), generator=gen, device=dev).to(dt)
            w = torch.randn((cout, cin, 3, 3), generator=gen, device=dev) \
                / math.sqrt(9 * cin)
            bi = 0.1 * torch.randn((cout,), generator=gen, device=dev)
            ct = torch.randn((b, cout, hw, hw), generator=gen, device=dev).to(dt)
            bar = TOL["function_f32"] if dt == torch.float32 else TOL["bf16"]
            # without the ReLU: its mask flips where the kernel's and
            # cuDNN's outputs straddle zero, a kink and not an error (the
            # CPU tests check the masked backward, where the forwards agree)
            err, _ = _grads_vs(
                f"conv3x3_trainable {cin}->{cout} @{hw}^2 b{b} {str(dt)[6:]}",
                lambda xx, ww, bb: conv3x3_trainable(xx, ww, bb, 1, False),
                lambda xx, ww, bb: conv3x3_ref(
                    xx, ww, torch.ones_like(bb), bb, 1, False),
                (x, w, bi), ct, bar)
            errs["conv3x3"] = max(errs["conv3x3"], err)
    n, hw = 10, 512
    src = torch.rand((n, 2, hw, hw), generator=gen, device=dev)
    grid = _smooth_grid(n, hw, hw, gen, dev)
    ct = torch.randn((n, 2, hw, hw), generator=gen, device=dev)

    def warp_plain(img, g):
        return gather_bilinear_ref(img.detach(), unnormalize(g[..., 0], hw),
                                   unnormalize(g[..., 1], hw), "zeros")

    err, _ = _grads_vs(f"warp_const_src ({n}, 2, {hw}, {hw})",
                       lambda g: warp_const_src(src, g),
                       lambda g: warp_plain(src, g), (grid,), ct,
                       TOL["function_f32"])
    errs["gather_bilinear"] = max(errs["gather_bilinear"], err)

    log(f"[kernels] times, CUDA events, warm, mean of 20 launches "
        f"({state['label']}); bound = max(bytes / 3.35 TB/s, operations / "
        f"peak of their type), library = one PyTorch call, never used by "
        f"the port:")
    for (name, case), r in times.items():
        lib = f"{r['library_ms']:.4f} ms" if r["library_ms"] else "none"
        log(f"  {name} {case}: kernel {r['ms']:.4f} ms, plain twin "
            f"{r['plain_ms']:.4f} ms ({r['plain_ms'] / r['ms']:.2f}x), "
            f"library {lib}, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
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


# the serving path runs K1-K3 (K4 is the training loss's backward); one
# shipped main-path run launches them exactly this often
SERVE_LAUNCHES = {"attention": 42, "conv3x3": 261, "gather_bilinear": 3,
                  "gather_bilinear_grad": 0}


def _kernel_fns():
    from dvd_tpu_torch.ops.kernels.attention import attention
    from dvd_tpu_torch.ops.kernels.conv3x3 import conv3x3
    from dvd_tpu_torch.ops.kernels.grid_sample import (gather_bilinear,
                                                       gather_bilinear_grad)

    return {"attention": attention, "conv3x3": conv3x3,
            "gather_bilinear": gather_bilinear,
            "gather_bilinear_grad": gather_bilinear_grad}


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
    if min(counts[k] for k in SERVE_LAUNCHES if SERVE_LAUNCHES[k]) <= 0:
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
    state["serve_launches"] = read_launches()
    log(f"[shipped] kernel launches in one main-path run: "
        f"{state['serve_launches']}")
    if state["serve_launches"] != SERVE_LAUNCHES:
        raise AssertionError(f"serving launches {state['serve_launches']}, "
                             f"expected {SERVE_LAUNCHES}")
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
    rows = _profile_rows(prof)
    busy = sum(r[1] for r in rows) / 1e3
    log(f"[profile] one main-path run: wall {wall * 1e3:.1f} ms (profiled), "
        f"device busy {busy:.1f} ms ({busy / (wall * 1e3):.1%}); {label}")
    for key, us, n in rows[:top]:
        log(f"[profile]   {us / 1e3:9.3f} ms {us / 1e3 / busy:6.1%} x{n:<5d} "
            f"{key[:110]}")


# ---------------------------------------------------------------- phases 5-6
def _wire_batch(b: int, gen: torch.Generator) -> dict:
    """A seeded synthetic float-wire batch (CPU tensors): document photos
    with their page mask, and smooth absolute flows (pixels) for the GT
    and the intermediate backward maps."""
    hw = 512
    src = _page(b, hw, hw, gen)
    yy, xx = torch.meshgrid(torch.linspace(0, 1, hw), torch.linspace(0, 1, hw),
                            indexing="ij")
    page = ((xx > 0.08) & (xx < 0.92) & (yy > 0.06) & (yy < 0.94)).float()

    def flow(amp):
        a = torch.randn((b, 2, 3), generator=gen) * amp
        f = torch.rand((b, 2, 3, 3), generator=gen) * 3
        out = sum(a[..., i, None, None] * torch.sin(
            2 * math.pi * (f[..., i, 0, None, None] * xx
                           + f[..., i, 1, None, None] * yy
                           + f[..., i, 2, None, None])) for i in range(3))
        return out.permute(0, 2, 3, 1).contiguous()

    return {"source_image": src,
            "doc_mask": page[None, ..., None].expand(b, hw, hw, 1).contiguous(),
            "flow_map": flow(12.0), "flow_map_inter": flow(6.0)}


def _no_dropout(net) -> None:
    for m in net.modules():
        if isinstance(getattr(m, "dropout", None), float):
            m.dropout = 0.0


@torch.no_grad()
def _fill_zero_layers(dit, seed: int, std: float = 0.02) -> None:
    """Draw the DiT's zero-initialised adaLN and final layers from N(0,
    std^2) (on the CPU, so both devices get the same values): from the
    training init they are zero, and the gradients would then reach
    little beyond them."""
    from dvd_tpu_torch.models.layers import ZERO_INIT_LAYERS

    gen = torch.Generator().manual_seed(seed)
    for name, p in dit.named_parameters():
        if any(z in name for z in ZERO_INIT_LAYERS):
            p.copy_(std * torch.randn(p.shape, generator=gen))


def phase_train32(state):
    from dvd_tpu_torch.config import default_config
    from dvd_tpu_torch.evaluation.pipeline import DewarpPipeline
    from dvd_tpu_torch.training.train_loop import build_device_batch
    from dvd_tpu_torch.training.train_state import (create_train_state,
                                                    make_train_step)

    cfg = default_config().replace(model={"compute_dtype": "float32"},
                                   train={"on_device_aug": False})
    m = cfg.model
    b = 2
    gen = torch.Generator().manual_seed(SEED + 6)
    raw = _wire_batch(b, gen)
    t = torch.tensor([0, cfg.diffusion.diffusion_steps - 1])
    noise = torch.randn((b, m.image_size, m.image_size, 2), generator=gen)
    rollout_noise = torch.randn(noise.shape, generator=gen)
    pipes = {dev: DewarpPipeline.create(
        cfg, dev, generator=torch.Generator().manual_seed(SEED + 7), train=True)
        for dev in ("cpu", "cuda")}
    shift = _mask_logit_shift(pipes["cpu"], raw["source_image"])
    runs = {}
    for dev in ("cuda", "cpu"):
        pipe = pipes[dev]
        _no_dropout(pipe.dit)
        _fill_zero_layers(pipe.dit, SEED + 9)
        with torch.no_grad():
            pipe.seg.msk.outconv.bias += shift
        margin = (_soft_mask(pipe, raw["source_image"]) - 0.5).abs().min().item()
        if margin <= 0.05:
            raise AssertionError(f"{dev}: soft-mask margin {margin:.3f} <= 0.05")
        train_state = create_train_state(cfg, pipe.dit)
        step = make_train_step(cfg, pipe.sched)
        if dev == "cuda":
            torch.cuda.synchronize()
            reset_launches()
        t0 = time.perf_counter()
        batch = build_device_batch(
            pipe, {k: v.to(dev) for k, v in raw.items()}, m.image_size)
        grads, _, metrics = step.loss_and_grads(
            train_state, batch, None, t=t, noise=noise,
            rollout_noise=rollout_noise)
        if dev == "cuda":
            torch.cuda.synchronize()
            counts = read_launches()
        names = list(train_state.named_params())
        runs[dev] = (metrics["loss"].item(),
                     {k: g.detach().cpu() for k, g in zip(names, grads)})
        log(f"[train32] {dev}: {m.dit_variant} float32 batch {b}, 512^2, "
            f"t={t.tolist()}, loss and gradients in "
            f"{time.perf_counter() - t0:.2f} s (outconv bias shift "
            f"{shift:+.3f}, soft-mask margin {margin:.3f})")
    del pipes
    log(f"[train32] kernel launches in the card run: {counts}")
    if min(counts.values()) <= 0:
        raise AssertionError(f"a kernel of the path did not launch: {counts}")
    (lc, gc), (lp, gp) = runs["cuda"], runs["cpu"]
    rel = abs(lc - lp) / max(abs(lp), 1e-30)
    log(f"[train32] loss card {lc:.8f} CPU {lp:.8f}: relative "
        f"{rel:.3e} (bar {TOL['train_loss_rel']:.0e}) "
        f"{'ok' if rel <= TOL['train_loss_rel'] else 'FAIL'}")
    if not (math.isfinite(lc) and rel <= TOL["train_loss_rel"]):
        raise AssertionError(f"train32 loss: card {lc} vs CPU {lp}")
    worst = (0.0, "")
    for k, want in gp.items():
        bar = TOL["train_grad"] * max(1.0, want.abs().max().item())
        err = (gc[k] - want).abs().max().item()
        if not (math.isfinite(err) and err <= bar):
            raise AssertionError(f"train32 gradient {k}: {err:.3e} > {bar:.3e}")
        worst = max(worst, (err / bar, k))
    nz = sum(int(g.abs().max() > 0) for g in gp.values())
    log(f"[train32] {len(gp)} gradient tensors ({nz} nonzero) within "
        f"{TOL['train_grad']:.0e} x max(1, max|g|); the closest to its bar: "
        f"{worst[1]} at {worst[0]:.3f} of it")


class StageSpans:
    """Times ``train()``'s steps through its stage spans ("prep", then
    "loss_backward" around "rollout", then "optimizer_ema").

    Steps [0, warm) warm up.  Steps [warm, warm + measured) are timed end
    to end: one device synchronise before the first and one after the
    last, none between, so the window holds all that ``train()`` does in
    them (data, batch prep, the step, logging).  Each of the next
    ``staged`` steps ends every stage with a synchronise, for the split by
    stage.  The step after them runs under torch.profiler."""

    def __init__(self, warm: int, measured: int, staged: int):
        self.warm, self.measured, self.staged = warm, measured, staged
        self.profile_step = warm + measured + staged
        self.step = 0
        self.times: dict = {}
        self.window = None
        self.prof = None
        self.wall = None

    def __call__(self, name):
        import contextlib

        @contextlib.contextmanager
        def span():
            s = self.step
            staged = self.warm + self.measured <= s < self.profile_step
            if name == "prep" and s == self.warm:
                torch.cuda.synchronize()
                self.window = time.perf_counter()
            if name == "prep" and s == self.profile_step:
                from torch.profiler import ProfilerActivity, profile
                torch.cuda.synchronize()
                self.prof = profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA])
                self.prof.__enter__()
                self.wall = time.perf_counter()
            if staged:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            yield
            if staged:
                torch.cuda.synchronize()
                self.times.setdefault(name, []).append(time.perf_counter() - t0)
            if name == "optimizer_ema":
                if s == self.warm + self.measured - 1:
                    torch.cuda.synchronize()
                    self.window = time.perf_counter() - self.window
                if s == self.profile_step:
                    torch.cuda.synchronize()
                    self.wall = time.perf_counter() - self.wall
                    self.prof.__exit__(None, None, None)
                self.step += 1
        return span()


def _profile_rows(prof):
    """(name, device us, count) of the kernels a profile recorded, largest
    first.  Kernel (device-side) events only: an aten op's own device time
    repeats the kernels it launched, and a user annotation's (the
    optimizer's step) spans the kernels inside it."""
    from torch.autograd import DeviceType

    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]
    if not rows:
        raise RuntimeError("the profiler recorded no device time")
    return sorted(rows, key=lambda r: -r[1])


def phase_train(state):
    from dvd_tpu_torch.config import default_config
    from dvd_tpu_torch.evaluation.pipeline import DewarpPipeline
    from dvd_tpu_torch.training.train_loop import train
    from dvd_tpu_torch.utils.logger import KVLogger

    spans = StageSpans(warm=2, measured=15, staged=4)
    steps = spans.profile_step + 1
    with tempfile.TemporaryDirectory() as ws:
        # the shipped config, but for the float wire and no checkpoint
        # before the final one (log_interval stays 20: steps 0 and 20 log)
        cfg = default_config().replace(
            train={"on_device_aug": False, "save_interval": 10 ** 9},
            paths={"workspace_dir": ws})
        m, b = cfg.model, cfg.train.batch_size
        gen = torch.Generator().manual_seed(SEED + 8)
        batches = [_wire_batch(b, gen) for _ in range(2)]
        data = (batches[i % 2] for i in range(steps))
        init = DewarpPipeline.create(
            cfg, "cpu", generator=torch.Generator().manual_seed(cfg.train.seed),
            train=True).dit.state_dict()

        class Losses(KVLogger):
            def dumpkvs(self, step=None):
                out = super().dumpkvs(step)
                self.rows.append(out)
                return out

        logger = Losses(None, formats=())
        logger.rows = []
        log(f"[train] {m.dit_variant} compute {m.compute_dtype}, params "
            f"{m.param_dtype}, batch {b}, {m.source_size}^2, time_variant="
            f"{m.time_variant} iter={m.iter}, {cfg.train.schedule_sampler} "
            f"sampler, AdamW lr {cfg.train.lr:g} clip {cfg.train.grad_clip:g} "
            f"EMA {cfg.train.ema_rate}; {steps} steps ({state['label']})")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        train_state = train(cfg, data, max_steps=steps, device="cuda",
                            logger=logger, spans=spans)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_launches()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        files = sorted(os.listdir(os.path.join(ws, cfg.name)))
    state["train_launches"] = counts
    if train_state.step != steps:
        raise AssertionError(f"train() took {train_state.step} steps")
    log(f"[train] train() ran {steps} steps in {wall:.2f} s (pipeline set-up "
        f"included) and wrote {files}")
    per_step = {k: v / steps for k, v in counts.items()}
    log(f"[train] kernel launches in the run: {counts}; per step {per_step}")
    if min(counts.values()) <= 0:
        raise AssertionError(f"a kernel of the path did not launch: {counts}")

    losses = [r["loss"] for r in logger.rows]
    norms = [r["grad_norm"] for r in logger.rows]
    log(f"[train] logged steps {[r['step'] for r in logger.rows]}: loss "
        f"{' '.join(f'{x:.5f}' for x in losses)}; grad norm "
        f"{' '.join(f'{x:.4f}' for x in norms)}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    params = dict(train_state.model.named_parameters())
    moved = max((params[k].detach().cpu() - init[k]).abs().max().item()
                for k in params)
    ema = train_state.ema_params[0]
    ema_moved = max((ema[k].cpu() - init[k]).abs().max().item() for k in ema)
    log(f"[train] max |param - init| {moved:.3e}, max |EMA - init| "
        f"{ema_moved:.3e}")
    if not (moved > 0 and 0 < ema_moved < moved):
        raise AssertionError("parameters or EMA did not move")

    step_s = spans.window / spans.measured
    log(f"[train] {b / step_s:.2f} samples/s ({step_s * 1e3:.1f} ms per step: "
        f"{spans.measured} warm steps of train() timed end to end, one "
        f"synchronise before and one after; {state['label']})")
    per = {k: sum(v) / len(v) for k, v in spans.times.items()}
    fwd_bwd = per["loss_backward"] - per["rollout"]
    staged_s = per["prep"] + per["loss_backward"] + per["optimizer_ema"]
    log(f"[train] by stage, mean of {spans.staged} further steps with every "
        f"stage ended by a synchronise: {staged_s * 1e3:.1f} ms per step "
        f"in all ({state['label']})")
    for name, ms in (("batch prep (H2D + frozen Seg/line-UNet)", per["prep"]),
                     ("rollout (2 model calls, no grad)", per["rollout"]),
                     ("pyramid + supervised forward + backward", fwd_bwd),
                     ("optimizer + EMA", per["optimizer_ema"])):
        log(f"[train]   {name}: {ms * 1e3:.2f} ms per step ({state['label']})")
    log(f"[train] peak device memory {peak:.2f} GiB ({state['label']})")
    state["train_samples_per_sec"] = b / step_s

    rows = _profile_rows(spans.prof)
    busy = sum(r[1] for r in rows) / 1e3
    log(f"[profile] one train step: wall {spans.wall * 1e3:.1f} ms "
        f"(profiled, unsynchronised), device busy {busy:.1f} ms "
        f"({busy / (spans.wall * 1e3):.1%}); {state['label']}")
    for key, us, n in rows[:25]:
        log(f"[profile]   {us / 1e3:9.3f} ms {us / 1e3 / busy:6.1%} x{n:<5d} "
            f"{key[:110]}")
    for name, entry in (("K1", "attention_fwd_kernel"), ("K2", "conv3x3_kernel"),
                        ("K3", "gather_bilinear_kernel"),
                        ("K4", "gather_bilinear_grad_kernel")):
        mine = [r for r in rows if entry + "<" in r[0]]
        ms = sum(r[1] for r in mine) / 1e3
        log(f"[profile] {name} {entry}: {ms:.3f} ms in {sum(r[2] for r in mine)} "
            f"launches, {ms / busy:.1%} of the step's device time")


# ---------------------------------------------------------------- main
def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on a GPU only")
    state: dict = {}
    for phase in (phase_env, phase_kernels, phase_slice32, phase_shipped,
                  phase_train32, phase_train):
        phase(state)
    kernels = []
    for name, (src, replaces) in KERNELS.items():
        r = state["kernel_times"][(name, RECORD_CASE[name])]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": state["train_launches"][name],
            "launches_serving": state["serve_launches"][name],
            "max_abs_err": state["kernel_errs"][name],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "case": RECORD_CASE[name],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
