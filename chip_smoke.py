#!/usr/bin/env python3
"""Check the PyTorch/CUDA port (``dvd_tpu_torch``) on one NVIDIA GPU, and
time its kernels alone.

    python3 chip_smoke.py

Each phase checks the card's results: against the CPU, the kernels' plain
twins or float64, and the kernels' launch counts and routes.  The kernels
are timed alone (phase 2, phase 4's and 4c's K2 shape classes, phase 2b's
int8 GEMM and its passes), each beside its twin, a library call and its
bound; the serving, dataset and training paths are timed by the
benchmark (``perfbench/``), not here.

Phases (each prints its lines; a failing phase raises and the script
exits non-zero -- nothing is caught):

1. env      the card's name and power limit, torch/CUDA versions, the TF32
            settings; builds the kernels from ``dvd_tpu_torch/csrc`` for
            sm_90a and prints nvcc's ``-Xptxas -v`` report (no instance
            of the four tensor-core kernels, K1's and K2's in bf16 and in
            f32, may spill), each kernel's dynamic shared memory (K2: its
            launch plan at one main-path shape per instance; K3: its
            channels and points per thread at each main-path shape) and
            the HGMMA count of the library's SASS (every instance of the
            four must have some).
2. kernels  each hand-written kernel (K1-K5) against its plain PyTorch twin
            on the card at the serving and training paths' shapes, f32 and
            bf16 (K1 and K2: f32 must take the split-product kernel, bf16
            the wgmma one; at the f32 record cases the kernel's and the
            twin's max error against float64, the kernel's within 4x the
            twin's or 2^-20 of max|ref|; K1 a ragged case, DiT-XL's
            head dim 72, zero-padded to 128, and GeoTr's (4, 8, 1296, 32)
            in both dtypes, also against float64; K1 at the alternative
            denoisers' (8, 4, 4096, 32), (8, 8, 1024, 32), (8, 4, 256, 96)
            (zero-padded to 128) and (8, 4, 64, 128) in both dtypes,
            against float64 and timed from Python and from CUDA graphs
            beside SDPA; K2 f32 at the VGG16
            pyramid's seven classes and bf16 at GeoTr's stride-1 classes,
            and in both dtypes at the UNet denoiser's 22 and GeoTr2's 5
            classes at batch 8,
            summed from CUDA graphs beside ``conv2d``; K2 bf16 at every
            shape class of the
            serving and training paths, batches 4 and 10; K3 through both
            entries at its six main-path shapes, the augmentation's warp
            of image + mask at (10, 4, 512, 512) among them; the fused
            unwarp at the dataset path's uint8 2048^2 batch and the
            serving path's f32 512^2 one; K4 on the grid, both modes),
            with the stated tolerances (K5 bit for bit, at the probe's
            case, an unwarp-scale case and two with MN % 4 != 0, one of
            them offset views, timed from Python and from a CUDA graph
            beside ``torch.take``); ``augment_batch`` on the
            card against the CPU (the same raw batch and jitter factors);
            the autograd Functions (attention, the trainable conv,
            warp_const_src) against the autograd of the plain versions;
            then each kernel's time beside its twin's, one PyTorch library
            call's (the fused unwarp, which no one call computes: the
            unfused path's) and its bound.
2b. int8   ``ops/quant.py:int8_dense`` on the card against the CPU at the
            serving path's int8 shapes (M 8192; the DiT block's K x N 384 x
            1152, 384 x 1536, 1536 x 384 and the decoder's 1536 x 1536,
            1536 x 2048, 2048 x 1536), bf16 and f32 activations: codes,
            scales and the int32 product equal bit for bit, the output
            bit for bit or within one rounding of its dtype; then
            ``torch._int_mm``, a bf16 ``torch.matmul`` of the same shape,
            the quantize pass, the rescale and the whole ``int8_dense``
            timed beside their bounds (int8 1979 TOP/s, 3.35 TB/s).
2c. adaln   the DiT's fused adaLN passes (``ops/kernels/adaln.py``:
            ``ln_modulate``, ``gate_residual``) in bf16 at the DiT cells'
            (8, 1024, 1152) and (8, 1024, 384) and the 'para' final
            layer's (8, 1024, 4608): one launch each, within one bf16
            unit of max|ref| of float32 math, then timed from Python and
            from a CUDA graph, each call on the next of sets of inputs
            and outputs that outsize the L2 five times, beside the plain
            twin (today's eager chain) and the bound by bytes.
3. slice32  the serving slice at full DiT-S/2 width and 512^2, batch 1, in
            f32: once on the card through the kernels (launch counts must
            all be > 0) and once on the CPU through the twins, with the
            same weights and the same pinned x_T; flow and unwarped image
            compared.
3c. flags32  slice32 (one hypothesis) under the production DiT's other
            conditioning configurations: GeoTr's init_flow with the VGG16
            conditioning, then the 'seq' and the 'one' cross-attention
            modes: card against CPU under slice32's bars, every K1 and K2
            launch on the f32 route, GeoTr's 24 K1 launches on the Dh 32
            instance, init_flow's range.
3d. alt32  the alternative denoisers (``stage_1`` UNet,
            ``stage_1_transformer``, ``stage_1_doctr`` GeoTr2, and GeoTr2
            under ``use_init_flow``) at the registry's full width, f32,
            batch 1, one hypothesis, 512^2, ``train_VGG=False``: card
            against CPU from one weight set (the zero-initialised layers
            drawn small) and one pinned x_T, flow within slice32's bar of
            max|ref| and the unwarped image within its bar; K1 counted by
            the caller's head dim (the UNet's Dh 96 on the padded route,
            Dh 128, Dh 32) and K2, each as the code counts them, every
            launch on the f32 route, no K3 re-warp (the families sample
            without the recurrent state, as ``dvd_tpu`` does).
3b. slice_int8  slice32 with ``quantize="int8"``: card against CPU, the
            int8 products counted (the code's count: each int8 layer of
            the live block once per stream and each of the decoder's once,
            per DDIM step); the CPU replays the card's int8 codes, and the
            codes that differ (by one step, where f32 rounding crossed a
            tie) are counted and must be rare; flow and image within
            slice32's bars.
4. shipped  the shipped config (bf16, batch 4, 3 DDIM steps x 2
            hypotheses) through ``DewarpPipeline.dewarp_flow`` +
            ``unwarp_fixed`` and through the single-image CLI function on a
            600x450 page; outputs checked, every K1 and K2 launch on the
            wgmma route, every K3 launch through its grid entry and the
            unwarp through the fused kernel, the flow against the same run
            with the models'
            attention bound to its plain twin (within twice the change the
            twin's own bf16 cast of p makes) and with K2 bound to its twin
            (within twice the change reversing the twin's input channels
            makes), and once more under torch's default TF32 switches (the
            aux nets' f32 1x1 convs unchanged, the flow within the
            ``flow_twin`` bar); K2's launches by shape class, each class
            against its twin and timed from CUDA graphs beside ``conv2d``.
4c. shipped32  the shipped config served at ``compute_dtype=float32``
            (batch 4, 512^2): launches as phase 4's, every K1 and K2
            launch on the f32 route; K2 at each of the run's shape classes
            against its twin and timed from CUDA graphs beside f32
            ``conv2d`` (TF32 off).
4b. shipped_int8  the shipped config with ``quantize="int8"`` on phase 4's
            pages, weights and x_T: launches and routes as phase 4's, the
            int8 products at the code's count, the int8 layers' weights
            f32, the flow's distance from phase 4's (a reading), peak
            memory.
4d. flags   GeoTr's init_flow with the VGG16 conditioning served in
            bf16, batch 4: launches and routes (GeoTr's 24 K1 launches on
            the Dh 32 wgmma instance, the VGG's 7 K2 launches in f32, the
            rest bf16), outputs.
4e. alt     each alt32 family served in bf16 at batch 4, 3 DDIM steps x
            2 hypotheses, 512^2: launches and routes (every K1 and K2
            launch wgmma but the VGG's 7 f32 ones), K2's shape classes,
            outputs; then the CLI's single-image functions under ``--set
            model.train_mode=stage_1 --set model.train_VGG=False`` on a
            600x450 page (the card's machine has no PIL for ``--image``).
5. train32  one f32 train step of the shipped training config at full
            DiT-S/2 width, batch 2, 512^2: its loss and every gradient on
            the card through the kernels (K1-K4 launch counts must all be
            > 0) against the CPU through the twins, same weights (the
            zero-initialised layers drawn small), batch, t and noise,
            dropout off.
5b. flags_train32  train32 under ``train_VGG=False`` (the VGG16
            features in place of the DiT's pyramid).
5c. alt_train32  one f32 train step (``plain_masked_mse``) of each
            alternative family at full width, batch 2, 512^2: loss and
            every gradient card against CPU under train32's bars, K1 and
            K2 launched, every K2 launch f32.
6. train    the shipped training config (bf16 compute, f32 parameters,
            batch 10, 512^2, time-variant loss with its rollout, the
            on-device augmentation) through ``training.train_loop.train``,
            its batches from ``cli.run_training.device_resident_iterator``
            over 32 seeded stand-in raw samples (image, soft mask, flow;
            the card's machine has no cv2 or h5py to read Doc3D files)
            staged on the card, 22 steps: loss, parameters and EMA moved,
            launches per step (every K1 and K2 launch on the wgmma route,
            every K3 launch through its grid entry, one more a step than
            train32's: the augmentation's warp), peak memory.  Then 3
            steps with ``device_dataset="off"``, the same set through
            ``PrefetchLoader``'s host threads.
7. probe    the K5 probe entry (``dvd_tpu_torch.tools.gather_probe``) on
            the card: exact, and K5 launched.
8. dataset  the dataset serving path.  Weights: the aux nets of a seeded
            pipeline written as flax msgpack files and the DiT from the
            EMA snapshot that phase 6's ``train()`` wrote, served through
            ``maybe_load_pipeline_weights`` into a pipeline from another
            seed (4/4 loaded, every tensor equal to its source in the
            serving dtype).  ``unwarp_native`` (the fused unwarp) on the
            card against the CPU for two pages in a 1536^2 canvas, TF32
            off and on, and its coordinates through a ramp source.  Then
            the shipped config through ``run_benchmark`` on 100 stand-in
            pages of 900-2000 px sides (canvas 2048), batch 4, and on 6
            pages (a padded last batch): run_stats.json, launches, peak
            memory, one finite coordinate map in [-1, 1] per page.  The
            stand-in dataset builds its pages from seeded arrays (the
            card's machine has no PIL or cv2).
9. corrupt  ``cli.run_sampling.run_corruption_sweep`` (int8 serving) over 6
            stand-in pages, every corruption that needs no cv2 at
            severities 1 and 5: a ``run_stats.json`` and a coordinate map
            per page for each combination, the kernels and the int8 GEMM
            launched, and every page the driver read equal to
            ``corrupt`` of it on the host.
10. score   the port's SIFT-flow engine built with g++ (its build time);
            phase 4's and phase 4b's unwarped pages scored against their
            sources at equal size with MS-SSIM and the native LD/AD
            (readings: the weights are random).
11. likelihood32  ``diffusion.likelihood.calc_bpd_loop`` at f32 on the
            shipped DiT-S/2 (its conditioning hoisted out of the loop),
            the 3-step cosine schedule, batch 2 at 512^2, each step's
            noise pinned: total_bpd, vb, xstart_mse and mse card against
            CPU within 1e-5 of max|ref|, both TF32 switches off; K1 and K2
            launched (K2 all f32).
12. dist1   a 1-process NCCL world through ``--multihost``'s code path
            (``cli.run_training.init_from_env``, ``make_mesh``,
            ``train(mesh=)``): 3 shipped train steps (batch 10, the
            device-resident stand-in set) equal the plain ``train()``'s
            bit for bit (parameters, BN statistics, EMA, AdamW moments,
            the logged values; cuDNN's deterministic algorithms for both),
            and ``run_benchmark(mesh="auto")`` over 8 stand-in pages
            equals the plain run's coordinate maps bit for bit.
13. dist2   two processes on cuda:0 over gloo (this script again, with
            ``--dist2-worker``), DiT-S/2 at full width in f32, global batch
            4, SATRN's BN in train mode, dropout off: one step at data=2,
            model=2 and data=2 with FSDP, each against this process's step
            on the global batch under train32's bars (loss relative 1e-4,
            every gradient 1e-3 x max(1, max|g|)); serving 8 stand-in pages
            at data=2 and model=2 against this process's coordinate maps
            within slice32's 1e-3; each layout's launches.

The line before the last is the per-kernel JSON record (every kernel and
route, each with the launches of the run that drives it: K1-K4 from the
training run, the augmentation's K3 launches included, the fused unwarp
from the serving run, the f32 routes from train32, K1's Dh 32 instances
from flags (bf16) and flags32 (f32), K2 f32 at the VGG classes from
flags32, the alternative denoisers' K1 and K2 instances from alt (bf16)
and alt32 (f32), K5 from the probe; and the int8 GEMM, a library route,
from the int8 serving run);
the last line is ``{"ok": true, "device":
{...}}``.  Without a CUDA device the script raises before printing any
result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from collections import Counter

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
    "flow_twin": 3e-2,         # aim: shipped bf16 flow, K1 vs the twin
    "slice_flow": 1e-3,        # f32 slice, card vs CPU
    "slice_image": 1e-3,       # unwarped image in [0, 1]
    "native_grid": 1e-5,       # unwarp_native's canvas grid, card vs CPU;
                               # also the fused kernel's coordinates (ramp)
    "native_image": 0.5,       # its f32 image on [0, 255] (0.5 / 255 on
                               # the serving unwarp's [0, 1] source)
    "native_u8": 1,            # its uint8 image, levels
    "conv1x1_f32_rel": 2 ** -23,  # conv1x1_f32 with TF32 on vs off: one f32
                               # rounding at the largest output
    "train_loss_rel": 1e-4,    # f32 train step, card vs CPU, relative
    "train_grad": 1e-3,        # every gradient, x max(1, max|g|)
    "train_points": 1e-4,      # the loss warp's [-1, 1] points, card vs CPU
    "likelihood": 1e-5,        # calc_bpd_loop's terms, card vs CPU, x max|ref|
    "augment": 1e-5,           # augment_batch card vs CPU, same batch and
                               # factors (the warp's bar against dvd_tpu)
}

# the card's published peaks (NVIDIA H100 SXM data sheet, dense): the
# bound of a kernel is max(bytes / rate, operations / peak of their type).
# f32: the f32-accurate tensor-core rate, six bf16 products per f32 product
# (989 / 6 = 165 TFLOP/s), which the f32 kernels run at; the CUDA cores'
# 67 TFLOP/s, where cuDNN's and SDPA's f32 run, is the slower route
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 989e12 / 6}
# the f32 kernels against float64 at their record cases: max error at most
# F64_FACTOR x the f32 twin's, or F64_FLOOR x max|ref|
F64_FACTOR = 4
F64_FLOOR = 2.0 ** -20

# the case whose time goes into the per-kernel JSON record: the serving
# path's heaviest shape for each kernel, in the shipped dtype
RECORD_CASE = {
    "attention": "(8, 6, 1024, 256) scale 0.0625 bfloat16",
    "attention_f32": "(8, 6, 1024, 256) scale 0.0625 float32",
    # GeoTr's attention (use_init_flow): 8 heads of 32 over 36^2 tokens
    "attention_dh32": "(4, 8, 1296, 32) scale 0.176777 bfloat16",
    "attention_f32_dh32": "(4, 8, 1296, 32) scale 0.176777 float32",
    # the alternative denoisers' attention: the transformer's 4096 tokens
    # and GeoTr2's 1024 at Dh 32, the UNet's Dh 96 (zero-padded to 128)
    # and Dh 128, at the serving batch of 4 pages x 2 hypotheses
    "attention_alt": "(8, 4, 4096, 32) scale 0.176777 bfloat16",
    "attention_f32_alt": "(8, 4, 4096, 32) scale 0.176777 float32",
    "attention_geotr2": "(8, 8, 1024, 32) scale 0.176777 bfloat16",
    "attention_f32_geotr2": "(8, 8, 1024, 32) scale 0.176777 float32",
    "attention_dh96": "(8, 4, 256, 96) scale 0.102062 bfloat16",
    "attention_f32_dh96": "(8, 4, 256, 96) scale 0.102062 float32",
    "attention_dh128": "(8, 4, 64, 128) scale 0.0883883 bfloat16",
    "attention_f32_dh128": "(8, 4, 64, 128) scale 0.0883883 float32",
    # the alternative denoisers' stride-1 3x3 convs at batch 8, summed
    "conv3x3_unet": "the UNet's 22 classes, 68->128 @64^2 .. 1024->512 "
                    "@8^2, 195 launches, b8 bfloat16, summed from CUDA graphs",
    "conv3x3_f32_unet": "the UNet's 22 classes, 195 launches, b8 float32, "
                        "summed from CUDA graphs",
    "conv3x3_geotr2": "GeoTr2's 5 classes, 68->64 @64^2 .. 256->2 @32^2, 30 "
                      "launches, b8 bfloat16, summed from CUDA graphs",
    "conv3x3_f32_geotr2": "GeoTr2's 5 classes, 30 launches, b8 float32, "
                          "summed from CUDA graphs",
    # the VGG16 pyramid's seven convs (train_VGG=False), summed
    "conv3x3_f32_vgg": "VGG16's 7 classes, 3->64 @512^2 .. 256->256 @128^2, "
                       "b4 float32, summed from CUDA graphs",
    "conv3x3": "256->256 @128^2 d1 b4 bfloat16",
    "conv3x3_f32": "256->256 @128^2 d1 b4 float32",
    "gather_bilinear": "(8, 256, 64, 64) zeros",
    "unwarp": "(4, 2048, 2048, 3) uint8 native",
    "gather_bilinear_grad": "(10, 2, 512, 512) zeros",
    "gather2d": "(2048, 2048) f32 at (2048, 2048) int32 near-identity",
}

# the f32 kernels' aims in ms at their timed cases: (low, high), high None
# for "below the library call"
F32_AIMS = {
    ("attention_f32", "(8, 6, 1024, 256) scale 0.0625 float32"): (0.6, 1.0),
    ("attention_f32", "(8, 6, 1024, 64) scale 0.125 float32"): (0.0, None),
    ("attention_f32", "(8, 16, 1024, 72) scale 0.117851 float32"): (0.0, None),
    ("conv3x3_f32", "256->256 @128^2 d1 b4 float32"): (0.8, 1.4),
}

KERNELS = {
    # name -> (source, replaced TPU kernel, the run whose launches count)
    "attention": ("dvd_tpu_torch/csrc/attention_wgmma.cu",
                  "dvd_tpu/ops/pallas/attention.py:49", "train"),
    "attention_f32": ("dvd_tpu_torch/csrc/attention_f32x6.cu",
                      "dvd_tpu/ops/pallas/attention.py:49", "train32"),
    "attention_dh32": ("dvd_tpu_torch/csrc/attention_wgmma.cu",
                       "dvd_tpu/ops/pallas/attention.py:49", "flags"),
    "attention_f32_dh32": ("dvd_tpu_torch/csrc/attention_f32x6.cu",
                           "dvd_tpu/ops/pallas/attention.py:49", "flags32"),
    # the alternative denoisers' instances: launches from the bf16 serving
    # run (alt) and the f32 one (alt32) of the family that runs them
    **{name: ("dvd_tpu_torch/csrc/attention_" + ("f32x6" if "f32" in name
                                                 else "wgmma") + ".cu",
              "dvd_tpu/ops/pallas/attention.py:49",
              "alt32" if "f32" in name else "alt")
       for name in ("attention_alt", "attention_f32_alt", "attention_geotr2",
                    "attention_f32_geotr2", "attention_dh96",
                    "attention_f32_dh96", "attention_dh128",
                    "attention_f32_dh128")},
    **{name: ("dvd_tpu_torch/csrc/conv3x3_" + ("f32x6" if "f32" in name
                                               else "wgmma") + ".cu",
              "dvd_tpu/ops/pallas/planar_conv.py:247",
              "alt32" if "f32" in name else "alt")
       for name in ("conv3x3_unet", "conv3x3_f32_unet", "conv3x3_geotr2",
                    "conv3x3_f32_geotr2")},
    "conv3x3": ("dvd_tpu_torch/csrc/conv3x3_wgmma.cu",
                "dvd_tpu/ops/pallas/planar_conv.py:247", "train"),
    "conv3x3_f32": ("dvd_tpu_torch/csrc/conv3x3_f32x6.cu",
                    "dvd_tpu/ops/pallas/planar_conv.py:247", "train32"),
    "conv3x3_f32_vgg": ("dvd_tpu_torch/csrc/conv3x3_f32x6.cu",
                        "dvd_tpu/ops/pallas/planar_conv.py:247", "flags32"),
    "gather_bilinear": ("dvd_tpu_torch/csrc/grid_sample.cu",
                        "dvd_tpu/ops/pallas/grid_sample.py:122", "train"),
    "unwarp": ("dvd_tpu_torch/csrc/unwarp.cu",
               "dvd_tpu/ops/pallas/grid_sample.py:122", "serving"),
    "gather_bilinear_grad": ("dvd_tpu_torch/csrc/grid_sample.cu",
                             "dvd_tpu/ops/pallas/grid_sample.py:253", "train"),
    "gather2d": ("dvd_tpu_torch/csrc/gather_probe.cu",
                 "tools/pallas_gather_probe.py:72", "probe"),
}
# the kernels of the training path (K5 is the probe's alone)
TRAIN_KERNELS = ("attention", "conv3x3", "gather_bilinear",
                 "gather_bilinear_grad", "ln_modulate", "gate_residual")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_label() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _entry_name(symbol: str) -> str:
    """A kernel's name from its mangled symbol, with the anonymous
    namespace dropped and a template's arguments read as ``<bf16,64>``
    (the symbol itself if it is not mangled)."""
    m = re.match(r"_ZN?", symbol)
    pos = m.end() if m else 0
    while m:
        m = re.compile(r"\d+").match(symbol, pos)
        if not m:
            break
        name = symbol[m.end():m.end() + int(m.group())]
        pos = m.end() + len(name)
        if not name.startswith("_GLOBAL__N"):
            t = re.compile(r"I(.*?)EE").match(symbol, pos)
            if not t:
                return name
            names = {"13__nv_bfloat16": "bf16", "f": "f32", "h": "u8",
                     "Lb1": "zeros", "Lb0": "border"}
            args = [names.get(a, a[2:] if a.startswith("Li") else a)
                    for a in re.findall(r"13__nv_bfloat16|Li\d+|Lb\d|f|h",
                                        t.group(1))]
            return f"{name}<{','.join(args)}>"
    return symbol


def ptxas_report(log_text: str):
    """(kernel<args>, registers, spills) per entry function in nvcc's
    ``-Xptxas -v`` output."""
    out, entry, spills = [], None, ""
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = _entry_name(m.group(1))
        elif entry and "spill stores" in line:
            spills = line.split("info    :")[-1].strip()
        elif entry and "Used" in line and "registers" in line:
            out.append((entry, line.split("info    :")[-1].strip(), spills))
            entry = None
    return out


def sass_hgmma(lib_path):
    """{kernel<args>: HGMMA instructions} in the library's SASS, from the
    toolkit's ``cuobjdump -sass``; None where the toolkit has none."""
    from dvd_tpu_torch.ops.kernels import build

    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(build.find_nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    counts, entry = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            entry = _entry_name(line.split("Function :")[1].strip())
            counts[entry] = 0
        elif entry and "HGMMA" in line:
            counts[entry] += 1
    return counts


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


def cuda_graph_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` from one CUDA graph of ``iters`` calls:
    no host launch cost between them, which back-to-back calls of a
    kernel of a few microseconds measure instead."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()   # first-call set-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
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
           f"{kl.build_seconds:.1f} s, one process per source, all at once: "
           + ", ".join(f"{src} {sec:.1f} s"
                       for src, sec in kl.source_seconds.items()) + ")"
           if kl.build_seconds else
           "loaded from an earlier build of the same sources")
    log(f"[env] kernels from dvd_tpu_torch/csrc for sm_90a {how} -> "
        f"{kl.path.relative_to(build.PKG_DIR.parent)}")
    for line in kl.build_log.splitlines():
        if "warning" in line.lower():
            log(f"[env] nvcc: {line.strip()}")
    # the tensor-core kernels: every instance must run without spills and
    # have HGMMA in its SASS (K1: 7 head dims in bf16, 6 in f32; K2 bf16: 4
    # widths x 3 chunk sizes, and 256-pixel blocks at n128 x 2 chunk sizes;
    # K2 f32: 3 widths x 2 chunk sizes, and 256-pixel blocks at n64, CC 16)
    wgmma_kernels = {"attention_wgmma_kernel": 7, "conv3x3_wgmma_kernel": 14,
                     "attention_f32x6_kernel": 6, "conv3x3_f32x6_kernel": 7}
    spilled = []
    for entry, regs, spills in ptxas_report(kl.build_log):
        log(f"[env] ptxas -v {entry}: {regs}; {spills}")
        if entry.split("<")[0] in wgmma_kernels and any(
                int(n) for n in re.findall(r"(\d+) bytes spill", spills)):
            spilled.append(entry)
    if spilled:
        raise AssertionError(f"tensor-core kernels spill: {spilled}")
    hgmma = sass_hgmma(kl.path)
    if hgmma is None:
        log("[env] HGMMA in the library's SASS: not counted (the toolkit has "
            "no cuobjdump)")
    else:
        log(f"[env] HGMMA in the library's SASS (cuobjdump -sass): "
            f"{sum(hgmma.values())} in all")
        for kernel, n in wgmma_kernels.items():
            wg = {k: c for k, c in hgmma.items() if k.startswith(kernel + "<")}
            log(f"[env]   {kernel}: {wg}")
            if len(wg) != n or min(wg.values()) <= 0:
                raise AssertionError(f"{kernel} without HGMMA: {wg}")
    # every kernel's shared memory is dynamic, which ptxas does not report
    from dvd_tpu_torch.ops.kernels.attention import HEAD_DIMS_BY_DTYPE
    from dvd_tpu_torch.ops.kernels.conv3x3 import wgmma_plan
    kib = lambda n: f"{n / 1024:.1f} KiB"
    log("[env] dynamic shared memory per block: attention_f32x6_kernel " + ", ".join(
        f"Dh {dh} {kib(kl.lib.dvd_attention_f32x6_smem_bytes(dh))}"
        for dh in HEAD_DIMS_BY_DTYPE[torch.float32]))
    log("[env] dynamic shared memory per block: attention_wgmma_kernel "
        + ", ".join(f"Dh {dh} {kib(kl.lib.dvd_attention_wgmma_smem_bytes(dh))}"
                    for dh in HEAD_DIMS_BY_DTYPE[torch.bfloat16]))
    log("[env] dynamic shared memory per block: gather_bilinear_kernel 0; "
        "gather_bilinear_grad_kernel 0; "
        "unwarp_kernel S^2 x 8 bytes (32.0 KiB at the latent's S = 64); "
        "gather2d_kernel 0")
    # K3's plan (channels and points per thread) at each of its main-path
    # shapes: the re-warps, the loss's warp, the unfused 2048^2 unwarp, the
    # augmentation's warp
    from dvd_tpu_torch.ops.kernels.grid_sample import gather_plan
    for n, c, hw in GATHER_CASES:
        p = gather_plan(n, c, hw * hw)
        log(f"[env] gather_bilinear_kernel at ({n}, {c}, {hw}, {hw}): "
            f"{p['g']} channels x {p['pix']} points per thread, "
            f"{p['groups']} channel groups x {p['blocks']} blocks x {n}, "
            f"{n * p['groups'] * p['blocks'] * 256} threads")
    # the bf16 conv's shared memory follows its launch plan: one shape of
    # the main path per instance <BN, CC>
    for cin, cout, hw, d in ((4, 1, 288, 1), (4, 16, 288, 1), (4, 64, 512, 1),
                             (3, 128, 288, 1), (16, 1, 288, 1), (16, 16, 9, 8),
                             (16, 64, 288, 1), (16, 128, 36, 1),
                             (16, 128, 288, 1), (64, 1, 288, 1), (64, 16, 288, 1),
                             (64, 64, 512, 1), (1024, 512, 36, 1),
                             (256, 256, 128, 1)):
        _log_plan("conv3x3_wgmma_kernel", wgmma_plan(4, cin, cout, hw, hw, d),
                  cin, cout, hw, d)
    # the f32 kernel's, likewise
    for cin, cout, hw, d in ((4, 1, 288, 1), (4, 16, 288, 1), (4, 64, 512, 1),
                             (64, 1, 288, 1), (64, 16, 288, 1), (16, 16, 9, 8),
                             (1024, 512, 36, 1), (256, 256, 128, 1)):
        _log_plan("conv3x3_f32x6_kernel",
                  wgmma_plan(4, cin, cout, hw, hw, d, torch.float32),
                  cin, cout, hw, d)


def _log_plan(kernel, p, cin, cout, hw, d):
    log(f"[env] {kernel}<{p['bn']},{p['cc']},{p['mt']}> at {cin}->{cout} "
        f"@{hw}^2 d{d} b4: tile {p['th']}x{p['tw']}, copies of {p['v']} "
        f"elements, {p['smem'] / 1024:.1f} KiB dynamic shared memory, "
        f"{p['blocks']} blocks")


# ---------------------------------------------------------------- phase 2
def _qkv(b, h, t, dh, dtype, gen, dev):
    # the split_heads views of a fused (B, T, 3, H, Dh) projection:
    # strided, as the main path hands them to the kernel
    qkv = torch.randn((b, t, 3, h, dh), generator=gen, device=dev).to(dtype)
    return tuple(qkv[:, :, i].transpose(1, 2) for i in range(3))


def _qkv_separate(b, h, t, dh, dtype, gen, dev):
    # the split_heads views of three (B, T, H*Dh) projections (GeoTr's
    # q_proj(tgt + pos), k_proj(memory + pos), v_proj(memory))
    return tuple(torch.randn((b, t, h * dh), generator=gen, device=dev)
                 .to(dtype).view(b, t, h, dh).transpose(1, 2)
                 for _ in range(3))


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


def _vs_f64(case, got, twin, ref64, enforce: bool) -> None:
    """The f32 kernel's and its f32 twin's max error against a float64
    computation of the same inputs; where ``enforce``, the kernel's must be
    within F64_FACTOR x the twin's or F64_FLOOR x max|ref|."""
    err, tw = ((a.double() - ref64).abs().max().item() for a in (got, twin))
    bar = max(F64_FACTOR * tw, F64_FLOOR * ref64.abs().max().item())
    ok = math.isfinite(err) and err <= bar
    log(f"  {case} vs float64: kernel {err:.3e}, twin {tw:.3e} ({err / max(tw, 1e-30):.2f}x; "
        f"bar {bar:.3e}{'' if enforce else ', not enforced'}) "
        f"{'ok' if ok else 'FAIL' if enforce else 'above'}")
    if enforce and not ok:
        raise AssertionError(f"{case}: {err:.3e} from float64 above {bar:.3e}")


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


# K3's shapes (N, C, plane side): the serving unwarp's and the dataset
# unwarp's gathers as the unfused path ran them, the sampler's feature
# re-warp, then the training loss's warp, the rollout's re-warps and the
# augmentation's warp of image + mask (one launch over their 4 channels)
GATHER_CASES = ((4, 3, 512), (8, 256, 64), (4, 3, 2048), (10, 2, 512),
                (10, 256, 64), (10, 4, 512))


def _augment_case():
    """``augment_batch`` (K3's warp of image + mask, then the jitter) on the
    card against the same call on the CPU: the same raw training batch of
    the stand-in set and the same jitter factors, at the shipped
    ``inter_t / inter_T = 0`` (the identity warp) and at 0.35."""
    from dvd_tpu_torch.data.device_aug import augment_batch, jitter_factors

    b = 10
    ds = StandInRawPages(b, SEED + 21)
    raw = {k: torch.from_numpy(np.stack([ds[i][k] for i in range(b)]))
           for k in ds[0]}
    factors = jitter_factors(b, torch.Generator().manual_seed(SEED + 22))
    dev_raw = {k: v.cuda() for k, v in raw.items()}
    dev_factors = tuple(f.cuda() for f in factors)
    for frac in (0.0, 0.35):
        want = augment_batch(raw, factors, inter_frac=frac)
        got = augment_batch(dev_raw, dev_factors, inter_frac=frac)
        for k in ("source_image", "doc_mask", "flow_map_inter"):
            compare(f"augment_batch ({b}, 512, 512) frac {frac:g} {k}, card "
                    f"vs CPU", got[k].cpu(), want[k], TOL["augment"])
    ms = cuda_time_ms(lambda: augment_batch(dev_raw, dev_factors,
                                            inter_frac=0.0))
    log(f"  augment_batch ({b}, 512, 512), the warp and the jitter: {ms:.4f} "
        f"ms a call (CUDA events, mean of 20)")


def _unwarp_kernel_cases(gen, errs, times):
    """The fused unwarp against its plain version on the card: the dataset
    path's batch (four pages of 906-2000 px in a 2048^2 uint8 canvas,
    uint8 and f32 out) and the serving path's (4, 512, 512, 3) f32 page in
    [0, 1]; timed beside the plain version and, as no single PyTorch call
    computes it, the unfused path the port ran before (the coordinates in
    plain torch, then K3's plane entry, then the uint8 rounding)."""
    from dvd_tpu_torch.ops.kernels.grid_sample import (gather_bilinear,
                                                       unnormalize)
    from dvd_tpu_torch.ops.kernels.unwarp import (native_grid, to_u8, unwarp,
                                                  unwarp_ref)
    from dvd_tpu_torch.ops.resize import resize_bilinear
    from dvd_tpu_torch.utils.grids import UNWARP_SHRINK, flow_to_grid

    log("[kernels] the fused unwarp (csrc/unwarp.cu): flow upsample, grid, "
        "canvas mapping, unnormalisation, K3's 'zeros' gather from NHWC and "
        "the output conversion in one launch")

    def unfused_native(src, hw, flow):
        p = src.shape[1]
        px, py = native_grid(hw, flow, p)
        img = src.permute(0, 3, 1, 2).to(torch.float32).contiguous()
        out = gather_bilinear(img, unnormalize(px, p).contiguous(),
                              unnormalize(py, p).contiguous(), "zeros")
        return to_u8(out.permute(0, 2, 3, 1))

    def unfused_fixed(src, flow):
        h, w = src.shape[1:3]
        grid = flow_to_grid(resize_bilinear(flow.permute(0, 3, 1, 2), (h, w),
                                            True).permute(0, 2, 3, 1),
                            UNWARP_SHRINK)
        img = src.permute(0, 3, 1, 2).to(torch.float32).contiguous()
        out = gather_bilinear(img, unnormalize(grid[..., 0], w).contiguous(),
                              unnormalize(grid[..., 1], h).contiguous(), "zeros")
        return out.permute(0, 2, 3, 1)

    b, p = 4, 2048
    hws = [(2000, 1500), (1024, 2048), (1999, 1001), (906, 1997)]
    src = torch.zeros((b, p, p, 3), dtype=torch.uint8)
    cpu_gen = torch.Generator().manual_seed(SEED + 13)
    for i, (h, w) in enumerate(hws):
        src[i, :h, :w] = (_page(1, h, w, cpu_gen)[0] * 255).round().to(torch.uint8)
    src = src.cuda()
    hw = torch.tensor(hws, dtype=torch.int32, device="cuda")
    flow = _smooth_flow(b, 64, cpu_gen).cuda()
    before = read_launches()["unwarp"]
    got_u8 = unwarp(src, flow, hw, out_u8=True)
    got = unwarp(src, flow, hw)
    if read_launches()["unwarp"] != before + 2:
        raise AssertionError("the native unwarp did not launch the fused kernel")
    want_u8 = unwarp_ref(src, flow, hw, out_u8=True)
    want = unwarp_ref(src, flow, hw)
    err = 0.0
    for i, (h, w) in enumerate(hws):
        err = max(err, compare(f"native uint8 {h}x{w} in a {p}^2 canvas",
                               got_u8[i, :h, :w].int(), want_u8[i, :h, :w].int(),
                               TOL["native_u8"]))
        compare(f"native f32 {h}x{w} in a {p}^2 canvas", got[i, :h, :w],
                want[i, :h, :w], TOL["native_image"])
    case = RECORD_CASE["unwarp"]
    # per pixel: taps and lerps (~30), grid and canvas mapping (~22), the
    # corners (~20), 8 per channel for the blend and the rounding
    _record(times, "unwarp", case, lambda: unwarp(src, flow, hw, out_u8=True),
            lambda: unwarp_ref(src, flow, hw, out_u8=True), None,
            _nbytes(src, flow, hw, got_u8), b * p * p * (72 + 8 * 3),
            torch.float32)
    times[("unwarp", case)]["yardstick_ms"] = cuda_time_ms(
        lambda: unfused_native(src, hw, flow))
    errs["unwarp"] = err

    src = torch.rand((b, 512, 512, 3), generator=cpu_gen).cuda()
    flow = _smooth_flow(b, 64, cpu_gen).cuda()
    got = unwarp(src, flow)
    compare("fixed f32 (4, 512, 512, 3) in [0, 1]", got,
            unwarp_ref(src, flow), TOL["native_image"] / 255)
    case = "(4, 512, 512, 3) float32 fixed"
    _record(times, "unwarp", case, lambda: unwarp(src, flow),
            lambda: unwarp_ref(src, flow), None,
            _nbytes(src, flow, got), b * 512 * 512 * (60 + 8 * 3),
            torch.float32)
    times[("unwarp", case)]["yardstick_ms"] = cuda_time_ms(
        lambda: unfused_fixed(src, flow))


# K2's shape classes on the serving and training paths (Cin, Cout, plane,
# dilation): the pyramid (4->64 @512 ... 256->256 @128), the line UNet (to
# 1024->512 @36 and 512->512 @18), U2NetP (16- and 64-channel layers from
# 288^2 down to 9^2, dilations 2/4/8 at the bottom, 64->1 side convs)
CONV_CLASSES = ((4, 64, 512, 1), (64, 64, 512, 1), (64, 128, 256, 1),
                (128, 128, 256, 1), (128, 256, 128, 1), (256, 256, 128, 1),
                (3, 64, 288, 1), (128, 64, 288, 1), (512, 256, 72, 1),
                (1024, 512, 36, 1), (512, 512, 18, 1), (32, 64, 288, 1),
                (64, 16, 288, 1), (32, 16, 72, 1), (16, 16, 9, 2),
                (16, 16, 9, 4), (16, 16, 9, 8), (64, 1, 288, 1))


# the VGG16 pyramid's K2 classes at the serving batch, (B, Cin, Cout, H, W,
# dilation) -> launches a run (models/vgg.py: VGG_LAYERS)
VGG_CLASSES = {(4, 3, 64, 512, 512, 1): 1, (4, 64, 64, 512, 512, 1): 1,
               (4, 64, 128, 256, 256, 1): 1, (4, 128, 128, 256, 256, 1): 1,
               (4, 128, 256, 128, 128, 1): 1, (4, 256, 256, 128, 128, 1): 2}


# GeoTr's stride-1 3x3 convs at the serving batch -> launches a run
# (models/geotr.py: each ResidualBlock's conv2 and stride-1 conv1,
# update_block's mask_0 and flow head)
GEOTR_CLASSES = {(4, 64, 64, 144, 144, 1): 4, (4, 128, 128, 72, 72, 1): 3,
                 (4, 192, 192, 36, 36, 1): 3, (4, 256, 256, 36, 36, 1): 2,
                 (4, 256, 2, 36, 36, 1): 1}


def _conv_case(b, cin, cout, hw, dt, gen, dev):
    """x, w, scale, bias of a conv at unit-scale activations; ``hw``: the
    plane's side, or (H, W)."""
    hw = (hw, hw) if isinstance(hw, int) else hw
    x = torch.randn((b, cin, *hw), generator=gen, device=dev).to(dt)
    w = (torch.randn((cout, cin, 3, 3), generator=gen, device=dev)
         / math.sqrt(9 * cin)).to(dt)
    s = 1 + 0.1 * torch.randn((cout,), generator=gen, device=dev)
    bi = 0.1 * torch.randn((cout,), generator=gen, device=dev)
    return x, w, s, bi


def phase_kernels(state):
    import torch.nn.functional as F

    from dvd_tpu_torch.ops.grid_sample import unnormalize, warp_const_src
    from dvd_tpu_torch.ops.kernels.attention import attention, attention_ref
    from dvd_tpu_torch.ops.kernels.conv3x3 import (conv3x3, conv3x3_ref,
                                                   conv3x3_trainable,
                                                   k_major_weights)
    from dvd_tpu_torch.ops.kernels.gather2d import gather2d, gather2d_ref
    from dvd_tpu_torch.ops.kernels.grid_sample import (
        gather_bilinear, gather_bilinear_grad, gather_bilinear_grad_grid_ref,
        gather_bilinear_grid, gather_bilinear_grid_ref, gather_bilinear_ref)
    from dvd_tpu_torch.tools.gather_probe import probe_inputs

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    errs = {k: 0.0 for k in KERNELS}
    times = {}
    bf16 = torch.bfloat16
    with torch.inference_mode():
        log("[kernels] K1 attention (B, H, T, Dh), strided split_heads views: "
            "f32 through six bf16 products over a three-way split, bf16 "
            "through wgmma")
        # K1's aims: bf16 within 3x of scaled_dot_product_attention at Dh 64,
        # 2x at Dh 256 (reported, not enforced: a time is not a check)
        # Dh 72 (DiT-XL/2: 16 heads of 72): bf16 on its own instance, f32
        # zero-padded by the wrapper to 128; its bound is the Dh 72 work
        aims = {}
        both = (torch.float32, bf16)
        # (shape, scale, dtypes, aim, q/k/v builder, record key suffix,
        # graph: the bf16 kernel also held against float64, and timed from
        # CUDA graphs too, since its launches are small)
        for shape, scale, dts, aim, make_qkv, suffix, graph in (
                ((8, 6, 1024, 64), 1 / 8, both, 3.0, _qkv, "", False),
                ((8, 6, 1024, 256), 1 / 16, both, 2.0, _qkv, "", False),
                ((8, 16, 1024, 72), 1 / math.sqrt(72), both, 0.0, _qkv, "",
                 False),
                ((8, 6, 1000, 256), 1 / 16, both, None, _qkv, "",
                 False),  # ragged
                # GeoTr (use_init_flow): 8 heads of 32 over 36^2 tokens,
                # ragged against every block size; q, k and v the
                # split_heads views of three (B, T, 256) projections
                ((4, 8, 1296, 32), 1 / math.sqrt(32), both, 0.0,
                 _qkv_separate, "_dh32", True),
                # the alternative denoisers at the serving batch (4 pages x
                # 2 hypotheses): the transformer's and GeoTr2's separate
                # projections at Dh 32, the UNet's fused qkv at Dh 96
                # (zero-padded to 128; its bound is the Dh 96 work) and 128
                ((8, 4, 4096, 32), 1 / math.sqrt(32), both, 0.0,
                 _qkv_separate, "_alt", True),
                ((8, 8, 1024, 32), 1 / math.sqrt(32), both, 0.0,
                 _qkv_separate, "_geotr2", True),
                ((8, 4, 256, 96), 1 / math.sqrt(96), both, 0.0, _qkv,
                 "_dh96", True),
                ((8, 4, 64, 128), 1 / math.sqrt(128), both, 0.0, _qkv,
                 "_dh128", True)):
            for dt in dts:
                q, k, v = make_qkv(*shape, dt, gen, dev)
                before = routes("attention")
                got = attention(q, k, v, scale)
                route = routes("attention")
                route = {r: route[r] - before[r] for r in route}
                want = attention_ref(q, k, v, scale)
                bar = TOL["attention_f32"] if dt == torch.float32 else \
                    TOL["bf16"] * max(1.0, want.float().abs().max().item())
                case = f"{shape} scale {scale:g} {str(dt)[6:]}"
                key = ("attention" if dt == bf16 else "attention_f32") + suffix
                errs[key] = max(errs[key], compare(f"{case} {route}", got,
                                                   want, bar))
                if route != {"wgmma": int(dt == bf16), "f32": int(dt != bf16)}:
                    raise AssertionError(f"K1 {case} took the routes {route}")
                if dt == torch.float32 or graph:
                    # (the bf16 kernel against its bf16 twin, both from
                    # float64)
                    _vs_f64(case, got, want, attention_ref(
                        q.double(), k.double(), v.double(), scale),
                        case in {RECORD_CASE[r] for r in RECORD_CASE
                                 if r.startswith("attention")
                                 and r != "attention"})
                if aim is not None:  # timed in both dtypes; the aim is bf16's
                    if dt == bf16 and aim:
                        aims[case] = aim
                    b, h, tq, dh = shape
                    library = lambda: F.scaled_dot_product_attention(
                        q, k, v, scale=scale)
                    _record(times, key, case,
                            lambda: attention(q, k, v, scale),
                            lambda: attention_ref(q, k, v, scale), library,
                            _nbytes(q, k, v, got), 4 * b * h * tq * tq * dh, dt)
                    if graph:
                        times[(key, case)].update(
                            graph_ms=cuda_graph_ms(
                                lambda: attention(q, k, v, scale)),
                            library_graph_ms=cuda_graph_ms(library))

        # DiT-XL/2's Dh 72 in bf16: the native instance beside the route it
        # replaced (q, k and v zero-padded to 128 in device memory, the 128
        # instance, the output sliced), equal bit for bit; both timed
        s72 = 1 / math.sqrt(72)
        q, k, v = _qkv(8, 16, 1024, 72, bf16, gen, dev)
        native = attention(q, k, v, s72)
        padded = lambda: attention(*(F.pad(t, (0, 56)) for t in (q, k, v)),
                                   s72)[..., :72]
        diff = (native.float() - padded().float()).abs()
        case = f"(8, 16, 1024, 72) scale {s72:g} bfloat16"
        log(f"  {case}: native vs padded to 128: {int((diff > 0).sum())} "
            f"values differ (columns 64-71: {int((diff[..., 64:] > 0).sum())}),"
            f" max {diff.max().item():.3e}")
        if diff.max().item() > 0:
            raise AssertionError(f"K1 {case}: native differs from padded")
        _record(times, "attention", case + " padded to 128", padded,
                lambda: attention_ref(q, k, v, s72),
                lambda: F.scaled_dot_product_attention(q, k, v, scale=s72),
                _nbytes(q, k, v, native), 4 * 8 * 16 * 1024 * 1024 * 72, bf16)

        log("[kernels] K2 conv3x3 (B, Cin, H, W) -> Cout, dilation: f32 "
            "through six bf16 products over a three-way split, bf16 through "
            "wgmma")
        # the f32 kernel at the serving batch and the frozen aux nets'
        # shapes at the training batch
        for b, cin, cout, hw, d in ((4, 3, 16, 288, 1), (4, 64, 16, 9, 8),
                                    (4, 4, 64, 512, 1), (4, 256, 256, 128, 1),
                                    (4, 1024, 512, 36, 1), (4, 64, 1, 288, 1),
                                    (10, 3, 16, 288, 1), (10, 64, 16, 9, 8),
                                    (10, 64, 1, 288, 1)):
            x, w, s, bi = _conv_case(b, cin, cout, hw, torch.float32, gen, dev)
            before = routes("conv3x3")
            got = conv3x3(x, w, s, bi, d, True)
            route = {r: n - before[r] for r, n in routes("conv3x3").items()}
            name = f"{cin}->{cout} @{hw}^2 d{d} b{b} float32"
            want = conv3x3_ref(x, w, s, bi, d, True)
            errs["conv3x3_f32"] = max(errs["conv3x3_f32"], compare(
                f"{name} {route}", got, want, TOL["conv3x3_f32_rel"], rel=True))
            if route != {"wgmma": 0, "f32": 1}:
                raise AssertionError(f"K2 {name} took the routes {route}")
            _vs_f64(name, got, want, conv3x3_ref(
                x.double(), w.double(), s.double(), bi.double(), d, True),
                name == RECORD_CASE["conv3x3_f32"])
            if name == RECORD_CASE["conv3x3_f32"]:   # f32 conv2d, TF32 off
                _record(times, "conv3x3_f32", name,
                        lambda: conv3x3(x, w, s, bi, d, True),
                        lambda: conv3x3_ref(x, w, s, bi, d, True),
                        lambda: F.conv2d(x, w, bi, 1, d, d),
                        _nbytes(x, w, s, bi, got),
                        2 * b * cout * cin * 9 * hw * hw, torch.float32)
        # bf16: every shape class of the serving and training paths (the
        # pyramid, the line UNet, U2NetP), at batch 4 (timed) and 10
        for b in (4, 10):
            for cin, cout, hw, d in CONV_CLASSES:
                x, w, s, bi = _conv_case(b, cin, cout, hw, bf16, gen, dev)
                wk = k_major_weights(w)
                before = routes("conv3x3")
                got = conv3x3(x, w, s, bi, d, True, wk)
                route = {r: n - before[r] for r, n in routes("conv3x3").items()}
                want = conv3x3_ref(x, w, s, bi, d, True)
                name = f"{cin}->{cout} @{hw}^2 d{d} b{b} bfloat16"
                bar = TOL["bf16"] * max(1.0, want.float().abs().max().item())
                errs["conv3x3"] = max(errs["conv3x3"],
                                      compare(f"{name} {route}", got, want, bar))
                if route != {"wgmma": 1, "f32": 0}:
                    raise AssertionError(f"K2 {name} took the routes {route}")
                if b == 4:
                    bl = bi.to(bf16)
                    _record(times, "conv3x3", name,
                            lambda: conv3x3(x, w, s, bi, d, True, wk),
                            lambda: conv3x3_ref(x, w, s, bi, d, True),
                            lambda: F.conv2d(x, w, bl, 1, d, d),
                            _nbytes(x, w, s, bi, got),
                            2 * b * cout * cin * 9 * hw * hw, bf16)

        # the VGG16 pyramid (train_VGG=False) runs in f32 whatever the
        # compute dtype: its seven convs, from CUDA graphs beside f32
        # conv2d (TF32 off), summed
        vgg = _time_conv_classes(Counter(VGG_CLASSES), state["label"],
                                 "kernels", torch.float32)
        times[("conv3x3_f32_vgg", RECORD_CASE["conv3x3_f32_vgg"])] = dict(
            ms=vgg["kernel"], plain_ms=vgg["plain"], library_ms=vgg["conv2d"],
            bound_ms=vgg["bound"],
            bound_by="bytes" if 2 * vgg["bytes"] >= vgg["bound"]
            else "operations")
        errs["conv3x3_f32_vgg"] = vgg["max_err"]
        # GeoTr's stride-1 convs (use_init_flow) in the compute dtype,
        # against their twin and timed the same way (a reading)
        geotr = _time_conv_classes(Counter(GEOTR_CLASSES), state["label"],
                                   "kernels", bf16)
        errs["conv3x3"] = max(errs["conv3x3"], geotr["max_err"])
        # the alternative denoisers' stride-1 convs at the serving batch,
        # in both dtypes, the same way
        for family, classes in (("unet", UNET_CLASSES),
                                ("geotr2", GEOTR2_CLASSES)):
            for dt in (bf16, torch.float32):
                key = f"conv3x3{'_f32' if dt == torch.float32 else ''}_{family}"
                r = _time_conv_classes(Counter(classes), state["label"],
                                       f"kernels {family}", dt)
                times[(key, RECORD_CASE[key])] = dict(
                    ms=r["kernel"], plain_ms=r["plain"],
                    library_ms=r["conv2d"], bound_ms=r["bound"],
                    bound_by="bytes" if 2 * r["bytes"] >= r["bound"]
                    else "operations")
                errs[key] = r["max_err"]

        log("[kernels] K3 gather_bilinear (N, C, H, W) at a smooth flow grid: "
            "the [-1, 1] grid entry (the main path's), then the pixel-plane "
            "entry")
        for n, c, hw in GATHER_CASES:
            modes = ("zeros", "border") if c == 3 and hw == 512 else ("zeros",)
            img = torch.rand((n, c, hw, hw), generator=gen, device=dev)
            grid = _smooth_grid(n, hw, hw, gen, dev)
            gx = unnormalize(grid[..., 0], hw).contiguous()
            gy = unnormalize(grid[..., 1], hw).contiguous()
            oor = ((gx < 0) | (gx > hw - 1)).float().mean().item()
            for mode in modes:
                case = f"({n}, {c}, {hw}, {hw}) {mode}"
                before = gather_routes()
                got = gather_bilinear_grid(img, grid, mode)
                got_planes = gather_bilinear(img, gx, gy, mode)
                route = {r: k - before[r] for r, k in gather_routes().items()}
                if route != {"grid": 1, "planes": 1}:
                    raise AssertionError(f"K3 {case} took the routes {route}")
                errs["gather_bilinear"] = max(
                    errs["gather_bilinear"],
                    compare(f"{case} grid (out of range {oor:.1%})", got,
                            gather_bilinear_grid_ref(img, grid, mode),
                            TOL["gather_f32"]),
                    compare(f"{case} planes", got_planes,
                            gather_bilinear_ref(img, gx, gy, mode),
                            TOL["gather_f32"]))
                library = lambda: F.grid_sample(
                    img, grid, mode="bilinear", padding_mode=mode,
                    align_corners=True)
                _record(times, "gather_bilinear", case,
                        lambda: gather_bilinear_grid(img, grid, mode),
                        lambda: gather_bilinear_grid_ref(img, grid, mode),
                        library, _nbytes(img, grid, got),
                        n * hw * hw * (8 * c + 12), torch.float32)
                # a few-channel launch takes about as long as the host's
                # launch of it: replayed from a CUDA graph, without the
                # host, beside grid_sample's the same way
                times[("gather_bilinear", case)].update(
                    graph_ms=cuda_graph_ms(
                        lambda: gather_bilinear_grid(img, grid, mode)),
                    library_graph_ms=cuda_graph_ms(library))
        _augment_case()
        _unwarp_kernel_cases(gen, errs, times)

        log("[kernels] K4 gather_bilinear_grad (N, C, H, W): d/dgrid of "
            "sum_c ct_c * sample_c at the [-1, 1] grid, the training loss's "
            "backward")
        n, c, hw = 10, 2, 512
        img = torch.rand((n, c, hw, hw), generator=gen, device=dev)
        grid = _smooth_grid(n, hw, hw, gen, dev)
        ct = torch.randn((n, c, hw, hw), generator=gen, device=dev)
        oor = ((grid[..., 0].abs() > 1)).float().mean().item()
        for mode in ("zeros", "border"):
            got = gather_bilinear_grad(img, grid, ct, mode)
            want = gather_bilinear_grad_grid_ref(img, grid, ct, mode)
            case = f"({n}, {c}, {hw}, {hw}) {mode}"
            bar = TOL["gather_grad_f32"] * max(1.0, want.abs().max().item())
            errs["gather_bilinear_grad"] = max(
                errs["gather_bilinear_grad"],
                compare(f"{case} d/dgrid (out of range {oor:.1%})", got, want,
                        bar))
            pad = {"zeros": 0, "border": 1}[mode]
            _record(times, "gather_bilinear_grad", case,
                    lambda: gather_bilinear_grad(img, grid, ct, mode),
                    lambda: gather_bilinear_grad_grid_ref(img, grid, ct, mode),
                    lambda: torch.ops.aten.grid_sampler_2d_backward(
                        ct, img, grid, 0, pad, True, [False, True]),
                    _nbytes(img, grid, ct, got), n * hw * hw * (16 * c + 20),
                    torch.float32)

        log("[kernels] K5 gather2d (H, W) f32 at (M, N) int32 indices, bit "
            "for bit: the probe's case, an unwarp-scale one, and MN % 4 != 0 "
            "with aligned and offset (not 16-byte aligned) index planes, "
            "the vector path's tail and the scalar path")
        n = 2048
        ramp = torch.arange(n, device=dev, dtype=torch.int32)

        def jitter():
            return torch.randint(-2, 3, (n, n), generator=gen, device=dev,
                                 dtype=torch.int32)

        def ragged(offset):
            # y and x, each (37, 101) (3737 = 4 * 934 + 1), offset views
            # ``offset`` elements into their own buffers
            m, w = 37, 101
            return tuple(torch.randint(-3, 70, (m * w + offset,),
                                       generator=gen, device=dev,
                                       dtype=torch.int32)[offset:].view(m, w)
                         for _ in range(2))

        probe = ("(64, 256) f32 at (8, 128) int32, the probe's case",
                 *(a.to(dev) for a in probe_inputs()))
        cases = [probe,
                 (RECORD_CASE["gather2d"],
                  torch.rand((n, n), generator=gen, device=dev),
                  (ramp[:, None] + jitter()).clamp_(0, n - 1).contiguous(),
                  (ramp[None, :] + jitter()).clamp_(0, n - 1).contiguous()),
                 ("(64, 64) f32 at (37, 101) int32, MN % 4 = 1",
                  torch.rand((64, 64), generator=gen, device=dev),
                  *ragged(0)),
                 ("(64, 64) f32 at (37, 101) int32 offset views (+4 bytes)",
                  torch.rand((64, 64), generator=gen, device=dev),
                  *ragged(1))]
        for case, im, iy, ix in cases:
            got = gather2d(im, iy, ix)
            want = gather2d_ref(im, iy, ix)
            err = (got - want).abs().max().item()
            exact = torch.equal(got, want)
            log(f"  {case}: bit for bit {'ok' if exact else 'FAIL'} "
                f"(max_abs_err {err:.3e}; index bases at "
                f"{iy.data_ptr() % 16}/{ix.data_ptr() % 16} mod 16 bytes)")
            if not exact:
                raise AssertionError(f"K5 {case}: not bit for bit ({err})")
            errs["gather2d"] = max(errs["gather2d"], err)
            if case not in (probe[0], RECORD_CASE["gather2d"]):
                continue
            flat = im.reshape(-1)
            idx = iy.long() * im.shape[1] + ix.long()
            # no floating-point work: bound by the bytes alone
            library = lambda: torch.take(flat, idx)
            _record(times, "gather2d", case,
                    lambda: gather2d(im, iy, ix),
                    lambda: gather2d_ref(im, iy, ix), library,
                    _nbytes(im, iy, ix, got), 0, torch.float32)
            # a launch of a few microseconds from Python measures the
            # host's launch cost: both again from a CUDA graph
            times[("gather2d", case)].update(
                graph_ms=cuda_graph_ms(lambda: gather2d(im, iy, ix)),
                library_graph_ms=cuda_graph_ms(library))

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
            key = "attention" if dt == bf16 else "attention_f32"
            errs[key] = max(errs[key], err)
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
            key = "conv3x3" if dt == bf16 else "conv3x3_f32"
            errs[key] = max(errs[key], err)
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
        lib = f"{r['library_ms']:.4f} ms (kernel {r['ms'] / r['library_ms']:.2f}x " \
            f"of it)" if r["library_ms"] else "none"
        if "yardstick_ms" in r:
            lib += (f"; yardstick, the unfused path: {r['yardstick_ms']:.4f} "
                    f"ms (kernel {r['ms'] / r['yardstick_ms']:.2f}x of it)")
        if "graph_ms" in r:
            lib += (f"; from a CUDA graph: kernel {r['graph_ms']:.4f} ms, "
                    f"library {r['library_graph_ms']:.4f} ms (kernel "
                    f"{r['graph_ms'] / r['library_graph_ms']:.2f}x of it)")
        log(f"  {name} {case}: kernel {r['ms']:.4f} ms, plain twin "
            f"{r['plain_ms']:.4f} ms ({r['plain_ms'] / r['ms']:.2f}x), "
            f"library {lib}, bound {r['bound_ms']:.4g} ms ({r['bound_by']}, "
            f"{r['bound_ms'] / r['ms']:.1%} of it)")
    for case, aim in aims.items():
        r = times[("attention", case)]
        x = r["ms"] / r["library_ms"]
        log(f"[kernels] K1 {case}: {x:.2f}x scaled_dot_product_attention "
            f"(aim <= {aim:g}x: {'met' if x <= aim else 'NOT met'})")
    # K2's aim: bf16 within 2x of conv2d at the record case (reported)
    r = times[("conv3x3", RECORD_CASE["conv3x3"])]
    x = r["ms"] / r["library_ms"]
    log(f"[kernels] K2 {RECORD_CASE['conv3x3']}: {x:.2f}x conv2d, "
        f"{r['bound_ms'] / r['ms']:.1%} of its bound (aim <= 2x: "
        f"{'met' if x <= 2 else 'NOT met'})")
    # the f32 kernels' aims (reported, not enforced): ms within a range, or
    # below the library call
    for (name, case), (lo, hi) in F32_AIMS.items():
        r = times[(name, case)]
        hi = r["library_ms"] if hi is None else hi
        log(f"[kernels] {name} {case}: {r['ms']:.4f} ms, {r['ms'] / r['library_ms']:.2f}x "
            f"the library call, {r['bound_ms'] / r['ms']:.1%} of its bound at "
            f"165 TFLOP/s (aim {lo:g}-{hi:.4g} ms: "
            f"{'met' if lo <= r['ms'] <= hi else 'NOT met'})")
    state["kernel_errs"] = errs
    state["kernel_times"] = times


# ---------------------------------------------------------------- phase 2c
ADALN_CASES = ((8, 1024, 1152), (8, 1024, 384), (8, 1024, 4608))
# the H100's L2; the timed calls rotate over inputs and outputs of at least
# five times this, so that each call reads and writes device memory
L2_BYTES = 50 * 2 ** 20


def phase_adaln(state):
    import torch.nn.functional as F

    from dvd_tpu_torch.ops.kernels import adaln

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(22)
    log(f"[adaln] bf16, CUDA events, mean of 20 launches, from Python and "
        f"from a CUDA graph ({state['label']}); each call on the next of k "
        f"sets of inputs and outputs, >= 5x the 50 MB L2 in all; bound = "
        f"bytes / 3.35 TB/s; the plain twin is today's eager chain:")
    for shape in ADALN_CASES:
        n, _, d = shape
        x_bytes = math.prod(shape) * 2
        k = max(2, math.ceil(5 * L2_BYTES / (2 * x_bytes)))
        xs = [(torch.randn(shape, generator=gen, device=dev) * 2 + 0.5)
              .to(bf16) for _ in range(k)]
        ys = [torch.randn(shape, generator=gen, device=dev).to(bf16)
              for _ in range(k)]
        shift, scale, gate = (torch.randn(n, 6 * d, generator=gen, device=dev)
                              * 0.5).to(bf16).chunk(6, dim=-1)[:3]
        x, y = xs[0], ys[0]
        norm = F.layer_norm(x.float(), (d,), eps=adaln.EPS)
        cond = n * d * 2
        cases = {
            "ln_modulate": (
                lambda i: adaln.ln_modulate(xs[i], shift, scale),
                lambda i: adaln.ln_modulate_ref(xs[i], shift, scale),
                norm * (1 + scale.float()[:, None]) + shift.float()[:, None],
                2 * x_bytes + 2 * cond),
            "gate_residual": (
                lambda i: adaln.gate_residual(xs[i], gate, ys[i]),
                lambda i: adaln.gate_residual_ref(xs[i], gate, ys[i]),
                x.float() + gate.float()[:, None] * y.float(),
                3 * x_bytes + cond)}
        for name, (fn, plain, ref, nbytes) in cases.items():
            entry = getattr(adaln, name)
            before = entry.launches
            got = fn(0)
            torch.cuda.synchronize()
            if entry.launches != before + 1:
                raise AssertionError(f"{name}: {entry.launches - before} "
                                     "launches, not 1")
            compare(f"{name} {shape}", got, ref, 2.0 ** -8, rel=True)
            del got
            r = dict(ms=_rotated_ms(fn, k, cuda_time_ms),
                     graph_ms=_rotated_ms(fn, k, cuda_graph_ms),
                     plain_ms=_rotated_ms(plain, k, cuda_time_ms),
                     plain_graph_ms=_rotated_ms(plain, k, cuda_graph_ms),
                     bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
            log(f"  {name} {shape} over {k} sets: kernel {r['ms']:.4f} ms, "
                f"graph {r['graph_ms']:.4f} ms ({r['graph_ms'] / r['bound_ms']:.2f}x "
                f"its bound {r['bound_ms']:.4f} ms); plain twin "
                f"{r['plain_ms']:.4f} ms, graph {r['plain_graph_ms']:.4f} ms "
                f"({r['plain_graph_ms'] / r['graph_ms']:.2f}x the kernel)")
        del xs, ys


def _rotated_ms(call, k: int, timer) -> float:
    """``timer``'s ms for ``call(i)`` on input set i = 0, 1, ..., k - 1, 0,
    ...; each result is held until the call k later replaces it, so the
    outputs rotate over k blocks too."""
    ring, turn = [None] * k, iter(range(10 ** 9))

    def fn():
        i = next(turn) % k
        ring[i] = call(i)

    ms = timer(fn)
    ring.clear()
    return ms


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


# the serving path runs K1-K3 (K4 is the training loss's backward): K3 as
# the two feature re-warps through its grid entry and the unwarp through
# the fused kernel; and the DiT's adaLN kernels (a block-step's shared
# norm and each of its 4 streams' two pre-norms, the final layer's
# pre-norm; each stream's two gated residuals; 3 DDIM steps); one shipped
# main-path run launches them exactly this often
SERVE_LAUNCHES = {"attention": 42, "conv3x3": 261, "gather_bilinear": 2,
                  "unwarp": 1, "gather_bilinear_grad": 0, "gather2d": 0,
                  "ln_modulate": 30, "gate_residual": 24}


def _kernel_fns():
    """Each kernel's wrapper, K3 by its two entries (the pixel planes, the
    [-1, 1] grid) into one kernel body."""
    from dvd_tpu_torch.ops.kernels.adaln import gate_residual, ln_modulate
    from dvd_tpu_torch.ops.kernels.attention import attention
    from dvd_tpu_torch.ops.kernels.conv3x3 import conv3x3
    from dvd_tpu_torch.ops.kernels.gather2d import gather2d
    from dvd_tpu_torch.ops.kernels.grid_sample import (gather_bilinear,
                                                       gather_bilinear_grad,
                                                       gather_bilinear_grid)
    from dvd_tpu_torch.ops.kernels.unwarp import unwarp

    return {"attention": attention, "conv3x3": conv3x3,
            "gather_bilinear": (gather_bilinear, gather_bilinear_grid),
            "unwarp": unwarp, "gather_bilinear_grad": gather_bilinear_grad,
            "gather2d": gather2d, "ln_modulate": ln_modulate,
            "gate_residual": gate_residual}


# the kernels with two routes: bf16 through wgmma, f32 through the split
# products (both on the tensor cores)
ROUTED = ("attention", "conv3x3")


def reset_launches() -> None:
    from dvd_tpu_torch.ops import quant

    fns = _kernel_fns()
    for fn in fns.values():
        for f in fn if isinstance(fn, tuple) else (fn,):
            f.launches = 0
    for name in ROUTED:
        fns[name].launches_wgmma = fns[name].launches_f32 = 0
    fns["attention"].launches_by_dh.clear()
    fns["attention"].launches_padded.clear()
    quant.launches = 0          # the int8 GEMM (a library call)


def read_launches() -> dict:
    return {name: sum(f.launches for f in fn) if isinstance(fn, tuple)
            else fn.launches for name, fn in _kernel_fns().items()}


def attention_by_dh() -> dict:
    """K1's launches since the last reset by the instance's head dim."""
    return dict(sorted(_kernel_fns()["attention"].launches_by_dh.items()))


def routes(name: str) -> dict:
    """A routed kernel's launches by route."""
    fn = _kernel_fns()[name]
    return {"wgmma": fn.launches_wgmma, "f32": fn.launches_f32}


@contextlib.contextmanager
def vgg_k2_counter(vgg, record: dict):
    """While open, adds the K2 launches that the VGG16 pyramid ``vgg``
    (None: nothing) makes inside its forward calls to ``record``, by
    route, through hooks on the module, removed on exit."""
    if vgg is None:
        yield record
        return
    k2 = _kernel_fns()["conv3x3"]
    before = {}

    def now():
        return {"wgmma": k2.launches_wgmma, "f32": k2.launches_f32}

    def pre(module, args):
        before.update(now())

    def post(module, args, out):
        for r, n in now().items():
            record[r] = record.get(r, 0) + n - before[r]

    hooks = (vgg.register_forward_pre_hook(pre),
             vgg.register_forward_hook(post))
    try:
        yield record
    finally:
        for h in hooks:
            h.remove()


def gather_routes() -> dict:
    """K3's launches by entry: the [-1, 1] grid or the pixel planes."""
    planes, grid = _kernel_fns()["gather_bilinear"]
    return {"grid": grid.launches, "planes": planes.launches}


def check_gather_route(what: str) -> dict:
    """Every K3 launch since the last reset took the grid entry (the main
    paths' warps; the unwarps have their own kernel)."""
    n, r = read_launches()["gather_bilinear"], gather_routes()
    log(f"[{what}] K3 by entry {r} of {n} launches; fused unwarp "
        f"{read_launches()['unwarp']}")
    if r != {"grid": n, "planes": 0}:
        raise AssertionError(f"{what}: K3 entries {r} of {n} launches")
    return r


def check_conv_route(what: str, dtype) -> dict:
    """Every K2 launch since the last reset took ``dtype``'s route: bf16
    the wgmma kernel, f32 the split-product one."""
    n, r = read_launches()["conv3x3"], routes("conv3x3")
    want = {"wgmma": n, "f32": 0} if dtype == torch.bfloat16 else \
        {"wgmma": 0, "f32": n}
    log(f"[{what}] K2 by route {r} of {n} launches ({str(dtype)[6:]}: "
        f"{'wgmma' if dtype == torch.bfloat16 else 'split products'})")
    if r != want or n <= 0:
        raise AssertionError(f"{what}: K2 routes {r}, expected {want}")
    return r


def conv_class(x, w, dilation) -> tuple:
    """A K2 call's shape class: (B, Cin, Cout, H, W, dilation)."""
    return (*x.shape[:2], w.shape[0], *x.shape[2:], int(dilation))


@contextlib.contextmanager
def conv_shape_counter(shapes: Counter):
    """While open, counts the models' K2 calls into ``shapes`` by shape
    class, each passed on as it was: the frozen aux nets' (through
    ``layers.conv3x3``) and the trainable pyramid's (through
    ``layers.conv3x3_trainable``).  Patched here, never in the package."""
    from dvd_tpu_torch.models import layers

    frozen, trainable = layers.conv3x3, layers.conv3x3_trainable

    def counted(x, w, scale, bias, dilation=1, relu=True, wk=None):
        shapes[conv_class(x, w, dilation)] += 1
        return frozen(x, w, scale, bias, dilation, relu, wk)

    def counted_trainable(x, w, bias, dilation=1, relu=True):
        shapes[conv_class(x, w, dilation)] += 1
        return trainable(x, w, bias, dilation, relu)

    layers.conv3x3, layers.conv3x3_trainable = counted, counted_trainable
    try:
        yield shapes
    finally:
        layers.conv3x3, layers.conv3x3_trainable = frozen, trainable


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


def _slice_card_vs_cpu(cfg, tag: str, codes=None):
    """The serving slice of ``cfg`` at batch 1 and 512^2 from one weight
    set (drawn on the CPU from one seed) and one pinned x_T: on the card
    through the kernels (counted, K2 and K3 routes checked) and on the CPU
    through the twins; flow and unwarped image compared.  ``codes(dev)``,
    when given, is a context manager around each run.  The card run's
    int8 products must equal the code's count (0 without int8)."""
    from dvd_tpu_torch.evaluation.pipeline import DewarpPipeline, unwarp_fixed
    from dvd_tpu_torch.ops import quant

    m = cfg.model
    gen = torch.Generator().manual_seed(SEED + 1)
    src = _page(1, m.source_size, m.source_size, gen)
    noise = torch.randn((cfg.diffusion.n_batch, m.image_size, m.image_size, 2),
                        generator=gen)
    pipes = {dev: DewarpPipeline.create(
        cfg, dev, generator=torch.Generator().manual_seed(SEED + 2))
        for dev in ("cpu", "cuda")}
    for pipe in pipes.values():
        # a small final projection keeps the flow inside the [-1, 1] clamp,
        # so the comparison below sees it rather than the clamp
        with torch.no_grad():
            pipe.dit.final.linear.weight.mul_(0.1)
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
        with codes(dev) if codes else contextlib.nullcontext(), \
                vgg_k2_counter(pipe.vgg, {"wgmma": 0, "f32": 0}) as vgg_k2:
            flow = pipe.dewarp_flow(src.to(dev), init_noise=noise.to(dev))
            image = unwarp_fixed(src.to(dev), flow)
        if dev == "cuda":
            torch.cuda.synchronize()
            counts = dict(read_launches(), int8=quant.launches,
                          int8_expected=_int8_expected(pipe),
                          attention_routes=routes("attention"),
                          attention_by_dh=attention_by_dh(), vgg_k2=vgg_k2)
            check_conv_route(tag, torch.float32)
            check_gather_route(tag)
            if m.use_init_flow:   # GeoTr's offsets, as the DiT receives them
                with torch.inference_mode():
                    f0 = pipe.build_conditioning(src.cuda())[1]
                log(f"[{tag}] init_flow (GeoTr's map / {m.perception_size - 1}"
                    f", at the latent size) in [{f0.min().item():.4f}, "
                    f"{f0.max().item():.4f}], mean |.| "
                    f"{f0.abs().mean().item():.4f}")
        runs[dev] = (flow.cpu(), image.cpu())
        log(f"[{tag}] {dev}: {m.dit_variant} {m.compute_dtype} "
            f"quantize={m.quantize} batch 1, {m.source_size}^2, "
            f"{cfg.diffusion.diffusion_steps} steps x {cfg.diffusion.n_batch} "
            f"hypotheses in {time.perf_counter() - t0:.2f} s (outconv bias "
            f"shift {shift:+.3f}, soft-mask margin {margin:.3f})")
    del pipes
    log(f"[{tag}] kernel launches in the card run: {counts}")
    if min(counts[k] for k in SERVE_LAUNCHES if SERVE_LAUNCHES[k]) <= 0 \
            or counts["int8"] != counts["int8_expected"]:
        raise AssertionError(f"a kernel of the path did not launch, or "
                             f"int8 launches off the code's count: {counts}")
    (fc, ic), (fp, ip) = runs["cuda"], runs["cpu"]
    if not (torch.isfinite(fc).all() and fc.abs().max() <= 1):
        raise AssertionError("card flow not finite or outside [-1, 1]")
    log(f"[{tag}] flow |max| {fc.abs().max().item():.4f}, mean |flow| "
        f"{fc.abs().mean().item():.4f}, clamped at +-1: "
        f"{(fc.abs() >= 1).float().mean().item():.2%}")
    compare(f"{tag} flow card vs CPU", fc, fp, TOL["slice_flow"])
    compare(f"{tag} unwarped image card vs CPU", ic, ip, TOL["slice_image"])
    return counts


def phase_slice32(state):
    from dvd_tpu_torch.config import default_config

    _slice_card_vs_cpu(default_config().replace(
        model={"compute_dtype": "float32"}, diffusion={"n_batch": 2}),
        "slice32")


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
    check_conv_route("shipped", torch.bfloat16)
    check_gather_route("shipped")
    k1_routes = routes("attention")
    log(f"[shipped] kernel launches in one main-path run: "
        f"{state['serve_launches']}; K1 by route {k1_routes}")
    if state["serve_launches"] != SERVE_LAUNCHES:
        raise AssertionError(f"serving launches {state['serve_launches']}, "
                             f"expected {SERVE_LAUNCHES}")
    if k1_routes != {"wgmma": SERVE_LAUNCHES["attention"], "f32": 0}:
        raise AssertionError(f"K1 routes {k1_routes}: bf16 serving must run "
                             f"every attention through wgmma")
    if flow.shape != (batch, m.image_size, m.image_size, 2) \
            or out.shape != src.shape:
        raise AssertionError(f"shapes flow {tuple(flow.shape)} "
                             f"out {tuple(out.shape)}")
    if not (torch.isfinite(flow).all() and torch.isfinite(out).all()
            and flow.abs().max() <= 1):
        raise AssertionError("shipped outputs not finite / flow outside [-1, 1]")
    log(f"[shipped] flow |max| {flow.abs().max().item():.4f}; unwarped "
        f"image range [{out.min().item():.3f}, {out.max().item():.3f}]")
    # the main run's pages and outputs: shipped_int8 and score read them
    state["shipped"] = dict(src=src.cpu(), out=out.cpu(), flow=flow.cpu(),
                            peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    log(f"[shipped] peak device memory of the main-path run (weights "
        f"included) {state['shipped']['peak_gib']:.3f} GiB")
    k1_bar = _flow_vs_attention_twin(pipe, src, flow)
    shapes = _flow_vs_conv_twin(pipe, src, flow, k1_bar)
    _tf32_default_run(pipe, src, flow)
    _time_conv_classes(shapes, state["label"])

    # the CLI's array function on a 600x450 page (the unwarp runs K3 at a
    # size the TPU kernel's gate rejects)
    page = (_page(1, 450, 600, gen)[0] * 255).round().numpy()
    before = read_launches()["unwarp"]
    out_img, out_flow = dewarp_image(pipe, page, seed=SEED)
    torch.cuda.synchronize()
    if out_img.shape != (450, 600, 3) or out_flow.shape != (m.image_size, m.image_size, 2) \
            or not np.isfinite(out_img).all() or np.abs(out_flow).max() > 1:
        raise AssertionError("CLI outputs malformed")
    if read_launches()["unwarp"] <= before:
        raise AssertionError("the CLI unwarp did not launch the fused kernel")
    log(f"[shipped] cli dewarp_image 600x450 page: {out_img.shape}, the "
        f"fused unwarp launched {read_launches()['unwarp'] - before}x")


def _flow_vs_attention_twin(pipe, src, flow):
    """The shipped bf16 flow again, from the same x_T, with the models'
    attention bound to its plain twin (patched here, never in the
    package), and once more with the twin's p kept in f32.  The kernel and
    the twin each round p to bf16 (the twin the normalised p, the kernel p
    relative to its running max), and three random-weight DDIM steps
    amplify any such rounding, so the kernel's |dflow| against the twin is
    held to twice what the twin's own bf16 cast of p moves the flow by,
    and the 3e-2 aim is reported beside it."""
    from dvd_tpu_torch.models import layers
    from dvd_tpu_torch.ops.kernels.attention import attention_ref

    def twin(q, k, v, scale=None):
        return attention_ref(q, k, v, 1.0 / math.sqrt(q.shape[-1])
                             if scale is None else scale)

    def twin_f32_p(q, k, v, scale=None):
        return twin(q.float(), k.float(), v.float(), scale).to(q.dtype)

    flows = {"K1": flow}
    kernel_attention = layers.attention
    try:
        for name, fn in (("twin", twin), ("twin, p in f32", twin_f32_p)):
            layers.attention = fn
            before = read_launches()["attention"]
            flows[name] = pipe.dewarp_flow(
                src, generator=torch.Generator(device="cuda").manual_seed(SEED + 5))
            torch.cuda.synchronize()
            if read_launches()["attention"] != before:
                raise AssertionError(f"the {name} run launched K1")
    finally:
        layers.attention = kernel_attention
    dmax = {}
    for a, b in (("K1", "twin"), ("twin, p in f32", "twin"),
                 ("K1", "twin, p in f32")):
        d = (flows[a].float() - flows[b].float()).abs()
        dmax[a, b] = d.max().item()
        log(f"[shipped] bf16 flow, {a} vs {b} (same weights and x_T): max "
            f"|dflow| {dmax[a, b]:.3e}, mean {d.mean().item():.3e}, above "
            f"1e-2 at {(d > 1e-2).float().mean().item():.2%}")
    err, noise = dmax["K1", "twin"], dmax["twin, p in f32", "twin"]
    bar = 2 * noise
    ok = math.isfinite(err) and err <= bar
    log(f"[shipped] K1 vs twin {err:.3e}: bar 2 x the twin's own p rounding "
        f"({noise:.3e}) = {bar:.3e} {'ok' if ok else 'FAIL'}; the 3e-2 aim "
        f"{'met' if err <= TOL['flow_twin'] else 'NOT met'}")
    if not ok:
        raise AssertionError(f"flow with K1 vs the twin: {err:.3e} > {bar:.3e}")
    return bar


@contextlib.contextmanager
def eager_conditioning(pipe):
    """While open, the pipeline's conditioning networks run eagerly
    (their CUDA graphs dropped, ``utils/graphs.py``), so that a kernel
    binding patched here reaches them; closed, they warm and capture
    again."""
    from dvd_tpu_torch.evaluation.pipeline import graphed_nets
    from dvd_tpu_torch.utils import graphs

    on = {n: m for n, m in graphed_nets(pipe.geotr, pipe.seg,
                                        pipe.line).items()
          if graphs.graphs_of(m) is not None}
    for m in on.values():
        graphs.disable(m)
    try:
        yield
    finally:
        for n, m in on.items():
            graphs.enable(m, n)


def _flow_vs_conv_twin(pipe, src, flow, k1_bar):
    """The shipped bf16 flow again, from the same x_T, with the models'
    K2 (``layers.conv3x3``, patched here, never in the package) bound to
    its plain twin, and once more to the twin with the input channels
    reversed (``x.flip(1)`` with ``w.flip(1)``: the same function, its f32
    sums in another order, the only kind of difference the kernel may
    make).  The kernel's |dflow| against the twin is held to twice that
    channel-order effect; should it read 0, to K1's bar.  Also counts the
    serving path's K2 launches by shape class."""
    from dvd_tpu_torch.models import layers
    from dvd_tpu_torch.ops.kernels.conv3x3 import conv3x3_ref

    shapes = Counter()

    def twin(x, w, scale, bias, dilation=1, relu=True, wk=None):
        shapes[conv_class(x, w, dilation)] += 1
        return conv3x3_ref(x, w, scale, bias, dilation, relu)

    def twin_flipped(x, w, scale, bias, dilation=1, relu=True, wk=None):
        return conv3x3_ref(x.flip(1), w.flip(1), scale, bias, dilation, relu)

    flows = {"K2": flow}
    kernel_conv = layers.conv3x3
    try:
        with eager_conditioning(pipe):
            for name, fn in (("twin", twin),
                             ("twin, channels reversed", twin_flipped)):
                layers.conv3x3 = fn
                before = read_launches()["conv3x3"]
                flows[name] = pipe.dewarp_flow(src, generator=torch.Generator(
                    device="cuda").manual_seed(SEED + 5))
                torch.cuda.synchronize()
                if read_launches()["conv3x3"] != before:
                    raise AssertionError(f"the {name} run launched K2")
    finally:
        layers.conv3x3 = kernel_conv
    log(f"[shipped] K2 launches of one serving run by shape class, (B, Cin, "
        f"Cout, H, W, dilation): {dict(sorted(shapes.items()))}")
    if sum(shapes.values()) != SERVE_LAUNCHES["conv3x3"]:
        raise AssertionError(f"the twin run made {sum(shapes.values())} K2 calls")
    dmax = {}
    for a, b in (("K2", "twin"), ("twin, channels reversed", "twin")):
        d = (flows[a].float() - flows[b].float()).abs()
        dmax[a, b] = d.max().item()
        log(f"[shipped] bf16 flow, {a} vs {b} (same weights and x_T): max "
            f"|dflow| {dmax[a, b]:.3e}, mean {d.mean().item():.3e}, above "
            f"1e-2 at {(d > 1e-2).float().mean().item():.2%}")
    err, noise = dmax["K2", "twin"], dmax["twin, channels reversed", "twin"]
    bar = 2 * noise if noise > 0 else k1_bar
    ok = math.isfinite(err) and err <= bar
    log(f"[shipped] K2 vs twin {err:.3e}: bar "
        + (f"2 x the twin's own channel-order effect ({noise:.3e})" if noise > 0
           else "K1's (the channel-order effect reads 0)")
        + f" = {bar:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"flow with K2 vs the twin: {err:.3e} > {bar:.3e}")
    return shapes


def _tf32_default_run(pipe, src, flow_off):
    """The shipped batch once more under torch's default TF32 switches
    (``cudnn.allow_tf32`` True, ``cuda.matmul.allow_tf32`` False), as the
    shipped entry points run it, against this phase's switch-off run from
    the same x_T: U2NetP's soft mask d0 and the line UNet's ``outc`` (both
    ``conv1x1_f32``, an f32 matmul that the cuDNN switch does not reach)
    within one f32 rounding of their largest value (both are bf16 in the
    shipped run, so any change would be a bf16 step: the bar asks for
    equality), the flow within the ``flow_twin`` bar."""
    from dvd_tpu_torch.ops.resize import resize_bilinear

    per = pipe.cfg.model.perception_size

    def run():
        with torch.inference_mode():
            xa = resize_bilinear(src.permute(0, 3, 1, 2).contiguous(),
                                 (per, per), True).to(pipe.dtype).contiguous()
            d0 = pipe.seg.msk(xa)[0].float()
            outc = pipe.line(pipe.seg(xa)[0])[1].float()
            flow = pipe.dewarp_flow(src, generator=torch.Generator(
                device="cuda").manual_seed(SEED + 5))
            torch.cuda.synchronize()
        return d0, outc, flow

    off = run()
    torch.backends.cudnn.allow_tf32 = True
    try:
        log(f"[shipped] torch's default switches: cudnn.allow_tf32="
            f"{torch.backends.cudnn.allow_tf32} cuda.matmul.allow_tf32="
            f"{torch.backends.cuda.matmul.allow_tf32}")
        on = run()
    finally:
        torch.backends.cudnn.allow_tf32 = False
    for name, a, b in (("U2NetP d0", on[0], off[0]),
                       ("line UNet outc", on[1], off[1])):
        compare(f"{name}, TF32 default vs off", a, b,
                TOL["conv1x1_f32_rel"], rel=True)
    compare("flow, TF32 default vs off (same weights and x_T)", on[2],
            off[2], TOL["flow_twin"])


def _time_conv_classes(shapes: Counter, label: str, tag: str = "shipped",
                       dtype=torch.bfloat16) -> dict:
    """Every K2 shape class of one serving run, on fresh inputs in
    ``dtype``: the kernel against its twin (the phase-2 bar), then its
    time beside ``conv2d``'s (f32: TF32 off) and its bound, and the sums
    over the run's launches (``bytes``: the bound's part from the classes
    bound by bytes; ``max_err``: the largest error against the twin)."""
    import torch.nn.functional as F

    from dvd_tpu_torch.ops.kernels.conv3x3 import (conv3x3, conv3x3_ref,
                                                   k_major_weights,
                                                   k_major_weights_split)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    f32 = dtype == torch.float32
    log(f"[{tag}] K2 by shape class, {str(dtype)[6:]}, mean of 20 calls in a "
        f"CUDA graph ({label}): kernel ms, conv2d ms, bound ms (by), launches "
        f"per serving run; then the kernel's ms per call back to back from "
        f"Python (the host's launch cost included) and the plain twin's ms "
        f"in a CUDA graph")
    total, max_err = Counter(), 0.0
    for (b, cin, cout, h, w, d), n in sorted(shapes.items()):
        x, wt, s, bi = _conv_case(b, cin, cout, (h, w), dtype, gen, "cuda")
        # f32: the split weights, once per weight set as the fold cache
        # keeps them
        wk = (k_major_weights_split if f32 else k_major_weights)(wt)
        bl = bi.to(dtype)
        got = conv3x3(x, wt, s, bi, d, True, wk)
        want = conv3x3_ref(x, wt, s, bi, d, True)
        ref = want.float().abs().max().item()
        bar = TOL["conv3x3_f32_rel"] * ref if f32 else TOL["bf16"] * max(1.0, ref)
        err = (got.float() - want.float()).abs().max().item()
        if not err <= bar:
            raise AssertionError(f"K2 {cin}->{cout} @{h}x{w} d{d} b{b}: "
                                 f"{err:.3e} > {bar:.3e}")
        max_err = max(max_err, err)
        ms = cuda_graph_ms(lambda: conv3x3(x, wt, s, bi, d, True, wk))
        lib = cuda_graph_ms(lambda: F.conv2d(x, wt, bl, 1, d, d))
        eager = cuda_time_ms(lambda: conv3x3(x, wt, s, bi, d, True, wk))
        plain = cuda_graph_ms(lambda: conv3x3_ref(x, wt, s, bi, d, True))
        by_bytes = _nbytes(x, wt, s, bi, got) / HBM_BYTES_PER_S * 1e3
        by_ops = 18 * b * cin * cout * h * w / PEAK_FLOPS[dtype] * 1e3
        bound = max(by_bytes, by_ops)
        total.update(kernel=n * ms, conv2d=n * lib, bound=n * bound,
                     eager=n * eager, plain=n * plain,
                     bytes=n * bound if by_bytes >= by_ops else 0.0)
        log(f"  {cin}->{cout} @{h}x{w} d{d} b{b}: {ms:.4f} {lib:.4f} "
            f"{bound:.3g} ({'bytes' if by_bytes >= by_ops else 'operations'}) "
            f"x{n}; {eager:.4f}; {plain:.4f}")
    log(f"[{tag}] K2 over one serving run's {sum(shapes.values())} launches, "
        f"summed from the classes: kernel {total['kernel']:.3f} ms, conv2d "
        f"{total['conv2d']:.3f} ms ({total['kernel'] / total['conv2d']:.2f}x), "
        f"bound {total['bound']:.4f} ms; back to back from Python "
        f"{total['eager']:.3f} ms; plain twin {total['plain']:.3f} ms ({label})")
    return dict(total, max_err=max_err)


# ---------------------------------------------------------------- phases 5-6
def _wire_batch_flow(b: int, gen: torch.Generator, amp: float,
                     hw: int = 512) -> torch.Tensor:
    """Smooth random absolute flows (B, hw, hw, 2) of about ``amp`` pixels:
    a sum of three low sinusoids per channel."""
    yy, xx = torch.meshgrid(torch.linspace(0, 1, hw), torch.linspace(0, 1, hw),
                            indexing="ij")
    a = torch.randn((b, 2, 3), generator=gen) * amp
    f = torch.rand((b, 2, 3, 3), generator=gen) * 3
    out = sum(a[..., i, None, None] * torch.sin(
        2 * math.pi * (f[..., i, 0, None, None] * xx
                       + f[..., i, 1, None, None] * yy
                       + f[..., i, 2, None, None])) for i in range(3))
    return out.permute(0, 2, 3, 1).contiguous()


def _wire_batch(b: int, gen: torch.Generator) -> dict:
    """A seeded synthetic float-wire batch (CPU tensors): document photos
    with their page mask, and smooth absolute flows (pixels) for the GT
    and the intermediate backward maps."""
    hw = 512
    src = _page(b, hw, hw, gen)
    yy, xx = torch.meshgrid(torch.linspace(0, 1, hw), torch.linspace(0, 1, hw),
                            indexing="ij")
    page = ((xx > 0.08) & (xx < 0.92) & (yy > 0.06) & (yy < 0.94)).float()
    return {"source_image": src,
            "doc_mask": page[None, ..., None].expand(b, hw, hw, 1).contiguous(),
            "flow_map": _wire_batch_flow(b, gen, 12.0),
            "flow_map_inter": _wire_batch_flow(b, gen, 6.0)}


class StandInRawPages:
    """``n`` seeded raw training items in the Doc3D datasets' ``device_aug``
    form (the card's machine has no cv2 or h5py to read Doc3D files):
    ``image512`` a document photo in [0, 255] with fractional levels,
    ``doc_mask512`` the page with soft edges (a few pixels' ramp) in
    [0, 1], ``flow_map`` a smooth backward-map offset field of some
    pixels.  The items are drawn when the set is made, so a loader's
    ``__getitem__(i, seed)`` costs only the lookup."""

    def __init__(self, n: int, seed: int):
        hw = 512
        gen = torch.Generator().manual_seed(seed)
        yy, xx = torch.meshgrid(torch.linspace(0, 1, hw),
                                torch.linspace(0, 1, hw), indexing="ij")

        def ramp(x):        # 0 -> 1 over about five pixels
            return (x * hw / 5).clamp(0, 1)

        self.samples = list(range(n))
        self.items = []
        for _ in range(n):
            m = torch.rand((4,), generator=gen) * 0.04 + 0.05  # margins
            mask = (ramp(xx - m[0]) * ramp(1 - m[1] - xx) * ramp(yy - m[2])
                    * ramp(1 - m[3] - yy))
            flow = _wire_batch_flow(1, gen, 12.0)[0]
            self.items.append({
                "image512": (_page(1, hw, hw, gen)[0] * 255).numpy(),
                "doc_mask512": mask[..., None].numpy(),
                "flow_map": flow.numpy()})

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, i: int, seed=None) -> dict:
        return self.items[i]


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

    counts = _train_card_vs_cpu(default_config().replace(
        model={"compute_dtype": "float32"}, train={"on_device_aug": False}),
        "train32")
    state["train32_launches"] = dict(
        counts, attention_f32=counts["attention_routes"]["f32"],
        conv3x3_f32=counts["conv3x3_routes"]["f32"])


def _train_card_vs_cpu(cfg, tag: str) -> dict:
    """One f32 train step of ``cfg`` at batch 2 and 512^2: its loss and
    every gradient on the card through the kernels (K1-K4 launched, K2
    and K3 routes checked) against the CPU through the twins, from the
    same weights (the zero-initialised layers drawn small), batch, t and
    noise, dropout off; returns the card run's launches."""
    from dvd_tpu_torch.evaluation.pipeline import DewarpPipeline
    from dvd_tpu_torch.training.train_loop import build_device_batch
    from dvd_tpu_torch.training.train_state import (create_train_state,
                                                    make_train_step)

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
    runs, loss_warp = {}, {}
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
        with vgg_k2_counter(pipe.vgg, {"wgmma": 0, "f32": 0}) as vgg_k2:
            batch = build_device_batch(
                pipe, {k: v.to(dev) for k, v in raw.items()}, m.image_size)
            with _loss_warp_points(loss_warp, dev):
                grads, _, metrics = step.loss_and_grads(
                    train_state, batch, None, t=t, noise=noise,
                    rollout_noise=rollout_noise)
        if dev == "cuda":
            torch.cuda.synchronize()
            counts = dict(read_launches(), attention_routes=routes("attention"),
                          conv3x3_routes=routes("conv3x3"), vgg_k2=vgg_k2)
            check_conv_route(tag, torch.float32)
            check_gather_route(tag)
        names = list(train_state.named_params())
        runs[dev] = (metrics["loss"].item(),
                     {k: g.detach().cpu() for k, g in zip(names, grads)})
        log(f"[{tag}] {dev}: {m.dit_variant} float32 batch {b}, 512^2, "
            f"t={t.tolist()}, loss and gradients in "
            f"{time.perf_counter() - t0:.2f} s (outconv bias shift "
            f"{shift:+.3f}, soft-mask margin {margin:.3f})")
    del pipes
    log(f"[{tag}] the loss warp's points, card vs CPU: max |d| "
        f"{loss_warp['max_d']:.3e} of the [-1, 1] grid (bar "
        f"{TOL['train_points']:.0e}); {loss_warp['crossed']} of "
        f"{loss_warp['n']} fell in another corner cell on the CPU and took "
        f"the card's coordinates there for K4's twin")
    if not loss_warp["max_d"] <= TOL["train_points"]:
        raise AssertionError(f"{tag} loss-warp points differ by "
                             f"{loss_warp['max_d']:.3e}")
    log(f"[{tag}] kernel launches in the card run: {counts}")
    if min(counts[k] for k in TRAIN_KERNELS) <= 0:
        raise AssertionError(f"a kernel of the path did not launch: {counts}")
    (lc, gc), (lp, gp) = runs["cuda"], runs["cpu"]
    rel = abs(lc - lp) / max(abs(lp), 1e-30)
    log(f"[{tag}] loss card {lc:.8f} CPU {lp:.8f}: relative "
        f"{rel:.3e} (bar {TOL['train_loss_rel']:.0e}) "
        f"{'ok' if rel <= TOL['train_loss_rel'] else 'FAIL'}")
    if not (math.isfinite(lc) and rel <= TOL["train_loss_rel"]):
        raise AssertionError(f"{tag} loss: card {lc} vs CPU {lp}")
    worst = (0.0, "")
    for k, want in gp.items():
        bar = TOL["train_grad"] * max(1.0, want.abs().max().item())
        err = (gc[k] - want).abs().max().item()
        if not (math.isfinite(err) and err <= bar):
            raise AssertionError(f"{tag} gradient {k}: {err:.3e} > {bar:.3e}")
        worst = max(worst, (err / bar, k))
    nz = sum(int(g.abs().max() > 0) for g in gp.values())
    log(f"[{tag}] {len(gp)} gradient tensors ({nz} nonzero) within "
        f"{TOL['train_grad']:.0e} x max(1, max|g|); the closest to its bar: "
        f"{worst[1]} at {worst[0]:.3f} of it")
    return counts


def _cells(img, grid):
    """The bilinear cell (x, y floor in pixels) of each [-1, 1] point."""
    from dvd_tpu_torch.ops.kernels.grid_sample import unnormalize

    h, w = img.shape[-2:]
    return torch.stack([torch.floor(unnormalize(grid[..., 0], w)),
                        torch.floor(unnormalize(grid[..., 1], h))], -1)


@contextlib.contextmanager
def _loss_warp_points(record: dict, dev: str):
    """While open, the loss warp's backward (K4 on the card, its twin on
    the CPU; ``warp_const_src``, patched here, never in the package) is
    recorded on the card and aligned on the CPU.

    The bilinear gather's derivative jumps where a point crosses into
    another corner cell: by the whole edge value where a corner leaves the
    'zeros' padding (for the loss's 512^2 field and its cotangent about
    1e-3, against gradients of 1e-2).  The card's and the CPU's points
    differ by their f32 rounding through the DiT and the rollout (about
    3e-5 of the grid), so now and then one lands on each side of a cell
    edge and the two gradients differ by that jump, a measure-zero event
    and no fault of either side.  So where the CPU's point is in another
    cell than the card's, the CPU's K4 twin takes the card's point; every
    other point, and the forward, stay the CPU's own.  The points
    themselves are held to ``train_points``."""
    from dvd_tpu_torch.ops import grid_sample as gs
    kernel = gs.gather_bilinear_grad

    def on_card(img, grid, ct, padding_mode="zeros"):
        record["grid"], record["cells"] = grid.cpu(), _cells(img, grid).cpu()
        return kernel(img, grid, ct, padding_mode)

    def on_cpu(img, grid, ct, padding_mode="zeros"):
        crossed = (_cells(img, grid) != record["cells"]).any(-1, keepdim=True)
        record["max_d"] = (grid - record["grid"]).abs().max().item()
        record["crossed"] = int(crossed.sum())
        record["n"] = crossed.numel()
        grid = torch.where(crossed, record["grid"], grid)
        return kernel(img, grid, ct, padding_mode)

    gs.gather_bilinear_grad = on_card if dev == "cuda" else on_cpu
    try:
        yield
    finally:
        gs.gather_bilinear_grad = kernel


def _row_logger():
    """A KVLogger that writes nothing and keeps each dumped row in
    ``rows``."""
    from dvd_tpu_torch.utils.logger import KVLogger

    class Rows(KVLogger):
        def dumpkvs(self, step=None):
            out = super().dumpkvs(step)
            self.rows.append(out)
            return out

    logger = Rows(None, formats=())
    logger.rows = []
    return logger


# the stand-in raw training set: its 32 samples stage on the card (about
# 3.9 MB each) and span three epochs of batch 10 in phase 6's 22 steps
TRAIN_SET = 32


def phase_train(state):
    from dvd_tpu_torch.cli.run_training import (_device_dataset_ok,
                                                device_resident_iterator)
    from dvd_tpu_torch.config import default_config
    from dvd_tpu_torch.evaluation.pipeline import DewarpPipeline
    from dvd_tpu_torch.training.train_loop import train

    steps = 22
    ds = StandInRawPages(TRAIN_SET, SEED + 8)
    with tempfile.TemporaryDirectory() as ws:
        # the shipped config (on_device_aug, the device-resident set), but
        # no checkpoint before the final one (log_interval stays 20: steps
        # 0 and 20 log)
        cfg = default_config().replace(
            train={"save_interval": 10 ** 9}, paths={"workspace_dir": ws})
        m, b = cfg.model, cfg.train.batch_size
        if not (cfg.train.on_device_aug and _device_dataset_ok(cfg, ds)):
            raise AssertionError("the shipped config does not stage the "
                                 "stand-in set on the card")
        init = DewarpPipeline.create(
            cfg, "cpu", generator=torch.Generator().manual_seed(cfg.train.seed),
            train=True).dit.state_dict()
        logger = _row_logger()
        log(f"[train] {m.dit_variant} compute {m.compute_dtype}, params "
            f"{m.param_dtype}, batch {b}, {m.source_size}^2, time_variant="
            f"{m.time_variant} iter={m.iter}, {cfg.train.schedule_sampler} "
            f"sampler, AdamW lr {cfg.train.lr:g} clip {cfg.train.grad_clip:g} "
            f"EMA {cfg.train.ema_rate}, on_device_aug="
            f"{cfg.train.on_device_aug} (inter_t/inter_T "
            f"{cfg.data.inter_t}/{cfg.data.inter_T}); {steps} steps from the "
            f"device-resident set of {TRAIN_SET} stand-in raw samples "
            f"({state['label']})")
        data = device_resident_iterator(cfg, ds, SEED + 8, "cuda")
        first = next(data)       # staging happens at the first batch
        log("[train] staged and gathered the first batch: "
            + ", ".join(f"{k} {tuple(v.shape)} {str(v.dtype)[6:]}"
                        for k, v in first.items()))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        with conv_shape_counter(Counter()) as shapes:
            train_state = train(cfg, data, max_steps=steps, device="cuda",
                                logger=logger)
        torch.cuda.synchronize()
        counts, k1 = read_launches(), routes("attention")
        check_conv_route("train", torch.bfloat16)
        check_gather_route("train")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        files = sorted(os.listdir(os.path.join(ws, cfg.name)))
        # the EMA snapshot outlives the workspace: phase 8 serves it
        snap = f"ema_{cfg.train.ema_rates[0]}_{steps:06d}.msgpack"
        state["ema_snapshot"] = shutil.copy(
            os.path.join(ws, cfg.name, snap),
            os.path.join(state["workdir"], snap))
    state["train_launches"] = counts
    if train_state.step != steps:
        raise AssertionError(f"train() took {train_state.step} steps")
    log(f"[train] train() ran {steps} steps and wrote {files}")
    per_step = {k: v / steps for k, v in counts.items()}
    log(f"[train] kernel launches in the run: {counts}; per step {per_step}; "
        f"K1 by route {k1}")
    if min(counts[k] for k in TRAIN_KERNELS) <= 0:
        raise AssertionError(f"a kernel of the path did not launch: {counts}")
    if k1 != {"wgmma": counts["attention"], "f32": 0}:
        raise AssertionError(f"K1 routes {k1}: bf16 training must run every "
                             f"attention through wgmma")
    # one step's loss and gradients (train32, float wire) plus the
    # augmentation's one warp of image + mask
    want_k3 = state["train32_launches"]["gather_bilinear"] + 1
    log(f"[train] K3 launches per step {per_step['gather_bilinear']:g}: the "
        f"step's {want_k3 - 1} (train32) + the augmentation's 1")
    if counts["gather_bilinear"] != steps * want_k3:
        raise AssertionError(f"K3 launched {counts['gather_bilinear']} times "
                             f"in {steps} steps, expected {want_k3} a step")
    log(f"[train] K2 launches per step by shape class, (B, Cin, Cout, H, W, "
        f"dilation): {({k: n / steps for k, n in sorted(shapes.items())})}")
    if sum(shapes.values()) != counts["conv3x3"]:
        raise AssertionError(f"{sum(shapes.values())} K2 calls counted by "
                             f"shape, {counts['conv3x3']} launches")

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
    # what the EMA snapshot holds: the EMA parameters, the BN statistics
    state["ema_source"] = {k: v.detach().cpu() for k, v in {
        **train_state.model.state_dict(), **ema}.items()}
    log(f"[train] max |param - init| {moved:.3e}, max |EMA - init| "
        f"{ema_moved:.3e}")
    if not (moved > 0 and 0 < ema_moved < moved):
        raise AssertionError("parameters or EMA did not move")
    log(f"[train] peak device memory {peak:.2f} GiB ({state['label']})")
    _train_host_loader(state, ds, want_k3)


def _train_host_loader(state, ds, want_k3, steps: int = 3):
    """A few steps of the shipped config with ``device_dataset="off"``: the
    same stand-in set through ``PrefetchLoader``'s host threads, the raw
    batches copied to the card each step and augmented there."""
    from dvd_tpu_torch.cli.run_training import _device_dataset_ok
    from dvd_tpu_torch.config import default_config
    from dvd_tpu_torch.data.loader import PrefetchLoader
    from dvd_tpu_torch.training.train_loop import train

    with tempfile.TemporaryDirectory() as ws:
        cfg = default_config().replace(
            train={"device_dataset": "off", "log_interval": 1},
            paths={"workspace_dir": ws})
        if _device_dataset_ok(cfg, ds):
            raise AssertionError("device_dataset=off staged the set")
        loader = iter(PrefetchLoader(
            ds, batch_size=cfg.train.batch_size,
            num_workers=cfg.data.n_threads, seed=SEED + 8,
            keys=("image512", "doc_mask512", "flow_map")))
        logger = _row_logger()
        torch.cuda.synchronize()
        reset_launches()
        try:
            train(cfg, loader, max_steps=steps, device="cuda", logger=logger)
        finally:
            loader.close()
        torch.cuda.synchronize()
        counts = read_launches()
        check_gather_route("train, host loader")
        files = sorted(os.listdir(os.path.join(ws, cfg.name)))
    losses = [r["loss"] for r in logger.rows]
    log(f"[train] host loader (device_dataset=off, PrefetchLoader, "
        f"{cfg.data.n_threads} threads): {steps} steps; loss {losses}; "
        f"launches {counts}; wrote {files}")
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"host-loader run losses {losses}")
    if counts["gather_bilinear"] != steps * want_k3 or \
            min(counts[k] for k in TRAIN_KERNELS) <= 0:
        raise AssertionError(f"host-loader run launches {counts}")
    if f"state_{steps:08d}.pt" not in files:
        raise AssertionError(f"host-loader run wrote {files}")


# ---------------------------------------------------------------- phase 7
def phase_probe(state):
    from dvd_tpu_torch.tools.gather_probe import run_probe

    torch.cuda.synchronize()
    reset_launches()
    err = run_probe("cuda")
    torch.cuda.synchronize()
    state["probe_launches"] = read_launches()
    log(f"[probe] K5 probe entry on the card: max_err {err}, launches "
        f"{state['probe_launches']}")
    if state["probe_launches"]["gather2d"] <= 0:
        raise AssertionError("the probe did not launch K5")


# ---------------------------------------------------------------- phase 8
def _stand_in_dataset(n: int, seed: int, source_size: int,
                      sides=(900, 2001)):
    """``n`` seeded synthetic pages with sides drawn from ``sides`` (900-2000
    px by default), as
    a ``BenchmarkDataset`` (the same ``__len__``/``__getitem__``/
    ``batches`` contract and items; the card's machine has no PIL or cv2
    to decode files) on ``BenchmarkDataset``'s fit canvas.  The pages and
    their 512^2 sources are drawn before the run, so an item costs only
    its canvas copy and the driver's window holds no page synthesis.
    Returns the dataset and the (h, w) of its pages."""
    import torch.nn.functional as F

    from dvd_tpu_torch.data.benchmark import BenchmarkDataset

    gen = torch.Generator().manual_seed(seed)
    sizes = torch.randint(*sides, (n, 2), generator=gen).tolist()
    pages, sources = [], []
    for h, w in sizes:
        u8 = (_page(1, h, w, gen)[0] * 255).round().to(torch.uint8)
        src = F.interpolate(u8.permute(2, 0, 1)[None].float(),
                            size=(source_size, source_size),
                            mode="bilinear", align_corners=False)
        pages.append(u8.numpy())
        sources.append((src[0].permute(1, 2, 0) / 255).numpy())

    class StandInPages(BenchmarkDataset):
        def __getitem__(self, i):
            h, w = sizes[i]
            padded = np.zeros((self.pad_to, self.pad_to, 3), np.uint8)
            padded[:h, :w] = pages[i]
            return {"source_image": sources[i], "source_padded": padded,
                    "hw": np.array([h, w], np.int32), "path": self.paths[i]}

    # the fit canvas: the smallest multiple of 256 that holds every page
    canvas = -(-max(max(hw) for hw in sizes) // 256) * 256
    return StandInPages(paths=[f"page_{i:03d}.png" for i in range(n)],
                        source_size=source_size, pad_to=canvas), sizes


def _smooth_flow(b: int, s: int, gen: torch.Generator) -> torch.Tensor:
    """A smooth (B, S, S, 2) offset field of a few hundredths."""
    yy, xx = torch.meshgrid(torch.linspace(0, 1, s), torch.linspace(0, 1, s),
                            indexing="ij")
    a = (torch.rand((b, 2, 3), generator=gen) - 0.5) * 0.06
    f = torch.stack([a[:, i, 0, None, None] * torch.sin(3 * xx + 2 * yy)
                     + a[:, i, 1, None, None] * torch.cos(4 * yy)
                     + a[:, i, 2, None, None] * xx * yy for i in (0, 1)], -1)
    return f.contiguous()


def _dataset_weights(state, cfg):
    """Aux-net files from a seeded pipeline and the DiT from the EMA
    snapshot; a pipeline from another seed loads them: 4/4, each tensor
    equal to its source in the serving dtype."""
    from dvd_tpu_torch.evaluation.pipeline import DewarpPipeline
    from dvd_tpu_torch.training.checkpoint import (maybe_load_pipeline_weights,
                                                   save_variables)
    from dvd_tpu_torch.training.convert import state_dict_to_variables

    src = DewarpPipeline.create(
        cfg, "cuda", generator=torch.Generator().manual_seed(SEED + 3))
    paths = {"model_path": state["ema_snapshot"]}
    sources = {"dit": state["ema_source"]}
    for attr, field, name in (("geotr", "seg_model_path", "seg.msgpack"),
                              ("line", "line_seg_model_path",
                               "line_model2.msgpack"),
                              ("seg", "new_seg_model_path", "seg_model.msgpack")):
        sd = getattr(src, attr).state_dict()
        paths[field] = os.path.join(state["workdir"], name)
        save_variables(paths[field], state_dict_to_variables(sd))
        sources[attr] = {k: v.cpu() for k, v in sd.items()}
    del src
    cfg = cfg.replace(paths=paths)
    t0 = time.perf_counter()
    pipe = DewarpPipeline.create(
        cfg, "cuda", generator=torch.Generator().manual_seed(SEED + 10))
    loaded = maybe_load_pipeline_weights(pipe, cfg)
    log(f"[dataset] maybe_load_pipeline_weights: {loaded} in "
        f"{time.perf_counter() - t0:.2f} s (pipeline built included); the "
        f"DiT from train()'s {os.path.basename(state['ema_snapshot'])}")
    if not all(loaded.values()) or len(loaded) != 4:
        raise AssertionError(f"loaded {loaded}, expected 4/4")
    for attr, want in sources.items():
        got = getattr(pipe, attr).state_dict()
        if set(got) != set(want):
            raise AssertionError(f"{attr}: keys differ from the source")
        bad = [k for k, v in got.items()
               if not torch.equal(v.cpu(), want[k].to(v.dtype))]
        if bad:
            raise AssertionError(f"{attr}: {len(bad)} tensors differ from "
                                 f"their source, e.g. {bad[:3]}")
        dtypes = sorted({str(v.dtype)[6:] for v in got.values()})
        log(f"[dataset]   {attr}: {len(got)} tensors equal to their source "
            f"cast to {dtypes}")
    return pipe


def _native_check(pipe):
    """unwarp_native on the card (the fused unwarp) against the CPU (the
    plain composition), two pages of different sizes in a 1536^2 canvas,
    one smooth flow per page in the compute dtype; TF32 off, then on.
    The kernel's own coordinates: a ramp source whose channels are its
    column and row index gives back, wherever all four corners are valid,
    the pixel coordinate it sampled, held to the plain grid in [-1, 1]
    canvas units at the grid's bar."""
    from dvd_tpu_torch.evaluation.driver import unwarp_u8
    from dvd_tpu_torch.evaluation.pipeline import native_grid, unwarp_native
    from dvd_tpu_torch.ops.grid_sample import unnormalize

    p, hws = 1536, [(1500, 1100), (1200, 1536)]
    idx = torch.arange(p, dtype=torch.float32)
    ramp = torch.stack([idx[None, :].expand(p, p), idx[:, None].expand(p, p),
                        torch.zeros((p, p))], -1)[None].repeat(2, 1, 1, 1)
    gen = torch.Generator().manual_seed(SEED + 11)
    pad = torch.zeros((2, p, p, 3), dtype=torch.uint8)
    for i, (h, w) in enumerate(hws):
        pad[i, :h, :w] = (_page(1, h, w, gen)[0] * 255).round().to(torch.uint8)
    hw = torch.tensor(hws, dtype=torch.int32)
    flow = _smooth_flow(2, pipe.cfg.model.image_size, gen).to(pipe.dtype)
    cpu = (native_grid(hw, flow, p), unwarp_native(pad, hw, flow),
           unwarp_u8(pad, hw, flow))
    for tf32 in (False, True):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            dev = [x.cuda() for x in (pad, hw, flow)]
            grid = native_grid(dev[1], dev[2], p)
            img = unwarp_native(*dev)
            u8 = unwarp_u8(*dev)
            coords = unwarp_native(ramp.cuda(), dev[1], dev[2])
            torch.cuda.synchronize()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        tag = f"TF32 {'on' if tf32 else 'off'}"
        for axis, g, want in zip("xy", grid, cpu[0]):
            compare(f"native grid {axis} card vs CPU, {tag}", g.cpu(), want,
                    TOL["native_grid"])
        gx, gy = (unnormalize(g, p) for g in cpu[0])
        inside = (gx >= 0) & (gx < p - 1) & (gy >= 0) & (gy < p - 1)
        for i, (h, w) in enumerate(hws):
            keep = inside[i, :h, :w]
            for axis, e, want in (("x", 0, cpu[0][0]), ("y", 1, cpu[0][1])):
                got = coords[i, :h, :w, e].cpu() / (0.5 * (p - 1)) - 1.0
                compare(f"fused unwarp's {axis} coordinates (ramp) {h}x{w} "
                        f"vs the plain grid, {keep.float().mean().item():.1%} "
                        f"of the page inside, {tag}", got[keep],
                        want[i, :h, :w][keep], TOL["native_grid"])
            compare(f"native image {h}x{w} card vs CPU, {tag}",
                    img[i, :h, :w].cpu(), cpu[1][i, :h, :w],
                    TOL["native_image"])
            compare(f"native uint8 {h}x{w} card vs CPU, {tag}",
                    u8[i, :h, :w].cpu().int(), cpu[2][i, :h, :w].int(),
                    TOL["native_u8"])


def _driver_run(pipe, n_pages, out_dir, label):
    """run_benchmark on ``n_pages`` stand-in pages at the shipped batch,
    counted; checks one finite coordinate map in [-1, 1] per page.
    Returns the launches."""
    from dvd_tpu_torch.evaluation.driver import run_benchmark

    cfg = pipe.cfg
    ds, sizes = _stand_in_dataset(n_pages, SEED + 12 + n_pages,
                                  cfg.model.source_size)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    stats = run_benchmark(pipe, ds, out_dir,
                          batch_size=cfg.data.eval_device_batch, seed=SEED,
                          save_outputs=False, save_coord_maps=True)
    torch.cuda.synchronize()
    counts = read_launches()
    check_conv_route("dataset", torch.bfloat16)
    check_gather_route("dataset")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    pred = os.path.join(out_dir, "dewarped_pred")
    maps = sorted(os.listdir(pred))
    if maps != sorted(f"coord_{p}.npy" for p in ds.paths) \
            or stats["images"] != n_pages:
        raise AssertionError(f"{n_pages} pages: {stats['images']} images, "
                             f"{len(maps)} coordinate maps")
    s = cfg.model.image_size
    for name in maps:
        m = np.load(os.path.join(pred, name))
        if m.shape != (s, s, 2) or not np.isfinite(m).all() \
                or np.abs(m).max() > 1:
            raise AssertionError(f"{name}: shape {m.shape}, not finite or "
                                 f"outside [-1, 1]")
    sides = [s for hw in sizes for s in hw]
    log(f"[dataset] {label}: {n_pages} pages, sides "
        f"{min(sides)}-{max(sides)} px, canvas "
        f"{ds.pad_to}^2, batch {cfg.data.eval_device_batch}: run_benchmark "
        f"served {stats['images']} images")
    log(f"[dataset]   launches {counts}; peak device memory {peak:.2f} GiB; "
        f"{len(maps)} coordinate maps, finite, within [-1, 1]")
    return counts


def phase_dataset(state):
    from dvd_tpu_torch.config import default_config

    cfg = default_config()
    m = cfg.model
    log(f"[dataset] {m.dit_variant} {m.compute_dtype} quantize={m.quantize}, "
        f"{cfg.diffusion.diffusion_steps} DDIM steps x "
        f"{cfg.diffusion.n_batch} hypotheses, batch "
        f"{cfg.data.eval_device_batch} ({state['label']})")
    pipe = _dataset_weights(state, cfg)
    _native_check(pipe)
    out = os.path.join(state["workdir"], "vis_hp")
    counts = _driver_run(pipe, 100, os.path.join(out, "p100"), "main run")
    if min(counts[k] for k in ("attention", "conv3x3", "gather_bilinear",
                               "unwarp")) <= 0:
        raise AssertionError(f"a kernel of the path did not launch: {counts}")
    _driver_run(pipe, 6, os.path.join(out, "p6"), "padded last batch")


# ---------------------------------------------------------------- int8
# the int8 products of the serving path, (M, K, N): the live DiT block's
# (qkv, fc1; cross-attention and proj at 384 x 384 share K) and fc2, then
# the SATRN decoder's (q/k/v/fc; conv1; conv2), M = 4 pages x 2
# hypotheses x 1024 tokens at the shipped batch
INT8_SHAPES = ((8192, 384, 1152), (8192, 384, 1536), (8192, 1536, 384),
               (8192, 1536, 1536), (8192, 1536, 2048), (8192, 2048, 1536))
INT8_RECORD = (8192, 1536, 2048)
INT8_OPS_PER_S = 1979e12        # H100 SXM dense int8 peak
INT8_KERNEL = ("int8_gemm", "library", "dvd_tpu_torch/ops/quant.py",
               "dvd_tpu/ops/quant.py:50 (lax.dot_general outside Pallas; "
               "no TPU kernel)")


def _bound(nbytes: float, ops: float = 0.0, peak: float = INT8_OPS_PER_S):
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
    return (max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations")


def _equal_or_one_ulp(what, got, want) -> str:
    """``got`` against ``want`` (the CPU's): equal bit for bit, or within
    eps * |want| (one rounding of the output dtype) elementwise."""
    g, w = got.float().cpu(), want.float()
    if torch.equal(g, w):
        return "bit for bit"
    bad = (g - w).abs() > torch.finfo(got.dtype).eps * w.abs()
    if bad.any():
        raise AssertionError(f"{what}: {int(bad.sum())} elements differ by "
                             f"more than one {got.dtype} rounding")
    return f"{int((g != w).sum())} elements one rounding apart"


def phase_int8(state):
    """int8_dense on the card against the CPU at the serving path's
    shapes, then timed beside a bf16 matmul of the same shape."""
    from dvd_tpu_torch.ops import quant

    label = state["label"]
    gen = torch.Generator().manual_seed(SEED + 20)
    times = state["int8_times"] = {}
    worst = 0
    for dtype in (torch.bfloat16, torch.float32):
        for m, k, n in INT8_SHAPES if dtype == torch.bfloat16 \
                else INT8_SHAPES[:1]:
            x = torch.randn((m, k), generator=gen).to(dtype)
            w = torch.randn((n, k), generator=gen) / math.sqrt(k)
            b = 0.02 * torch.randn((n,), generator=gen)
            wq, ws = quant.quantize_rows(w)
            xq_c, xs_c = quant.quantize_rows(x)
            acc_c = torch._int_mm(xq_c, wq.t())
            y_c = quant.int8_dense(x, w, b, qweight=(wq, ws.flatten()))
            xd, wd, bd = x.cuda(), w.cuda(), b.cuda()
            wqd, wsd = quant.quantize_rows(wd)
            wsd = wsd.flatten()
            xq, xs = quant.quantize_rows(xd)
            acc = quant.int_mm(xq, wqd.t())
            y = quant.int8_dense(xd, wd, bd, qweight=(wqd, wsd))
            torch.cuda.synchronize()
            for what, got, want in (("activation codes", xq, xq_c),
                                    ("activation scales", xs, xs_c),
                                    ("weight codes", wqd, wq),
                                    ("weight scales", wsd, ws.flatten()),
                                    ("int32 product", acc, acc_c)):
                if not torch.equal(got.cpu(), want):
                    raise AssertionError(f"int8 ({m}, {k}, {n}) {dtype}: "
                                         f"{what} card != CPU")
            worst = max(worst, int((acc.cpu() - acc_c).abs().max()))
            how = _equal_or_one_ulp(f"int8_dense ({m}, {k}, {n})", y, y_c)
            log(f"[int8] ({m}, {k}, {n}) {str(dtype)[6:]}: codes, scales and "
                f"the int32 product equal the CPU's; the output {how}")
            if dtype != torch.bfloat16:
                continue
            wt, wb = wqd.t(), wd.bfloat16()
            f = dict(
                int_mm=lambda: torch._int_mm(xq, wt),
                plain=lambda: torch.matmul(xq.double(), wt.double()).int(),
                bf16_matmul=lambda: torch.matmul(xd, wb.t()),
                quantize=lambda: quant.quantize_rows(xd),
                rescale=lambda: ((acc.float() * xs) * wsd + bd).to(dtype),
                int8_dense=lambda: quant.int8_dense(xd, wd, bd,
                                                    qweight=(wqd, wsd)))
            ms = {name: cuda_time_ms(fn) for name, fn in f.items()}
            ops = 2.0 * m * n * k
            bounds = {
                "int_mm": _bound(m * k + n * k + 4 * m * n, ops),
                "bf16_matmul": _bound(2 * (m * k + n * k + m * n), ops,
                                      PEAK_FLOPS[torch.bfloat16]),
                "quantize": _bound(2 * m * k + m * k + 4 * m),
                "rescale": _bound(4 * m * n + 4 * m + 8 * n + 2 * m * n),
                "int8_dense": _bound(2 * m * k + n * k + 8 * n + 2 * m * n,
                                     ops)}
            times[(m, k, n)] = dict(ms=ms, bounds=bounds)
            log(f"[int8] ({m}, {k}, {n}) bf16 activations, ms (bound, by): "
                + "; ".join(f"{name} {ms[name]:.4f} ({bounds[name][0]:.4f}, "
                            f"{bounds[name][1]})" for name in bounds)
                + f"; plain f64 product {ms['plain']:.4f}; int8_dense / bf16 "
                f"matmul {ms['int8_dense'] / ms['bf16_matmul']:.2f}x "
                f"({label})")
    state["int8_err"] = worst


def _int8_expected(pipe) -> int:
    """int8 products a serving run makes, from the code: each int8 layer
    of the live block once per stream, each of the decoder's once, per
    DiT call (one per DDIM step; the hypotheses are batched)."""
    live = f"blocks_{pipe.dit.depth - 1}."
    names = [name for name, _ in pipe.dit.int8_layers()]
    per_call = (sum(n.startswith(live) for n in names) * pipe.dit.n_streams
                + sum(n.startswith("decoder.") for n in names))
    return pipe.sched.num_timesteps * per_call


@contextlib.contextmanager
def int8_codes(book: list, replay: bool, stats: dict):
    """While open, every ``quantize_rows`` of the port (activations and
    weights) is recorded in ``book`` (the card's run), or (``replay``, the
    CPU's run) compared with the record of the same call and replaced by
    it: where f32 rounding put an element across a rounding tie on one
    device, its code differs by one step; ``stats`` counts those flips.
    Patched here, never in the package."""
    from dvd_tpu_torch.models import layers, satrn
    from dvd_tpu_torch.ops import quant

    orig = quant.quantize_rows
    calls = iter(range(len(book))) if replay else None

    def hooked(x):
        q, s = orig(x)
        if not replay:
            book.append(q.cpu())
            return q, s
        want = book[next(calls)]
        diff = want.int() - q.int()
        if want.shape != q.shape or int(diff.abs().max()) > 1:
            raise AssertionError("int8 codes: a code moved by more than one "
                                 "step between the card and the CPU")
        stats["flips"] = stats.get("flips", 0) + int((diff != 0).sum())
        stats["codes"] = stats.get("codes", 0) + q.numel()
        return want.to(q.device), s

    mods = (quant, layers, satrn)
    for mod in mods:
        mod.quantize_rows = hooked
    try:
        yield
    finally:
        for mod in mods:
            mod.quantize_rows = orig


def phase_slice_int8(state):
    """The f32 serving slice under int8, card against CPU (slice32's
    inputs and bars), the CPU taking the card's int8 codes where a tie
    flipped (counted; they must be rare)."""
    from dvd_tpu_torch.config import default_config

    book, stats = [], {}
    _slice_card_vs_cpu(
        default_config().replace(
            model={"compute_dtype": "float32", "quantize": "int8"},
            diffusion={"n_batch": 2}),
        "slice_int8", codes=lambda dev: int8_codes(book, dev == "cpu", stats))
    log(f"[slice_int8] int8 codes: {stats['flips']} of {stats['codes']} "
        f"differ by one step between the card and the CPU (the CPU took "
        f"the card's); {len(book)} quantize passes")
    if stats["flips"] > 1e-3 * stats["codes"]:
        raise AssertionError(f"int8 code flips {stats}")


def phase_shipped_int8(state):
    """The shipped config with ``quantize="int8"``: the main path once
    (counted, routes checked, the int8 products at the code's count), the
    flow's distance from the bf16 run on the same pages, weights and x_T,
    peak memory."""
    from dvd_tpu_torch.config import default_config
    from dvd_tpu_torch.evaluation.pipeline import DewarpPipeline, unwarp_fixed
    from dvd_tpu_torch.ops import quant

    label = state["label"]
    cfg = default_config().replace(model={"quantize": "int8"})
    m, d = cfg.model, cfg.diffusion
    batch = cfg.data.eval_device_batch
    pipe = DewarpPipeline.create(
        cfg, "cuda", generator=torch.Generator().manual_seed(SEED + 3))
    dtypes = {str(layer.weight.dtype) for _, layer in pipe.dit.int8_layers()}
    src = state["shipped"]["src"].cuda()        # the bf16 run's pages
    cuda_gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    log(f"[shipped_int8] {m.dit_variant} {m.compute_dtype} "
        f"quantize={m.quantize} batch {batch}, {m.source_size}^2, "
        f"{d.diffusion_steps} DDIM steps x {d.n_batch} hypotheses; "
        f"{len(pipe.dit.int8_layers())} int8 layers with {dtypes} "
        f"weights ({label})")
    if dtypes != {"torch.float32"}:
        raise AssertionError(f"int8 layers keep f32 weights, not {dtypes}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    flow = pipe.dewarp_flow(src, generator=cuda_gen)
    out = unwarp_fixed(src, flow)
    torch.cuda.synchronize()
    counts, n_int8 = read_launches(), quant.launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[shipped_int8] peak device memory of the main-path run (weights "
        f"included) {peak:.3f} GiB against bf16's "
        f"{state['shipped']['peak_gib']:.3f} GiB")
    check_conv_route("shipped_int8", torch.bfloat16)
    check_gather_route("shipped_int8")
    k1 = routes("attention")
    expected = _int8_expected(pipe)
    log(f"[shipped_int8] launches in one main-path run: {counts}; K1 by "
        f"route {k1}; int8 products {n_int8} (the code's count {expected})")
    if counts != SERVE_LAUNCHES or n_int8 != expected or expected <= 0 \
            or k1 != {"wgmma": SERVE_LAUNCHES["attention"], "f32": 0}:
        raise AssertionError(f"shipped_int8 launches {counts}, K1 {k1}, int8 "
                             f"{n_int8} (expected {expected})")
    if flow.shape != (batch, m.image_size, m.image_size, 2) \
            or out.shape != src.shape or not (
                torch.isfinite(flow).all() and torch.isfinite(out).all()
                and flow.abs().max() <= 1):
        raise AssertionError("int8 outputs malformed, not finite or the "
                             "flow outside [-1, 1]")
    dist = (flow.cpu() - state["shipped"]["flow"]).abs()
    log(f"[shipped_int8] flow against the bf16 shipped run (same pages, "
        f"weights and x_T; random weights, a reading): max |d| "
        f"{dist.max().item():.4e}, mean |d| {dist.mean().item():.4e}; "
        f"image range [{out.min().item():.3f}, {out.max().item():.3f}]")
    state["shipped_int8"] = dict(out=out.cpu(), launches=n_int8)


def phase_shipped32(state):
    """The shipped config served at ``compute_dtype=float32``, batch 4,
    512^2: launches and routes (every K1 and K2 launch on the f32 route),
    outputs, K2 by shape class against f32 ``conv2d``."""
    from dvd_tpu_torch.config import default_config
    from dvd_tpu_torch.evaluation.pipeline import DewarpPipeline, unwarp_fixed

    cfg = default_config().replace(model={"compute_dtype": "float32"})
    m, d = cfg.model, cfg.diffusion
    state.setdefault("label", card_label())   # run without phase 1
    batch, label = cfg.data.eval_device_batch, state["label"]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    pipe = DewarpPipeline.create(
        cfg, "cuda", generator=torch.Generator().manual_seed(SEED + 3))
    gen = torch.Generator().manual_seed(SEED + 4)
    src = _page(batch, m.source_size, m.source_size, gen).cuda()
    cuda_gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    log(f"[shipped32] {m.dit_variant} {m.compute_dtype} batch {batch}, "
        f"{m.source_size}^2, {d.diffusion_steps} DDIM steps x {d.n_batch} "
        f"hypotheses ({label})")
    torch.cuda.synchronize()
    reset_launches()
    with conv_shape_counter(Counter()) as shapes, torch.inference_mode():
        flow = pipe.dewarp_flow(src, generator=cuda_gen)
        out = unwarp_fixed(src, flow)
    torch.cuda.synchronize()
    counts, k1 = read_launches(), routes("attention")
    check_conv_route("shipped32", torch.float32)
    check_gather_route("shipped32")
    log(f"[shipped32] kernel launches in one main-path run: {counts}; K1 by "
        f"route {k1}")
    if counts != SERVE_LAUNCHES or \
            k1 != {"wgmma": 0, "f32": SERVE_LAUNCHES["attention"]}:
        raise AssertionError(f"shipped32 launches {counts}, K1 routes {k1}")
    if sum(shapes.values()) != SERVE_LAUNCHES["conv3x3"]:
        raise AssertionError(f"{sum(shapes.values())} K2 calls counted")
    if flow.shape != (batch, m.image_size, m.image_size, 2) \
            or out.shape != src.shape or not (
                torch.isfinite(flow).all() and torch.isfinite(out).all()
                and flow.abs().max() <= 1):
        raise AssertionError("f32 outputs malformed, not finite or the flow "
                             "outside [-1, 1]")
    log(f"[shipped32] flow |max| {flow.abs().max().item():.4f}; unwarped "
        f"image range [{out.min().item():.3f}, {out.max().item():.3f}]")
    _time_conv_classes(shapes, label, "shipped32", torch.float32)


# the production DiT's other conditioning configurations (the flags of
# dvd_tpu's pipeline and train step the port serves and trains)
FLAG_CONFIGS = (("init_flow+vgg", {"use_init_flow": True, "train_VGG": False}),
                ("seq", {"separate_cross_attn": "seq"}),
                ("one", {"separate_cross_attn": "one"}))
# GeoTr's K1 launches a conditioning batch: 12 layers x 2 attentions, Dh 32
GEOTR_K1 = 24


def phase_flags32(state):
    """Serving at full DiT-S/2 width, 512^2, batch 1, f32, under each of
    FLAG_CONFIGS: card against CPU (slice32's bars), every K1 and K2 launch
    on the f32 route, GeoTr's Dh 32 launches and the VGG's K2 counted."""
    from dvd_tpu_torch.config import default_config

    flags32 = {}
    for name, flags in FLAG_CONFIGS:
        counts = _slice_card_vs_cpu(default_config().replace(
            model={"compute_dtype": "float32", **flags},
            diffusion={"n_batch": 1}), f"flags32 {name}")
        k1, by_dh = counts["attention_routes"], counts["attention_by_dh"]
        want32 = GEOTR_K1 if flags.get("use_init_flow") else 0
        want_vgg = {"wgmma": 0, "f32": 0 if flags.get("train_VGG", True)
                    else sum(VGG_CLASSES.values())}
        log(f"[flags32 {name}] K1 by route {k1}, by head dim {by_dh}; the "
            f"VGG's K2 launches by route {counts['vgg_k2']}")
        if k1 != {"wgmma": 0, "f32": counts["attention"]} or \
                by_dh.get(32, 0) != want32:
            raise AssertionError(f"flags32 {name}: K1 routes {k1}, by head "
                                 f"dim {by_dh}; {want32} Dh 32 expected")
        if counts["vgg_k2"] != want_vgg:
            raise AssertionError(f"flags32 {name}: the VGG's K2 launches "
                                 f"{counts['vgg_k2']}, {want_vgg} expected")
        flags32[name] = counts
    first = flags32["init_flow+vgg"]
    state["flags32_launches"] = {
        "attention_f32_dh32": first["attention_by_dh"][32],
        "conv3x3_f32_vgg": first["vgg_k2"]["f32"]}


def phase_flags(state):
    """FLAG_CONFIGS' first (GeoTr's init_flow and the VGG conditioning)
    served in bf16 at batch 4, 512^2: launches and routes (GeoTr's 24 K1
    launches on the Dh 32 wgmma instance, the VGG's 7 K2 launches f32, the
    rest bf16), outputs."""
    from dvd_tpu_torch.config import default_config
    from dvd_tpu_torch.evaluation.pipeline import DewarpPipeline, unwarp_fixed

    name, flags = FLAG_CONFIGS[0]
    cfg = default_config().replace(model=flags)
    m, d = cfg.model, cfg.diffusion
    batch, label = cfg.data.eval_device_batch, state["label"]
    pipe = DewarpPipeline.create(
        cfg, "cuda", generator=torch.Generator().manual_seed(SEED + 3))
    gen = torch.Generator().manual_seed(SEED + 4)
    src = _page(batch, m.source_size, m.source_size, gen).cuda()
    cuda_gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    log(f"[flags] {name}: {m.dit_variant} {m.compute_dtype} batch {batch}, "
        f"{m.source_size}^2, {d.diffusion_steps} DDIM steps x {d.n_batch} "
        f"hypotheses ({label})")
    torch.cuda.synchronize()
    reset_launches()
    with conv_shape_counter(Counter()) as shapes, torch.inference_mode(), \
            vgg_k2_counter(pipe.vgg, {"wgmma": 0, "f32": 0}) as vgg_k2:
        cond, init_flow, init_feat = pipe.build_conditioning(src)
        flow = pipe.sampling_impl(cond, init_flow, init_feat, cuda_gen)
        out = unwarp_fixed(src, flow)
    torch.cuda.synchronize()
    counts, k1, k2 = read_launches(), routes("attention"), routes("conv3x3")
    short = {c: (shapes[c], n) for c, n in {**GEOTR_CLASSES,
                                            **VGG_CLASSES}.items()
             if shapes[c] < n}
    if short:   # phase 2 holds K2 at these classes: they must be the run's
        raise AssertionError(f"flags: K2 classes launched less than "
                             f"expected (launched, expected): {short}")
    by_dh = attention_by_dh()
    want_vgg = {"wgmma": 0, "f32": sum(VGG_CLASSES.values())}
    log(f"[flags] kernel launches in one main-path run: {counts}; K1 by "
        f"route {k1}, by head dim {by_dh}; K2 by route {k2}, the VGG's "
        f"{vgg_k2}")
    if k1 != {"wgmma": counts["attention"], "f32": 0} or \
            by_dh.get(32, 0) != GEOTR_K1:
        raise AssertionError(f"flags: K1 routes {k1}, by head dim {by_dh}")
    if vgg_k2 != want_vgg or k2["wgmma"] <= 0 or \
            k2 != {"wgmma": counts["conv3x3"] - vgg_k2["f32"],
                   "f32": vgg_k2["f32"]}:
        raise AssertionError(f"flags: K2 routes {k2}, the VGG's {vgg_k2}: "
                             f"{want_vgg} expected, the rest bf16")
    check_gather_route("flags")
    if counts["unwarp"] != 1 or counts["gather_bilinear"] <= 0:
        raise AssertionError(f"flags: launches {counts}")
    if flow.shape != (batch, m.image_size, m.image_size, 2) or \
            out.shape != src.shape or not (
                torch.isfinite(flow).all() and torch.isfinite(out).all()
                and flow.abs().max() <= 1 and torch.isfinite(init_flow).all()
                and init_flow.abs().max() > 0):
        raise AssertionError("flags outputs malformed, not finite, the flow "
                             "outside [-1, 1] or no init_flow")
    log(f"[flags] init_flow in [{init_flow.min().item():.4f}, "
        f"{init_flow.max().item():.4f}]; flow |max| "
        f"{flow.abs().max().item():.4f}; unwarped image range "
        f"[{out.min().item():.3f}, {out.max().item():.3f}]")
    state["flags_launches"] = {"attention_dh32": by_dh[32]}


def phase_flags_train32(state):
    """One f32 train step under ``train_VGG=False`` (the VGG16 features in
    place of the DiT's pyramid), batch 2: card against CPU as train32."""
    from dvd_tpu_torch.config import default_config

    counts = _train_card_vs_cpu(default_config().replace(
        model={"compute_dtype": "float32", "train_VGG": False},
        train={"on_device_aug": False}), "flags_train32")
    want_vgg = {"wgmma": 0, "f32": sum(VGG_CLASSES.values())}
    log(f"[flags_train32] the VGG's K2 launches in the step, by route: "
        f"{counts['vgg_k2']}")
    if counts["conv3x3_routes"]["wgmma"] != 0 or counts["vgg_k2"] != want_vgg:
        raise AssertionError(f"flags_train32: K2 routes "
                             f"{counts['conv3x3_routes']}, the VGG's "
                             f"{counts['vgg_k2']} ({want_vgg} expected)")


# the alternative denoiser families (``train_mode``), each at the
# registry's full width under the VGG16 conditioning (train_VGG=False):
# (tag, model flags)
ALT_CONFIGS = (("stage_1", {"train_mode": "stage_1"}),
               ("stage_1_transformer", {"train_mode": "stage_1_transformer"}),
               ("stage_1_doctr", {"train_mode": "stage_1_doctr"}),
               ("stage_1_doctr+init_flow", {"train_mode": "stage_1_doctr",
                                            "use_init_flow": True}))
# the code's K1 launches a denoiser call, by the caller's head dim (the
# UNet's 7 at Dh 96 run on the 128 instance, zero-padded; GeoTr2's 12
# layers attend twice each), and K2's (65 UNet, 2 transformer, 10 GeoTr2)
ALT_K1 = {"stage_1": {96: 7, 128: 8}, "stage_1_transformer": {32: 13},
          "stage_1_doctr": {32: 24}}
ALT_K2 = {"stage_1": 65, "stage_1_transformer": 2, "stage_1_doctr": 10}
# GeoTrSegInf's K2 launches a conditioning batch under use_init_flow: its
# U2NetP mask's 118 and GeoTr's 13 (GEOTR_CLASSES)
GEOTR_SEG_K2 = 118 + sum(GEOTR_CLASSES.values())
# the stride-1 3x3 convs of one UNet and one GeoTr2 call at the serving
# batch (4 pages x 2 hypotheses), (B, Cin, Cout, H, W, dilation) ->
# launches a serving run (3 DDIM steps); models/unet_denoiser.py and
# models/geotr.py:GeoTr2
UNET_CLASSES = {(8, cin, cout, hw, hw, 1): 3 * n for cin, cout, hw, n in (
    (68, 128, 64, 1), (128, 2, 64, 1), (128, 128, 64, 10), (128, 256, 32, 1),
    (256, 128, 64, 3), (256, 256, 32, 9), (256, 256, 64, 1),
    (256, 384, 16, 1), (384, 128, 64, 1), (384, 256, 32, 1),
    (384, 384, 16, 9), (384, 384, 32, 1), (384, 512, 8, 1), (512, 256, 32, 2),
    (512, 512, 8, 13), (512, 512, 16, 1), (640, 256, 32, 1),
    (640, 384, 16, 1), (768, 384, 16, 2), (896, 384, 16, 1),
    (896, 512, 8, 1), (1024, 512, 8, 3))}
GEOTR2_CLASSES = {(8, cin, cout, hw, hw, 1): 3 * n for cin, cout, hw, n in (
    (68, 64, 64, 1), (64, 64, 64, 3), (128, 128, 32, 3), (256, 256, 32, 2),
    (256, 2, 32, 1))}


def _alt_cfg(flags: dict, **over):
    from dvd_tpu_torch.config import default_config

    model = dict(flags, train_VGG=False, **over.pop("model", {}))
    return default_config().replace(model=model, **over)


def _alt_expected(cfg, calls: int) -> tuple:
    """The code's K1 launches by the caller's head dim and K2 launches for
    ``calls`` denoiser calls of ``cfg`` (GeoTrSegInf's 24 K1 and 131 K2
    launches under use_init_flow, the VGG's 7 K2 launches, in f32)."""
    m = cfg.model
    k1 = Counter({dh: calls * n for dh, n in ALT_K1[m.train_mode].items()})
    k2 = calls * ALT_K2[m.train_mode] + sum(VGG_CLASSES.values())
    if m.use_init_flow:
        k1[32] += GEOTR_K1
        k2 += GEOTR_SEG_K2
    return dict(k1), k2


def _check_alt_launches(tag: str, cfg, counts: dict, dtype) -> None:
    """K1 by the caller's head dim (instance Dh, plus the padded Dh 96) and
    K2 as the code counts them, every K1 and K2 launch on ``dtype``'s
    route but the VGG's 7 K2 launches (f32), no K3 launch outside the
    unwarp: the alternative families sample without the re-warp."""
    from dvd_tpu_torch.ops.kernels.attention import kernel_head_dim

    calls = cfg.diffusion.diffusion_steps
    want_k1, want_k2 = _alt_expected(cfg, calls)
    by_dh, padded = counts["attention_by_dh"], counts["attention_padded"]
    got_k1 = dict(by_dh)
    for dh, n in padded.items():
        got_k1[dh] = n
        got_k1[kernel_head_dim(dh, dtype)] -= n
    got_k1 = {dh: n for dh, n in got_k1.items() if n}
    k1, k2 = counts["attention_routes"], counts["conv3x3_routes"]
    bf16 = dtype == torch.bfloat16
    vgg = sum(VGG_CLASSES.values())
    want_k1_routes = {"wgmma": counts["attention"] if bf16 else 0,
                      "f32": 0 if bf16 else counts["attention"]}
    want_k2_routes = {"wgmma": want_k2 - vgg if bf16 else 0,
                      "f32": vgg if bf16 else want_k2}
    log(f"[{tag}] K1 by the caller's head dim {got_k1} (instances "
        f"{by_dh}, padded {padded}), by route {k1}; K2 {counts['conv3x3']} "
        f"by route {k2}, the VGG's {counts['vgg_k2']}; K3 "
        f"{counts['gather_bilinear']}, unwarp {counts['unwarp']}")
    if got_k1 != want_k1 or k1 != want_k1_routes or min(got_k1.values()) <= 0:
        raise AssertionError(f"{tag}: K1 {got_k1} by route {k1}; expected "
                             f"{want_k1}, {want_k1_routes}")
    if counts["conv3x3"] != want_k2 or k2 != want_k2_routes or \
            counts["vgg_k2"] != {"wgmma": 0, "f32": vgg}:
        raise AssertionError(f"{tag}: K2 {counts['conv3x3']} by route {k2}, "
                             f"the VGG's {counts['vgg_k2']}; expected "
                             f"{want_k2}, {want_k2_routes}")
    if counts["gather_bilinear"] != 0 or counts["unwarp"] != 1:
        raise AssertionError(f"{tag}: K3 {counts['gather_bilinear']}, "
                             f"unwarp {counts['unwarp']}; expected 0 and 1")


def _main_run_counts(pipe) -> dict:
    return dict(read_launches(), attention_routes=routes("attention"),
                conv3x3_routes=routes("conv3x3"),
                attention_by_dh=attention_by_dh(),
                attention_padded=dict(
                    _kernel_fns()["attention"].launches_padded))


def alt_kernel_launches(runs: dict, route: str) -> dict:
    """The alternative instances' launches for the JSON record, from each
    family's main-path run in ``runs`` (alt: bf16, alt32: f32)."""
    f32 = "_f32" if route == "f32" else ""
    k2 = "f32" if route == "f32" else "wgmma"
    unet, tr, geo = (runs[t] for t in ("stage_1", "stage_1_transformer",
                                       "stage_1_doctr"))
    return {f"attention{f32}_alt": tr["attention_by_dh"][32],
            f"attention{f32}_geotr2": geo["attention_by_dh"][32],
            f"attention{f32}_dh96": unet["attention_padded"][96],
            f"attention{f32}_dh128": unet["attention_by_dh"][128]
            - unet["attention_padded"][96],
            f"conv3x3{f32}_unet": unet["conv3x3_routes"][k2]
            - (sum(VGG_CLASSES.values()) if route == "f32" else 0),
            f"conv3x3{f32}_geotr2": geo["conv3x3_routes"][k2]
            - (sum(VGG_CLASSES.values()) if route == "f32" else 0)}


def phase_alt32(state):
    """The alternative families served at full width, f32, batch 1, one
    hypothesis, 512^2, train_VGG=False: on the card through the kernels
    and on the CPU through the twins, from one weight set (the
    zero-initialised layers drawn small) and one pinned x_T; flow and
    unwarped image within slice32's bars; launches and routes."""
    from dvd_tpu_torch.evaluation.pipeline import DewarpPipeline, unwarp_fixed

    state["alt32_launches"] = {}
    for tag, flags in ALT_CONFIGS:
        cfg = _alt_cfg(flags, model={"compute_dtype": "float32"},
                       diffusion={"n_batch": 1})
        m = cfg.model
        gen = torch.Generator().manual_seed(SEED + 11)
        src = _page(1, m.source_size, m.source_size, gen)
        noise = torch.randn((1, m.image_size, m.image_size, 2), generator=gen)
        runs = {}
        for dev in ("cuda", "cpu"):
            pipe = DewarpPipeline.create(
                cfg, dev, generator=torch.Generator().manual_seed(SEED + 12))
            if dev == "cuda":
                torch.cuda.synchronize()
                reset_launches()
            t0 = time.perf_counter()
            with vgg_k2_counter(pipe.vgg, {"wgmma": 0, "f32": 0}) as vgg_k2:
                flow = pipe.dewarp_flow(src.to(dev), init_noise=noise.to(dev))
                image = unwarp_fixed(src.to(dev), flow)
            if dev == "cuda":
                torch.cuda.synchronize()
                counts = dict(_main_run_counts(pipe), vgg_k2=vgg_k2)
            runs[dev] = (flow.cpu(), image.cpu())
            log(f"[alt32 {tag}] {dev}: float32 batch 1, {m.source_size}^2, "
                f"{cfg.diffusion.diffusion_steps} steps x 1 hypothesis in "
                f"{time.perf_counter() - t0:.2f} s")
            del pipe
        _check_alt_launches(f"alt32 {tag}", cfg, counts, torch.float32)
        (fc, ic), (fp, ip) = runs["cuda"], runs["cpu"]
        if not (torch.isfinite(fc).all() and fc.abs().max() <= 1):
            raise AssertionError(f"alt32 {tag}: flow not finite or outside "
                                 "[-1, 1]")
        log(f"[alt32 {tag}] flow |max| {fc.abs().max().item():.4f}, mean "
            f"|flow| {fc.abs().mean().item():.4f}, clamped at +-1: "
            f"{(fc.abs() >= 1).float().mean().item():.2%}")
        # relative to max|ref|: GeoTr2's seeded flow is a few hundredths
        compare(f"alt32 {tag} flow card vs CPU (x max|ref|)", fc, fp,
                TOL["slice_flow"], rel=True)
        compare(f"alt32 {tag} unwarped image card vs CPU", ic, ip,
                TOL["slice_image"])
        state["alt32_launches"][tag] = counts


def phase_alt_train32(state):
    """One f32 train step per family at full width, batch 2, 512^2: loss
    and every gradient on the card through the kernels against the CPU
    through the twins (train32's bars), the same weights (the
    zero-initialised layers drawn small), batch, t and noise."""
    from dvd_tpu_torch.evaluation.pipeline import DewarpPipeline
    from dvd_tpu_torch.training.train_loop import build_device_batch
    from dvd_tpu_torch.training.train_state import (create_train_state,
                                                    make_train_step)

    b = 2
    for tag, flags in ALT_CONFIGS[:3]:
        cfg = _alt_cfg(flags, model={"compute_dtype": "float32"},
                       train={"on_device_aug": False})
        m = cfg.model
        gen = torch.Generator().manual_seed(SEED + 13)
        raw = _wire_batch(b, gen)
        t = torch.tensor([0, cfg.diffusion.diffusion_steps - 1])
        noise = torch.randn((b, m.image_size, m.image_size, 2), generator=gen)
        runs = {}
        for dev in ("cuda", "cpu"):
            pipe = DewarpPipeline.create(
                cfg, dev, generator=torch.Generator().manual_seed(SEED + 14),
                train=True)
            _fill_zero_layers(pipe.dit, SEED + 15)
            train_state = create_train_state(cfg, pipe.dit)
            step = make_train_step(cfg, pipe.sched)
            if dev == "cuda":
                torch.cuda.synchronize()
                reset_launches()
            t0 = time.perf_counter()
            batch = build_device_batch(
                pipe, {k: v.to(dev) for k, v in raw.items()}, m.image_size)
            grads, _, metrics = step.loss_and_grads(train_state, batch, None,
                                                    t=t, noise=noise)
            if dev == "cuda":
                torch.cuda.synchronize()
                counts = dict(read_launches(),
                              attention_routes=routes("attention"),
                              conv3x3_routes=routes("conv3x3"))
                check_conv_route(f"alt_train32 {tag}", torch.float32)
            names = list(train_state.named_params())
            runs[dev] = (metrics["loss"].item(),
                         {k: g.detach().cpu() for k, g in zip(names, grads)})
            log(f"[alt_train32 {tag}] {dev}: float32 batch {b}, 512^2, "
                f"t={t.tolist()}, loss and gradients in "
                f"{time.perf_counter() - t0:.2f} s")
            del pipe, train_state
        log(f"[alt_train32 {tag}] kernel launches in the card step: {counts}")
        k1 = counts["attention_routes"]
        if counts["attention"] <= 0 or counts["conv3x3"] <= 0 or \
                k1 != {"wgmma": 0, "f32": counts["attention"]}:
            raise AssertionError(f"alt_train32 {tag}: K1 {k1}, K2 "
                                 f"{counts['conv3x3']}")
        (lc, gc), (lp, gp) = runs["cuda"], runs["cpu"]
        rel = abs(lc - lp) / max(abs(lp), 1e-30)
        log(f"[alt_train32 {tag}] loss card {lc:.8f} CPU {lp:.8f}: relative "
            f"{rel:.3e} (bar {TOL['train_loss_rel']:.0e})")
        if not (math.isfinite(lc) and rel <= TOL["train_loss_rel"]):
            raise AssertionError(f"alt_train32 {tag} loss: card {lc} vs CPU "
                                 f"{lp}")
        worst = (0.0, "")
        for k, want in gp.items():
            bar = TOL["train_grad"] * max(1.0, want.abs().max().item())
            err = (gc[k] - want).abs().max().item()
            if not (math.isfinite(err) and err <= bar):
                raise AssertionError(f"alt_train32 {tag} gradient {k}: "
                                     f"{err:.3e} > {bar:.3e}")
            worst = max(worst, (err / bar, k))
        nz = sum(int(g.abs().max() > 0) for g in gp.values())
        log(f"[alt_train32 {tag}] {len(gp)} gradient tensors ({nz} nonzero) "
            f"within {TOL['train_grad']:.0e} x max(1, max|g|); the closest "
            f"to its bar: {worst[1]} at {worst[0]:.3f} of it")


def phase_alt(state):
    """Each family served in bf16 at the shipped batch 4, 3 DDIM steps x 2
    hypotheses, 512^2 pages: launches and routes, outputs, K2's shape
    classes; then the CLI's
    single-image functions under ``--set model.train_mode=stage_1 --set
    model.train_VGG=False`` on a 600x450 page."""
    from dvd_tpu_torch.cli.run_sampling import (build_pipeline, dewarp_image,
                                                parse_overrides)
    from dvd_tpu_torch.config import default_config
    from dvd_tpu_torch.evaluation.pipeline import DewarpPipeline, unwarp_fixed
    from dvd_tpu_torch.training.checkpoint import maybe_load_pipeline_weights

    label = state["label"]
    state["alt_launches"] = {}
    for tag, flags in ALT_CONFIGS:
        cfg = _alt_cfg(flags)
        m, d = cfg.model, cfg.diffusion
        batch = cfg.data.eval_device_batch
        pipe = DewarpPipeline.create(
            cfg, "cuda", generator=torch.Generator().manual_seed(SEED + 3))
        gen = torch.Generator().manual_seed(SEED + 4)
        src = _page(batch, m.source_size, m.source_size, gen).cuda()
        cuda_gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
        log(f"[alt {tag}] {m.compute_dtype} batch {batch}, "
            f"{m.source_size}^2, {d.diffusion_steps} DDIM steps x "
            f"{d.n_batch} hypotheses ({label})")
        torch.cuda.synchronize()
        reset_launches()
        with conv_shape_counter(Counter()) as shapes, torch.inference_mode(), \
                vgg_k2_counter(pipe.vgg, {"wgmma": 0, "f32": 0}) as vgg_k2:
            flow = pipe.dewarp_flow(src, generator=cuda_gen)
            out = unwarp_fixed(src, flow)
        torch.cuda.synchronize()
        counts = dict(_main_run_counts(pipe), vgg_k2=vgg_k2)
        _check_alt_launches(f"alt {tag}", cfg, counts, torch.bfloat16)
        table = {"stage_1": UNET_CLASSES,
                 "stage_1_doctr": GEOTR2_CLASSES}.get(m.train_mode, {})
        off = {c: (shapes[c], n) for c, n in table.items() if shapes[c] != n}
        if off:   # phase 2 times K2 at these classes: they must be the run's
            raise AssertionError(f"alt {tag}: K2 classes (launched, "
                                 f"expected): {off}")
        if flow.shape != (batch, m.image_size, m.image_size, 2) or \
                out.shape != src.shape or not (
                    torch.isfinite(flow).all() and torch.isfinite(out).all()
                    and flow.abs().max() <= 1):
            raise AssertionError(f"alt {tag}: outputs malformed, not finite "
                                 "or the flow outside [-1, 1]")
        log(f"[alt {tag}] flow |max| {flow.abs().max().item():.4f}, mean "
            f"|flow| {flow.abs().mean().item():.4f}; unwarped image range "
            f"[{out.min().item():.3f}, {out.max().item():.3f}]")
        state["alt_launches"][tag] = counts
        del pipe

    # the CLI's single-image path (its --image entry reads the file with
    # PIL, which the card's machine lacks): its overrides, pipeline, weight
    # loading and array function
    cfg = default_config().replace(**parse_overrides(
        ["model.train_mode=stage_1", "model.train_VGG=False"]))
    pipe = build_pipeline(cfg, SEED, "cuda")
    loaded = maybe_load_pipeline_weights(pipe, cfg)
    page = (_page(1, 450, 600, torch.Generator().manual_seed(SEED + 6))[0]
            * 255).round().numpy()
    before = read_launches()
    out_img, out_flow = dewarp_image(pipe, page, seed=SEED)
    torch.cuda.synchronize()
    after = read_launches()
    if out_img.shape != (450, 600, 3) or out_flow.shape != (
            cfg.model.image_size, cfg.model.image_size, 2) \
            or not np.isfinite(out_img).all() or np.abs(out_flow).max() > 1:
        raise AssertionError("alt CLI outputs malformed")
    if any(after[k] <= before[k] for k in ("attention", "conv3x3", "unwarp")):
        raise AssertionError(f"alt CLI: launches {before} -> {after}")
    log(f"[alt] cli (--set model.train_mode=stage_1 --set "
        f"model.train_VGG=False) dewarp_image 600x450 page: "
        f"{out_img.shape}; weight files loaded {loaded}")


# the corruptions the card's machine can run (it has no cv2)
def _corruptions_without_cv2():
    from dvd_tpu_torch.data.corruptions import CORRUPTIONS, NEEDS_CV2

    return [n for n in sorted(CORRUPTIONS) if n not in NEEDS_CV2]


def phase_corrupt(state):
    """``run_corruption_sweep`` (int8 serving) over 6 stand-in pages with
    every corruption that needs no cv2 at severities 1 and 5: one
    ``run_stats.json`` per combination, and every page the driver read
    equal to ``corrupt`` of that page on the host."""
    from dvd_tpu_torch.cli.run_sampling import run_corruption_sweep
    from dvd_tpu_torch.config import default_config
    from dvd_tpu_torch.data import corruptions
    from dvd_tpu_torch.evaluation.pipeline import DewarpPipeline
    from dvd_tpu_torch.ops import quant

    cfg = default_config().replace(model={"quantize": "int8"},
                                   data={"eval_dataset_name": "stand_in"})
    cfg = dataclasses.replace(cfg, name="sweep")
    pipe = DewarpPipeline.create(
        cfg, "cuda", generator=torch.Generator().manual_seed(SEED + 3))
    ds, sizes = _stand_in_dataset(6, SEED + 30, cfg.model.source_size,
                                  sides=(500, 801))
    names, sevs = _corruptions_without_cv2(), (1, 5)
    seen = {}
    item_fn = corruptions.corrupt_item

    def recorded(item, name, sev):
        out = item_fn(item, name, sev)
        seen[(name, sev, item["path"])] = (item, out)
        return out

    corruptions.corrupt_item = recorded
    torch.cuda.synchronize()
    reset_launches()
    try:
        stats = run_corruption_sweep(
            pipe, ds, cfg, names, sevs, seed=SEED,
            out_root=os.path.join(state["workdir"], "sweep"),
            save_outputs=False, save_coord_maps=True)
    finally:
        corruptions.corrupt_item = item_fn
    torch.cuda.synchronize()
    counts, n_int8 = read_launches(), quant.launches
    check_conv_route("corrupt", torch.bfloat16)
    check_gather_route("corrupt")
    log(f"[corrupt] {len(names)} corruptions {names} x severities {sevs} over "
        f"{len(ds)} stand-in pages ({min(map(min, sizes))}-"
        f"{max(map(max, sizes))} px, canvas {ds.pad_to}^2), int8, batch "
        f"{cfg.data.eval_device_batch}: launches {counts}, int8 products "
        f"{n_int8}")
    if min(counts[k] for k in ("attention", "conv3x3", "gather_bilinear",
                               "unwarp")) <= 0 or n_int8 <= 0:
        raise AssertionError(f"a kernel of the sweep did not launch: {counts}")
    out_root = os.path.join(state["workdir"], "sweep", "stand_in")
    for name in names:
        for sev in sevs:
            out_dir = os.path.join(out_root, f"sweep_corrupt_{name}_s{sev}")
            with open(os.path.join(out_dir, "run_stats.json")) as f:
                rs = json.load(f)
            maps = sorted(os.listdir(os.path.join(out_dir, "dewarped_pred")))
            if rs != stats[(name, sev)] or rs["images"] != len(ds) \
                    or len(maps) != len(ds):
                raise AssertionError(f"{out_dir}: {rs}, {len(maps)} maps")
            log(f"[corrupt] {name} s{sev}: run_stats.json with "
                f"{rs['images']} images, {len(maps)} coordinate maps")
            for path in ds.paths:
                item, got = seen[(name, sev, path)]
                want_src = corruptions.corrupt(item["source_image"], name, sev)
                pad = item["source_padded"].astype(np.float32) / 255.0
                want_pad = (corruptions.corrupt(pad, name, sev) * 255).astype(
                    np.uint8)
                if not (np.array_equal(got["source_image"], want_src)
                        and np.array_equal(got["source_padded"], want_pad)):
                    raise AssertionError(f"{name} s{sev} {path}: the page "
                                         f"the driver read is not corrupt's")
    log(f"[corrupt] every page the driver read equals corrupt() of it on "
        f"the host ({len(seen)} page x combination pairs)")


def phase_score(state):
    """The port's SIFT-flow engine built with g++ here, then the shipped
    (bf16) and int8 outputs of the four stand-in pages scored against the
    pages themselves at equal size: MS-SSIM and the native LD/AD.  With
    random weights these are readings, not bars."""
    from dvd_tpu_torch import native
    from dvd_tpu_torch.evaluation.metrics import evaluate_pair

    t0 = time.perf_counter()
    ok = native.available()
    info = native.build_info()
    gxx = subprocess.run(["g++", "--version"], capture_output=True,
                         text=True).stdout.splitlines()[:1]
    how = "built" if info["build_seconds"] else "loaded"
    log(f"[score] SIFT-flow engine: {how} in {time.perf_counter() - t0:.2f} "
        f"s (g++ {info['build_seconds']:.2f} s; {gxx}) -> {info['path']}")
    if not ok:
        raise AssertionError(f"the SIFT-flow engine did not build: "
                             f"{native.build_error()}")
    pages = (state["shipped"]["src"].numpy() * 255).astype(np.float32)
    same = evaluate_pair(pages[0], pages[0], protocol_area=None,
                         flow_backend="native")
    log(f"[score] a page against itself: {same}")
    if same["ld"] > 0.05 or abs(same["ms_ssim"] - 1) > 1e-6:
        raise AssertionError(f"a page against itself scored {same}")
    for tag, outs in (("shipped bf16", state["shipped"]["out"]),
                      ("shipped int8", state["shipped_int8"]["out"])):
        t0 = time.perf_counter()
        rows = [evaluate_pair(o * 255, p, protocol_area=None,
                              flow_backend="native")
                for o, p in zip(outs.numpy(), pages)]
        if not all(math.isfinite(v) for r in rows for v in r.values()):
            raise AssertionError(f"{tag}: scores not finite: {rows}")
        mean = {k: float(np.mean([r[k] for r in rows])) for k in rows[0]}
        log(f"[score] {tag} unwarped vs its page, {len(rows)} pages "
            f"{pages.shape[1]}x{pages.shape[2]} (random weights: readings): "
            f"mean {json.dumps(mean)}; per page "
            f"{json.dumps(rows)} ({time.perf_counter() - t0:.2f} s)")


# ---------------------------------------------------------------- main
# ---------------------------------------------------------------- phases 11-13
def phase_likelihood32(state):
    """``calc_bpd_loop`` at f32 on the shipped DiT-S/2 (its conditioning
    hoisted out of the loop, as serving hoists it), batch 2 at 512^2,
    each step's noise pinned: card against CPU."""
    from dvd_tpu_torch.config import default_config
    from dvd_tpu_torch.diffusion import gaussian as G
    from dvd_tpu_torch.diffusion.likelihood import calc_bpd_loop
    from dvd_tpu_torch.evaluation.pipeline import DewarpPipeline
    from dvd_tpu_torch.utils.grids import base_grid

    cfg = default_config().replace(model={"compute_dtype": "float32"})
    m, b = cfg.model, 2
    s = m.image_size
    gen = torch.Generator().manual_seed(SEED + 30)
    src = _page(b, m.source_size, m.source_size, gen)
    # x_0: a backward map in [-1, 1], the identity grid moved smoothly
    x0 = ((base_grid(s, s) + _smooth_flow(b, s, gen)) * 2 - 1).clamp(-1, 1)
    x0 = x0.permute(0, 3, 1, 2).contiguous()
    noise = torch.randn((cfg.diffusion.diffusion_steps,) + tuple(x0.shape),
                        generator=gen)
    pipes = {dev: DewarpPipeline.create(
        cfg, dev, generator=torch.Generator().manual_seed(SEED + 31))
        for dev in ("cpu", "cuda")}
    shift = _mask_logit_shift(pipes["cpu"], src)
    log(f"[likelihood32] cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    if torch.backends.cudnn.allow_tf32 \
            or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("likelihood32 runs with both TF32 switches off")
    runs = {}
    for dev in ("cuda", "cpu"):
        pipe = pipes[dev]
        with torch.no_grad():
            pipe.seg.msk.outconv.bias += shift
        T = pipe.sched.num_timesteps
        with torch.inference_mode():
            if dev == "cuda":
                torch.cuda.synchronize()
                reset_launches()
            t0 = time.perf_counter()
            cond, init_flow, init_feat = pipe.build_conditioning(src.to(dev))
            cond = pipe._hoist_stream_tokens(pipe._hoist_pyramid(cond))

            def denoise(x_t, t):
                pred, _ = pipe.model_fn(
                    x_t.permute(0, 2, 3, 1).contiguous(),
                    G.model_t(pipe.sched, t), cond, init_flow=init_flow,
                    init_feat=init_feat, seed_init_feat=t == T - 1,
                    remap_timesteps=True)
                return pred.permute(0, 3, 1, 2)

            out = calc_bpd_loop(denoise, pipe.sched, x0.to(dev), None,
                                noise=noise.to(dev))
            if dev == "cuda":
                torch.cuda.synchronize()
                counts = dict(read_launches(),
                              attention_routes=routes("attention"),
                              conv3x3_routes=routes("conv3x3"))
                check_conv_route("likelihood32", torch.float32)
        runs[dev] = {k: v.cpu() for k, v in out.items()}
        log(f"[likelihood32] {dev}: {m.dit_variant} float32, batch {b}, "
            f"{m.source_size}^2, {T}-step {cfg.diffusion.noise_schedule} "
            f"schedule: calc_bpd_loop in {time.perf_counter() - t0:.2f} s "
            f"(outconv bias shift {shift:+.3f})")
    del pipes
    log(f"[likelihood32] card: kernel launches {counts}")
    if counts["attention"] <= 0 or counts["conv3x3"] <= 0:
        raise AssertionError(f"K1 or K2 did not launch: {counts}")
    c, p = runs["cuda"], runs["cpu"]
    log(f"[likelihood32] CPU: total_bpd {p['total_bpd'].tolist()}, prior "
        f"{p['prior_bpd'].tolist()}, vb by t {p['vb'].tolist()}")
    for k in ("total_bpd", "vb", "xstart_mse", "mse"):
        bar = TOL["likelihood"] * p[k].abs().max().item()
        err = (c[k] - p[k]).abs().max().item()
        log(f"[likelihood32] {k} card vs CPU: max |d| {err:.3e} (bar "
            f"{TOL['likelihood']:.0e} x max|ref| = {bar:.3e}) "
            f"{'ok' if err <= bar else 'FAIL'}")
        if not (math.isfinite(err) and err <= bar):
            raise AssertionError(f"likelihood32 {k}: {err:.3e} > {bar:.3e}")


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@contextlib.contextmanager
def _deterministic_cudnn():
    """cuDNN's deterministic algorithms while open (the trainable conv's
    backward takes cuDNN's): two runs of one step then agree bit for
    bit."""
    old = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = old


def phase_dist1(state):
    """A 1-process NCCL world through the ``--multihost`` code path
    (``cli.run_training.init_from_env``, ``make_mesh``, ``train(mesh=)``):
    3 shipped train steps equal the plain ``train()``'s bit for bit, and
    ``run_benchmark(mesh="auto")`` over stand-in pages equals the plain
    run bit for bit: an all-reduce over one rank is the identity."""
    import torch.distributed as dist

    from dvd_tpu_torch.cli.run_training import (device_resident_iterator,
                                                init_from_env)
    from dvd_tpu_torch.config import default_config
    from dvd_tpu_torch.evaluation.driver import run_benchmark
    from dvd_tpu_torch.evaluation.pipeline import DewarpPipeline
    from dvd_tpu_torch.parallel.mesh import make_mesh
    from dvd_tpu_torch.training.checkpoint import unsharded_state
    from dvd_tpu_torch.training.train_loop import train

    steps = 3
    ds = StandInRawPages(TRAIN_SET, SEED + 8)
    pages, _ = _stand_in_dataset(8, SEED + 41, 512, sides=(500, 900))
    runs, maps = {}, {}
    with tempfile.TemporaryDirectory() as ws, _deterministic_cudnn():
        for world in (False, True):
            cfg = default_config().replace(
                train={"save_interval": 10 ** 9},
                paths={"workspace_dir": os.path.join(ws, str(world))})
            device, mesh = "cuda", None
            if world:
                os.environ.update(MASTER_ADDR="127.0.0.1",
                                  MASTER_PORT=str(_free_port()), RANK="0",
                                  WORLD_SIZE="1", LOCAL_RANK="0")
                device = init_from_env("cuda")
                mesh = make_mesh(cfg.parallel.data_axis,
                                 cfg.parallel.model_axis)
                log(f"[dist1] world: backend {dist.get_backend()}, "
                    f"{dist.get_world_size()} rank on {device}, mesh "
                    f"{mesh.shape}")
            try:
                data = device_resident_iterator(cfg, ds, SEED + 8, device)
                logger = _row_logger()
                torch.cuda.synchronize()
                reset_launches()
                st = train(cfg, data, max_steps=steps, device=device,
                           logger=logger, mesh=mesh)
                torch.cuda.synchronize()
                counts = read_launches()
                runs[world] = (unsharded_state(st), logger.rows)
                log(f"[dist1] {'NCCL world' if world else 'plain'} train(): "
                    f"{steps} steps of the shipped config (batch "
                    f"{cfg.train.batch_size}); launches {counts}")
                if min(counts[k] for k in TRAIN_KERNELS) <= 0:
                    raise AssertionError(f"a kernel did not launch: {counts}")
                pipe = DewarpPipeline.create(
                    cfg, device, generator=torch.Generator().manual_seed(
                        SEED + 42))
                out = os.path.join(ws, f"serve{world}")
                reset_launches()
                stats = run_benchmark(
                    pipe, pages, out, batch_size=cfg.data.eval_device_batch,
                    seed=SEED, save_outputs=False, save_coord_maps=True,
                    mesh="auto" if world else None)
                counts = read_launches()
                if stats["images"] != len(pages) or min(
                        counts[k] for k in ("attention", "conv3x3",
                                            "gather_bilinear", "unwarp")) <= 0:
                    raise AssertionError(f"serving: {stats}, {counts}")
                maps[world] = {n: np.load(os.path.join(out, "dewarped_pred",
                                                       n))
                               for n in sorted(os.listdir(
                                   os.path.join(out, "dewarped_pred")))}
            finally:
                if world:
                    dist.destroy_process_group()
                    for key in ("MASTER_ADDR", "MASTER_PORT", "RANK",
                                "WORLD_SIZE", "LOCAL_RANK"):
                        os.environ.pop(key, None)
    ((m0, o0, e0), rows0), ((m1, o1, e1), rows1) = runs[False], runs[True]
    same = all(torch.equal(m0[k], m1[k]) for k in m0) and all(
        torch.equal(a[k], b[k]) for a, b in zip(e0, e1) for k in a) and all(
        torch.equal(x[k], y[k]) for i in o0["adamw"]["state"]
        for x, y in ((o0["adamw"]["state"][i], o1["adamw"]["state"][i]),)
        for k in x)
    log(f"[dist1] plain vs NCCL world: logged loss {rows0[0]['loss']!r} vs "
        f"{rows1[0]['loss']!r}; parameters, BN statistics, EMA and AdamW "
        f"moments after {steps} steps "
        f"{'equal bit for bit' if same else 'DIFFER'}")
    def logged(rows):       # the logged values, but for the rate
        return [{k: v for k, v in r.items() if k != "samples_per_sec"}
                for r in rows]

    if not same or logged(rows0) != logged(rows1):
        raise AssertionError("dist1: the 1-rank world's training differs")
    same_maps = maps[False].keys() == maps[True].keys() and all(
        np.array_equal(maps[False][n], maps[True][n]) for n in maps[False])
    log(f"[dist1] run_benchmark mesh=None vs mesh='auto' over {len(pages)} "
        f"stand-in pages: {len(maps[True])} coordinate maps "
        f"{'equal bit for bit' if same_maps else 'DIFFER'}")
    if not same_maps:
        raise AssertionError("dist1: the 1-rank world's serving differs")


# dist2's layouts: (name, data, model, fsdp)
DIST2_STEPS = (("data2", 2, 1, False), ("model2", 1, 2, False),
               ("data2_fsdp", 2, 1, True))
DIST2_SERVE = (("data2", 2, 1), ("model2", 1, 2))


def _dist2_cfg():
    from dvd_tpu_torch.config import default_config

    return default_config().replace(model={"compute_dtype": "float32"},
                                    data={"eval_device_batch": 4})


def _dist2_net(cfg):
    """DiT-S/2 from one seed (the zero-initialised layers drawn small),
    dropout off, f32 on the card."""
    from dvd_tpu_torch.models.layers import seeded_init_
    from dvd_tpu_torch.models.registry import create_model

    net = seeded_init_(create_model(cfg), torch.Generator().manual_seed(
        SEED + 43))
    _no_dropout(net)
    return net.cuda()


@contextlib.contextmanager
def _k4_points(record: dict, ref=None):
    """While open, the loss warp's K4 (``warp_const_src``'s backward,
    patched here, never in the package) records its [-1, 1] points in
    ``record["points"]``; given ``ref`` (the points one process's K4 saw
    for these rows), it takes ref's point wherever its own lies in another
    bilinear cell, and counts them in ``record["crossed"]``.  The
    derivative jumps at a cell edge, by the whole edge value at the
    'zeros' border (``_loss_warp_points``); a layout's rounding moves the
    points by ~1e-7, so now and then one crosses, a measure-zero event
    that is no fault of either side."""
    from dvd_tpu_torch.ops import grid_sample as gs
    kernel = gs.gather_bilinear_grad

    def patched(img, grid, ct, padding_mode="zeros"):
        if ref is not None:
            other = ref.to(grid.device)
            crossed = (_cells(img, grid) != _cells(img, other)).any(
                -1, keepdim=True)
            record["max_d"] = (grid - other).abs().max().item()
            record["crossed"] = int(crossed.sum())
            grid = torch.where(crossed, other, grid)
        record["points"] = grid.cpu()
        return kernel(img, grid, ct, padding_mode)

    gs.gather_bilinear_grad = patched
    try:
        yield
    finally:
        gs.gather_bilinear_grad = kernel


def _dist2_worker(rank: int, port: int, spec_path: str, out_path: str):
    """One rank of dist2's world: gloo over cuda:0, every layout of
    ``DIST2_STEPS`` and ``DIST2_SERVE`` in turn; rank 0 writes the
    results."""
    import torch.distributed as dist

    from dvd_tpu_torch.evaluation.driver import run_benchmark
    from dvd_tpu_torch.evaluation.pipeline import DewarpPipeline
    from dvd_tpu_torch.ops.kernels import build
    from dvd_tpu_torch.parallel.mesh import (batch_slice, init_distributed,
                                             make_mesh)
    from dvd_tpu_torch.training.train_state import (create_train_state,
                                                    make_train_step,
                                                    shard_train_state)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    build.load_library()            # built by the parent
    init_distributed("gloo", "cuda:0", rank=rank, world_size=2,
                     init_method=f"tcp://127.0.0.1:{port}")
    spec = torch.load(spec_path, weights_only=False)
    cfg = _dist2_cfg()
    results = {"backend": dist.get_backend()}
    try:
        for name, data, model, fsdp in DIST2_STEPS:
            mesh = make_mesh(data, model)
            net = _dist2_net(cfg)
            st = shard_train_state(cfg, create_train_state(cfg, net), mesh,
                                   fsdp)
            step = make_train_step(cfg, spec["sched"], mesh=mesh)
            n = 4 // data
            rows = batch_slice(mesh, n)
            batch = {k: v[rows].cuda() for k, v in spec["batch"].items()}
            pins = {k: v.cuda() for k, v in spec["pins"].items()}
            record = {}
            opt_step = st.optimizer.step

            def recording(grads, opt_step=opt_step, record=record):
                record["grads"] = [g.clone() for g in grads]
                return opt_step(grads)

            st.optimizer.step = recording
            torch.cuda.synchronize()
            reset_launches()
            k4 = {}
            with _k4_points(k4, spec["points"][rows]):
                st, m = step(st, batch, None, **pins)
            torch.cuda.synchronize()
            counts = dict(read_launches(), attention_by_dh=attention_by_dh())
            lay = st.layout
            grads = {k: lay.unsharded(k, g).cpu()
                     for k, g in zip(lay.held, record["grads"])}
            results[name] = dict(loss=m["loss"].item(), grads=grads,
                                 launches=counts,
                                 sharded=len(lay.placements),
                                 crossed=k4["crossed"], max_d=k4["max_d"])
            del st, step, net
        pages, _ = _stand_in_dataset(8, SEED + 44, 512, sides=(500, 900))
        for name, data, model in DIST2_SERVE:
            mesh = make_mesh(data, model)
            pipe = DewarpPipeline.create(
                cfg, "cuda:0", generator=torch.Generator().manual_seed(
                    SEED + 45))
            out = os.path.join(spec["workdir"], f"serve_{name}")
            reset_launches()
            stats = run_benchmark(pipe, pages, out, batch_size=4, seed=SEED,
                                  save_outputs=False, save_coord_maps=True,
                                  mesh=mesh)
            results[f"serve_{name}"] = dict(stats=stats, out=out,
                                            launches=read_launches())
            del pipe
        dist.barrier()
        if rank == 0:
            torch.save(results, out_path)
    finally:
        dist.destroy_process_group()


def phase_dist2(state):
    """Two processes on cuda:0 over gloo (NCCL refuses two ranks on one
    device), DiT-S/2 at full width in f32, global batch 4 (2 a rank at
    data=2), SATRN's BN in train mode, dropout off: one step at data=2,
    model=2 and data=2 with FSDP, each against this process's step on the
    global batch (train32's bars); serving at data=2 and model=2 against
    this process's run (slice32's bar on the flows)."""
    from dvd_tpu_torch.evaluation.driver import run_benchmark
    from dvd_tpu_torch.evaluation.pipeline import DewarpPipeline
    from dvd_tpu_torch.training.train_loop import build_device_batch
    from dvd_tpu_torch.training.train_state import (create_train_state,
                                                    make_train_step)

    cfg = _dist2_cfg()
    m = cfg.model
    gen = torch.Generator().manual_seed(SEED + 46)
    raw = _wire_batch(4, gen)
    pins = {"t": torch.tensor([0, 1, 2, 2]),
            "noise": torch.randn((4, m.image_size, m.image_size, 2),
                                 generator=gen)}
    pins["rollout_noise"] = torch.randn(pins["noise"].shape, generator=gen)
    pipe = DewarpPipeline.create(
        cfg, "cuda", generator=torch.Generator().manual_seed(SEED + 47),
        train=True)
    with torch.no_grad():
        pipe.seg.msk.outconv.bias += _mask_logit_shift(
            pipe, raw["source_image"])
    batch = build_device_batch(pipe, {k: v.cuda() for k, v in raw.items()},
                               m.image_size)
    spec = {"batch": {k: v.cpu() for k, v in batch.items()}, "pins": pins,
            "sched": pipe.sched, "workdir": state["workdir"]}
    del pipe
    # this process's step on the global batch
    net = _dist2_net(cfg)
    st = create_train_state(cfg, net)
    step = make_train_step(cfg, spec["sched"])
    k4 = {}
    with _k4_points(k4):
        grads, _, metrics = step.loss_and_grads(
            st, batch, None, **{k: v.cuda() for k, v in pins.items()})
    spec["points"] = k4["points"]
    ref_loss = metrics["loss"].item()
    ref = {k: g.cpu() for k, g in zip(st.named_params(), grads)}
    del st, step, net, grads
    # this process's serving run
    pages, _ = _stand_in_dataset(8, SEED + 44, 512, sides=(500, 900))
    pipe = DewarpPipeline.create(
        cfg, "cuda", generator=torch.Generator().manual_seed(SEED + 45))
    one = os.path.join(state["workdir"], "serve_one")
    run_benchmark(pipe, pages, one, batch_size=4, seed=SEED,
                  save_outputs=False, save_coord_maps=True, mesh=None)
    del pipe
    spec_path = os.path.join(state["workdir"], "dist2_spec.pt")
    out_path = os.path.join(state["workdir"], "dist2_out.pt")
    torch.save(spec, spec_path)
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dist2-worker",
         str(r), str(port), spec_path, out_path]) for r in range(2)]
    try:
        rcs = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if rcs != [0, 0]:
        raise AssertionError(f"dist2 world exited {rcs}")
    res = torch.load(out_path, weights_only=False)
    log(f"[dist2] the world: 2 processes on cuda:0, backend "
        f"{res['backend']}")
    failed = []
    for name, data, model, fsdp in DIST2_STEPS:
        r = res[name]
        rel = abs(r["loss"] - ref_loss) / max(abs(ref_loss), 1e-30)
        ratios = []
        for k, want in ref.items():
            bar = TOL["train_grad"] * max(1.0, want.abs().max().item())
            err = (r["grads"][k] - want).abs().max().item()
            ratios.append((err / bar if math.isfinite(err) else math.inf, k))
        ratios.sort(reverse=True)
        log(f"[dist2] {name} (data={data} model={model} fsdp={fsdp}, "
            f"{r['sharded']} parameters sharded): loss {r['loss']:.8f} vs "
            f"one process {ref_loss:.8f}, relative {rel:.3e} (bar "
            f"{TOL['train_loss_rel']:.0e}); {len(ref)} gradients against "
            f"{TOL['train_grad']:.0e} x max(1, max|g|), the closest "
            + ", ".join(f"{k} at {x:.3f}" for x, k in ratios[:3])
            + f" of the bar; the loss warp's points vs one process's: max "
            f"|d| {r['max_d']:.3e}, {r['crossed']} in another cell (K4 "
            f"took one process's there); rank 0's launches "
            f"{r['launches']}")
        if not rel <= TOL["train_loss_rel"] or ratios[0][0] > 1:
            failed.append(name)
        if min(r["launches"][k] for k in TRAIN_KERNELS) <= 0:
            failed.append(f"{name}: a kernel did not launch")
    for name, data, model in DIST2_SERVE:
        r = res[f"serve_{name}"]
        if r["stats"]["images"] != len(pages):
            raise AssertionError(f"dist2 serve {name}: {r['stats']}")
        worst = 0.0
        for f in sorted(os.listdir(os.path.join(one, "dewarped_pred"))):
            a = np.load(os.path.join(r["out"], "dewarped_pred", f))
            b = np.load(os.path.join(one, "dewarped_pred", f))
            worst = max(worst, float(np.abs(a - b).max()))
        log(f"[dist2] serving {name}: {r['stats']['images']} pages, "
            f"coordinate maps vs one process max |d| {worst:.3e} (bar "
            f"{TOL['slice_flow']:.0e}); rank 0's launches {r['launches']}")
        if not worst <= TOL["slice_flow"] or min(
                r["launches"][k] for k in ("attention", "conv3x3",
                                           "unwarp")) <= 0:
            failed.append(f"serve {name}")
    if failed:
        raise AssertionError(f"dist2 failed: {failed}")


PHASES = (phase_env, phase_kernels, phase_int8, phase_adaln, phase_slice32,
          phase_slice_int8, phase_flags32, phase_alt32, phase_shipped,
          phase_shipped_int8, phase_shipped32, phase_flags, phase_alt,
          phase_train32, phase_flags_train32, phase_alt_train32, phase_train,
          phase_probe, phase_dataset, phase_corrupt, phase_score,
          phase_likelihood32, phase_dist1, phase_dist2)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="drive dvd_tpu_torch on one GPU")
    ap.add_argument("--phases", default=None, metavar="A,B",
                    help="run only these phases, by name (e.g. env,int8; "
                         "a phase needing an earlier one's state needs it "
                         "too) and print no result lines")
    ap.add_argument("--dist2-worker", nargs=4, default=None,
                    metavar=("RANK", "PORT", "SPEC", "OUT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.dist2_worker:
        rank, port, spec, out = args.dist2_worker
        _dist2_worker(int(rank), int(port), spec, out)
        return 0
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on a GPU only")
    phases = PHASES
    if args.phases:
        names = args.phases.split(",")
        phases = [p for p in PHASES if p.__name__[len("phase_"):] in names]
        if len(phases) != len(names):
            ap.error(f"--phases: unknown in {names}")
    state: dict = {}
    with tempfile.TemporaryDirectory() as work:
        state["workdir"] = work
        for phase in phases:
            phase(state)
    if args.phases:
        log(f"partial run: {args.phases} passed; no result lines")
        return 0
    kernels = []
    launches = {"train": state["train_launches"], "serving": state["serve_launches"],
                "train32": state["train32_launches"],
                "probe": state["probe_launches"],
                "flags": state["flags_launches"],
                "flags32": state["flags32_launches"],
                "alt": alt_kernel_launches(state["alt_launches"], "bf16"),
                "alt32": alt_kernel_launches(state["alt32_launches"], "f32")}
    for name, (src, replaces, run) in KERNELS.items():
        r = state["kernel_times"][(name, RECORD_CASE[name])]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[run][name], "launches_from": run,
            "launches_serving": state["serve_launches"].get(name, 0),
            "max_abs_err": state["kernel_errs"][name],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "case": RECORD_CASE[name],
            **({k: r[k] for k in ("yardstick_ms", "graph_ms", "library_graph_ms")
                if k in r}),
        })
    # the int8 GEMM: a library call (torch._int_mm), no hand-written kernel
    name, route, src, replaces = INT8_KERNEL
    r = state["int8_times"][INT8_RECORD]
    ms, bounds = r["ms"], r["bounds"]
    kernels.append({
        "name": name, "route": route, "source": src, "replaces": replaces,
        "launches": state["shipped_int8"]["launches"],
        "launches_from": "serving int8",
        "max_abs_err": state["int8_err"], "ms": ms["int_mm"],
        "plain_ms": ms["plain"], "bound_ms": bounds["int_mm"][0],
        "bound_by": bounds["int_mm"][1], "library_ms": ms["int_mm"],
        "case": f"(M, K, N) = {INT8_RECORD}",
        "bf16_matmul_ms": ms["bf16_matmul"], "quantize_ms": ms["quantize"],
        "rescale_ms": ms["rescale"], "int8_dense_ms": ms["int8_dense"],
        "int8_dense_bound_ms": bounds["int8_dense"][0]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
