"""``dvd_tpu_torch`` ops, diffusion tables and package plumbing against
``dvd_tpu`` (CPU, f32).

Covers grids, resize, grid_sample/warp (~1e-6), the schedule tables and
the DDIM step table for table, the kernel wrappers' CPU dispatch, the
sm_90a build command, and that the port imports no JAX, flax or PIL.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_common  # noqa: F401  (sets torch to 1 thread)
from dvd_tpu.diffusion import gaussian as jG
from dvd_tpu.diffusion.schedule import make_schedule as j_make_schedule
from dvd_tpu.ops.grid_sample import grid_sample as j_grid_sample
from dvd_tpu.ops.grid_sample import warp as j_warp
from dvd_tpu.ops.resize import resize_bilinear as j_resize
from dvd_tpu.utils.grids import base_grid as j_base_grid
from dvd_tpu.utils.grids import flow_to_grid as j_flow_to_grid
from dvd_tpu_torch.diffusion import gaussian as G
from dvd_tpu_torch.diffusion.schedule import make_schedule
from dvd_tpu_torch.models.layers import conv1x1_f32
from dvd_tpu_torch.ops.grid_sample import grid_sample, warp
from dvd_tpu_torch.ops.kernels import build
from dvd_tpu_torch.ops.kernels.attention import attention, attention_ref
from dvd_tpu_torch.ops.kernels.conv3x3 import (chunk_channels, conv3x3,
                                               conv3x3_ref, k_major_cols,
                                               k_major_weights)
from dvd_tpu_torch.ops.kernels.gather2d import gather2d, gather2d_ref
from dvd_tpu_torch.ops.kernels.grid_sample import (
    gather_bilinear, gather_bilinear_grad, gather_bilinear_grad_grid_ref,
    gather_bilinear_grid, gather_bilinear_grid_ref, gather_bilinear_ref)
from dvd_tpu_torch.ops.kernels.unwarp import unwarp, unwarp_ref
from dvd_tpu_torch.ops.resize import resize_bilinear
from dvd_tpu_torch.utils.grids import base_grid, flow_to_grid
from test_torch_common import nchw, nhwc, t

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("hw", [(5, 7), (16, 16), (33, 20)])
def test_base_grid_and_flow_to_grid(hw):
    h, w = hw
    np.testing.assert_array_equal(base_grid(h, w).numpy(),
                                  np.asarray(j_base_grid(h, w)))
    flow = np.random.RandomState(0).randn(2, h, w, 2).astype(np.float32) * 0.1
    np.testing.assert_allclose(flow_to_grid(t(flow), 0.987).numpy(),
                               np.asarray(j_flow_to_grid(jnp.asarray(flow),
                                                         0.987)),
                               atol=1e-6)


@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("src,dst", [((9, 7), (20, 31)), ((64, 64), (16, 16)),
                                     ((18, 18), (64, 64))])
def test_resize_bilinear(align, src, dst):
    x = np.random.RandomState(1).rand(2, *src, 3).astype(np.float32)
    want = np.asarray(j_resize(jnp.asarray(x), dst, align_corners=align))
    got = nhwc(resize_bilinear(nchw(x), dst, align_corners=align))
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_grid_sample(padding_mode):
    rng = np.random.RandomState(2)
    img = rng.rand(2, 13, 17, 3).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, (2, 9, 11, 2)).astype(np.float32)
    want = np.asarray(j_grid_sample(jnp.asarray(img), jnp.asarray(grid),
                                    align_corners=True,
                                    padding_mode=padding_mode))
    got = nhwc(grid_sample(nchw(img), t(grid), padding_mode=padding_mode))
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_warp_features():
    """The sampler's time-variant feature re-warp: 256-ch features at the
    latent size, grid from a flow."""
    rng = np.random.RandomState(3)
    feat = rng.randn(2, 16, 16, 256).astype(np.float32)
    flow = (rng.rand(2, 16, 16, 2).astype(np.float32) - 0.5) * 0.2
    want = np.asarray(j_warp(jnp.asarray(feat),
                             j_flow_to_grid(jnp.asarray(flow))))
    got = nhwc(warp(nchw(feat), flow_to_grid(t(flow))))
    np.testing.assert_allclose(got, want, atol=1e-5)


SCHEDULES = [dict(steps=3, schedule_name="cosine"),
             dict(steps=1000, schedule_name="linear", respacing="ddim10"),
             dict(steps=100, schedule_name="cosine", respacing="10,5"),
             dict(steps=8, schedule_name="cosine", rescale_timesteps=False)]


@pytest.mark.parametrize("kw", SCHEDULES)
def test_schedule_tables(kw):
    js, ts = j_make_schedule(**kw), make_schedule(**kw)
    assert js.num_timesteps == ts.num_timesteps
    for name in ("betas", "alphas_cumprod", "alphas_cumprod_prev",
                 "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod",
                 "posterior_variance", "posterior_log_variance_clipped",
                 "posterior_mean_coef1", "posterior_mean_coef2",
                 "fixed_large_variance", "fixed_large_log_variance",
                 "model_timesteps"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)), err_msg=name)


@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_ddim_step_and_model_t(eta):
    kw = dict(steps=3, schedule_name="cosine")
    js, ts = j_make_schedule(**kw), make_schedule(**kw)
    rng = np.random.RandomState(4)
    x = rng.randn(3, 4, 4, 2).astype(np.float32)
    x0 = rng.randn(3, 4, 4, 2).astype(np.float32)
    noise = rng.randn(3, 4, 4, 2).astype(np.float32)
    tt = np.array([2, 1, 0])
    want = jG.ddim_step(js, jnp.asarray(x), jnp.asarray(tt), jnp.asarray(x0),
                        eta=eta, noise=jnp.asarray(noise))
    got = G.ddim_step(ts, t(x), torch.from_numpy(tt), t(x0), eta=eta,
                      noise=t(noise))
    np.testing.assert_allclose(got.sample.numpy(), np.asarray(want.sample),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        G.model_t(ts, torch.from_numpy(tt)).numpy(),
        np.asarray(jG.model_t(js, jnp.asarray(tt))))


KERNEL_CASES = {
    "attention": (attention, attention_ref,
                  lambda g: (torch.randn(2, 3, 8, 16, generator=g),
                             torch.randn(2, 3, 12, 16, generator=g),
                             torch.randn(2, 3, 12, 16, generator=g), 0.25)),
    "conv3x3": (conv3x3, conv3x3_ref,
                lambda g: (torch.randn(1, 5, 9, 7, generator=g),
                           torch.randn(4, 5, 3, 3, generator=g),
                           torch.rand(4, generator=g),
                           torch.randn(4, generator=g), 2, True)),
    "gather_bilinear": (gather_bilinear, gather_bilinear_ref,
                        lambda g: (torch.rand(1, 2, 6, 5, generator=g),
                                   torch.rand(1, 3, 4, generator=g) * 7 - 1,
                                   torch.rand(1, 3, 4, generator=g) * 8 - 1)),
    "gather_bilinear_grid": (
        gather_bilinear_grid, gather_bilinear_grid_ref,
        lambda g: (torch.rand(1, 2, 6, 5, generator=g),
                   torch.rand(1, 3, 4, 2, generator=g) * 2.4 - 1.2, "border")),
    "gather_bilinear_grad": (
        gather_bilinear_grad, gather_bilinear_grad_grid_ref,
        lambda g: (torch.rand(1, 2, 6, 5, generator=g),
                   torch.rand(1, 3, 4, 2, generator=g) * 2.4 - 1.2,
                   torch.randn(1, 2, 3, 4, generator=g))),
    "unwarp": (unwarp, unwarp_ref,
               lambda g: ((torch.rand(2, 9, 9, 3, generator=g) * 255)
                          .to(torch.uint8),
                          (torch.rand(2, 4, 4, 2, generator=g) - 0.5) * 0.2,
                          torch.tensor([[9, 7], [5, 9]], dtype=torch.int32))),
    "gather2d": (gather2d, gather2d_ref,
                 lambda g: (torch.rand(6, 5, generator=g),
                            torch.randint(-1, 7, (3, 4), generator=g,
                                          dtype=torch.int32),
                            torch.randint(-1, 6, (3, 4), generator=g,
                                          dtype=torch.int32))),
}


@pytest.mark.parametrize("name", sorted(KERNEL_CASES))
def test_wrapper_takes_twin_for_cpu_tensors(name):
    """On CPU tensors each wrapper returns its plain twin's result and does
    not count a launch; a tensor on any other non-CUDA device is refused."""
    wrapper, twin, make = KERNEL_CASES[name]
    args = make(torch.Generator().manual_seed(0))
    before = wrapper.launches
    torch.testing.assert_close(wrapper(*args), twin(*args), rtol=0, atol=0)
    assert wrapper.launches == before
    meta = tuple(a.to("meta") if torch.is_tensor(a) else a for a in args)
    with pytest.raises(ValueError):
        wrapper(*meta)


def test_conv1x1_f32_is_the_f32_convolution():
    """``conv1x1_f32`` (U2NetP's ``outconv``, the line UNet's ``outc``) as
    an f32 matmul over the channels, the reference's f32 einsum: within
    f32 rounding of the float64 convolution, for f32 and bf16 inputs (the
    result in the input's dtype).  On a card the matmul is what keeps it
    off TF32 (``tests/test_torch_cuda.py``)."""
    g = torch.Generator().manual_seed(1)
    conv = torch.nn.Conv2d(64, 2, 1)
    x = torch.randn(2, 64, 9, 13, generator=g)
    want = torch.nn.functional.conv2d(x.double(), conv.weight.double(),
                                      conv.bias.double())
    got = conv1x1_f32(conv, x)
    assert got.dtype == torch.float32 and got.shape == want.shape
    torch.testing.assert_close(got.double(), want, rtol=0,
                               atol=1e-6 * want.abs().max().item())
    xb = x.bfloat16()
    got = conv1x1_f32(conv, xb)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, torch.nn.functional.conv2d(
        xb.double(), conv.weight.double(), conv.bias.double()).bfloat16(),
        rtol=0, atol=0)


@pytest.mark.parametrize("cin,cout,dil", [(3, 16, 1), (4, 64, 2), (16, 16, 4),
                                          (40, 8, 1), (130, 33, 3)])
def test_k_major_weights_through_im2col(cin, cout, dil):
    """The bf16 kernel's weight operand, fed through a plain im2col matmul
    whose columns run in the kernel's order (Cin chunks, then taps, then
    channels, each chunk padded to a multiple of 16), is the conv:
    ``conv3x3_ref`` on the same bf16 values, in f32."""
    g = torch.Generator().manual_seed(cin)
    x = torch.randn(2, cin, 7, 10, generator=g).bfloat16().float()
    w = torch.randn(cout, cin, 3, 3, generator=g) / (3 * cin ** 0.5)
    s = 1 + 0.1 * torch.randn(cout, generator=g)
    b = 0.1 * torch.randn(cout, generator=g)
    wk = k_major_weights(w)
    cc = chunk_channels(cin)
    nch = -(-cin // cc)
    assert wk.dtype == torch.bfloat16 and wk.shape == (cout, k_major_cols(cin))
    kc = wk.shape[1] // nch
    assert kc % 16 == 0 and kc >= 9 * cc
    xp = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, nch * cc - cin))
    cols = torch.nn.functional.unfold(xp, 3, dilation=dil, padding=dil)
    cols = cols.reshape(2, nch, cc, 9, -1).transpose(2, 3)
    cols = cols.reshape(2, nch, 9 * cc, -1)
    cols = torch.nn.functional.pad(cols, (0, 0, 0, kc - 9 * cc))
    y = torch.matmul(wk.float(), cols.reshape(2, nch * kc, -1))
    y = torch.relu(y.reshape(2, cout, 7, 10) * s[:, None, None]
                   + b[:, None, None])
    want = conv3x3_ref(x, w.bfloat16().float(), s, b, dil, True)
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)


def test_nvcc_command_targets_sm90a(tmp_path):
    """One nvcc per source (the build starts them together), each for
    sm_90a, then one linking the objects into the shared library."""
    objects = [tmp_path / f"{Path(s).stem}.o" for s in build.SOURCES]
    srcs = []
    for source, obj in zip(build.SOURCES, objects):
        cmd = build.compile_command(source, obj, nvcc="/x/nvcc")
        assert cmd[0] == "/x/nvcc"
        assert cmd[1:3] == ["-gencode", "arch=compute_90a,code=sm_90a"]
        for flag in ("-std=c++17", "-O3", "-c", "-fPIC", "-v", str(obj)):
            assert flag in cmd
        srcs += [c for c in cmd if c.endswith(".cu")]
    assert sorted(Path(s).name for s in srcs) == sorted(build.SOURCES)
    assert all(Path(s).is_file() for s in srcs)
    link = build.link_command(tmp_path / "lib.so", objects, nvcc="/x/nvcc")
    assert link[:3] == ["/x/nvcc", "-gencode", "arch=compute_90a,code=sm_90a"]
    assert "-shared" in link and link[-len(objects):] == [str(o) for o in objects]
    assert len(build.source_hash()) == 16


# modules the walk below must reach: the int8, corruption and scoring
# slice among them
PORT_MODULES = ("ops.quant", "data.corruptions", "native",
                "evaluation.metrics", "evaluation.calibrate",
                "evaluation.visualize", "cli.evaluate", "cli.benchmark",
                "cli.run_sampling")


def test_port_imports_no_jax_flax_pil():
    """``import dvd_tpu_torch`` and ``chip_smoke`` (and every module of the
    port) load neither the JAX package ``dvd_tpu`` (not even a
    pure-Python module of it), JAX, flax, msgpack, ml_dtypes, PIL nor cv2
    (the card's machine has no PIL or cv2)."""
    code = (
        "import sys\n"
        "import pkgutil\n"
        "import dvd_tpu_torch, chip_smoke\n"
        "seen = set()\n"
        "for m in pkgutil.walk_packages(dvd_tpu_torch.__path__, "
        "'dvd_tpu_torch.'):\n"
        "    __import__(m.name)\n"
        "    seen.add(m.name)\n"
        f"want = {{'dvd_tpu_torch.' + m for m in {PORT_MODULES!r}}}\n"
        "missing = want - seen\n"
        "assert not missing, missing\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('dvd_tpu', 'jax', 'jaxlib', 'flax', 'msgpack', 'ml_dtypes', "
        "'PIL', 'cv2'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
