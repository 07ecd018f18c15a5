"""The production DiT's conditioning configurations in the port against
``dvd_tpu``, in ``tests/test_conditioning_flags.py``'s tiny pipeline
(latent 16, source 128, perception 64, DiT-mini, f32, one hypothesis):
``use_gt_mask``, ``use_line_mask=False``, ``train_VGG=False`` (the VGG16
features in place of the DiT's pyramid), ``use_init_flow`` (the full
GeoTr seeding the residual stream) and the 'seq' and 'one' cross-attention
modes.

Serving: the same seeded weights on both sides (every aux net and the
DiT), x_T pinned; the flow within the DiT's 1e-3, the conditioning that
the flag adds within the aux nets' 2e-4 of max|ref|.  Training
(``tests/test_torch_flags_train.py``): one step per flag.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_common  # noqa: F401  (sets torch to 1 thread)
from dvd_tpu.config import default_config as j_default_config
from dvd_tpu.evaluation.pipeline import DewarpPipeline as JPipeline
from dvd_tpu.models.u2net import U2NetP as JU2NetP
from dvd_tpu.models.vgg import VGG16Pyramid as JVGG16Pyramid
from dvd_tpu.ops.resize import resize_bilinear as j_resize
from dvd_tpu_torch.config import default_config
from dvd_tpu_torch.evaluation.pipeline import DewarpPipeline
from test_torch_common import (mask_margin_shift, nhwc, port,
                               random_variables, t)

S, SRC, PER = 16, 128, 64

# each flag alone, and use_init_flow with the VGG conditioning together
FLAGS = [{"use_gt_mask": True}, {"use_line_mask": False},
         {"train_VGG": False}, {"use_init_flow": True},
         {"separate_cross_attn": "seq"}, {"separate_cross_attn": "one"},
         {"use_init_flow": True, "train_VGG": False}]


def configs(flags, **over):
    """(dvd_tpu config, port config) of the tiny pipeline with ``flags``."""
    o = dict(model=dict(image_size=S, source_size=SRC, perception_size=PER,
                        compute_dtype="float32", dit_variant="DiT-mini",
                        **flags),
             diffusion={"n_batch": 1}, **over)
    return j_default_config().replace(**o), default_config().replace(**o)


def pipelines(flags, sources, for_training=False, **over):
    """(JAX pipeline, port pipeline) with the same seeded random weights
    (``random_variables``: no JAX init is compiled; the DiT's zero-init
    layers drawn small, so the blocks reach the output), Seg's ``outconv``
    bias shifted so the soft mask of each image in ``sources`` stays clear
    of the hard 0.5 threshold."""
    jcfg, cfg = configs(flags, **over)
    m = jcfg.model
    jp = JPipeline.create(jcfg)
    z = jnp.zeros
    img = z((1, PER, PER, 3))
    jp.dit_vars = random_variables(
        jp.dit, z((1, S, S, 2)), z((1,)), y512=z((1, SRC, SRC, 3)),
        mask_cat=z((1, SRC, SRC, 1)),
        mask_y512=None if m.use_gt_mask else z((1, S, S, 384)),
        line_msk=z((1, S, S, 64)) if m.use_line_mask and not m.use_gt_mask
        else None,
        src_feat=None if m.train_VGG else z((1, S, S, 256)),
        init_flow=z((1, S, S, 2)), init_feat=z((1, S, S, 256)),
        remap_timesteps=False, seed=11)
    seg_vars = random_variables(jp.seg, img, seed=1)
    jp.line_vars = random_variables(jp.line, img, seed=2)
    jp.geotr_vars = random_variables(jp.geotr, img, seed=3)
    msk = {"params": seg_vars["params"]["msk"],
           "batch_stats": seg_vars["batch_stats"]["msk"]}
    d0 = np.concatenate([np.asarray(JU2NetP(1).apply(msk, j_resize(
        jnp.asarray(src), (PER, PER), align_corners=True))[0])
        for src in sources])
    seg_vars["params"]["msk"]["outconv"]["bias"] += mask_margin_shift(d0)
    jp.seg_vars = seg_vars
    if not m.train_VGG:
        jp.vgg = JVGG16Pyramid()
        jp.vgg_vars = random_variables(jp.vgg, z((1, SRC, SRC, 3)), seed=4)
    pipe = DewarpPipeline.create(cfg, "cpu", train=for_training)
    port(pipe.dit, jp.dit_vars)
    port(pipe.seg, jp.seg_vars)
    port(pipe.line, jp.line_vars)
    port(pipe.geotr, jp.geotr_vars)
    if jp.vgg_vars is not None:
        port(pipe.vgg, jp.vgg_vars)
    assert (pipe.vgg is None) == (jp.vgg_vars is None)
    return jp, pipe


def _close(got, want, rel):
    bar = rel * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= bar, f"max err {err:.3e} > {bar:.3e}"


@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: ",".join(
    f"{k}={v}" for k, v in f.items()))
def test_flag_serving_matches_dvd_tpu(flags):
    rng = np.random.RandomState(0)
    src = rng.rand(2, SRC, SRC, 3).astype(np.float32)
    noise = rng.randn(2, S, S, 2).astype(np.float32)
    jp, pipe = pipelines(flags, [src])
    cond, init_flow, init_feat = jax.jit(jp.conditioning_impl)(
        (jp.seg_vars, jp.line_vars, jp.geotr_vars, jp.vgg_vars),
        jnp.asarray(src))
    want = np.asarray(jp.sampling_impl(jp.dit_vars, cond, init_flow,
                                       init_feat, jax.random.PRNGKey(5),
                                       init_noise=jnp.asarray(noise)))
    with torch.no_grad():
        pcond, pflow0, _ = pipe.build_conditioning(t(src))
    assert set(pcond) == set(cond), (set(pcond), set(cond))
    if "src_feat" in cond:          # train_VGG=False: the VGG level 3
        _close(nhwc(pcond["src_feat"]), np.asarray(cond["src_feat"]), 2e-4)
    if flags.get("use_init_flow"):  # GeoTr's map, resized, as init_flow
        want0 = np.asarray(init_flow)
        assert np.abs(want0).max() > 1e-2
        _close(pflow0.numpy(), want0, 2e-4)
    else:
        assert pflow0.abs().max() == 0
    got = pipe.dewarp_flow(t(src), init_noise=t(noise)).numpy()
    assert got.shape == (2, S, S, 2)
    # the DiT reached the output, and not every value sits at the clamp
    assert np.abs(want - np.asarray(init_flow)).max() > 1e-2
    assert (np.abs(want) < 1).mean() > 0.5
    np.testing.assert_allclose(got, want, atol=1e-3)


@pytest.mark.parametrize("flags", FLAGS[-3:], ids=lambda f: ",".join(
    f"{k}={v}" for k, v in f.items()))
def test_flag_entry_points(flags, tmp_path):
    """The single-image CLI function and the batched driver
    ``run_benchmark`` serve the configuration: their flows are the
    pipeline's own (which the test above holds to ``dvd_tpu``)."""
    from PIL import Image

    from dvd_tpu_torch.cli.run_sampling import build_pipeline, dewarp_image
    from dvd_tpu_torch.data.benchmark import BenchmarkDataset
    from dvd_tpu_torch.evaluation.driver import run_benchmark

    _, cfg = configs(flags)
    pipe = build_pipeline(cfg, seed=0, device="cpu")
    assert (pipe.vgg is not None) == (not cfg.model.train_VGG)
    assert (pipe.geotr.GeoTr is not None) == cfg.model.use_init_flow
    rng = np.random.RandomState(4)
    page = (rng.rand(45, 60, 3) * 255).astype(np.uint8)
    out, flow = dewarp_image(pipe, page, seed=0)
    again, _ = dewarp_image(pipe, page, seed=0)
    assert out.shape == (45, 60, 3) and flow.shape == (S, S, 2)
    assert np.isfinite(out).all() and np.abs(flow).max() <= 1.0
    np.testing.assert_array_equal(out, again)

    (tmp_path / "pages").mkdir()
    for i, (h, w) in enumerate(((90, 120), (106, 140))):
        Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(
            tmp_path / "pages" / f"p{i}.png")
    ds = BenchmarkDataset.from_dir(str(tmp_path / "pages"), source_size=SRC)
    noise = t(rng.randn(2, S, S, 2).astype(np.float32))
    sampling = pipe.sampling_impl
    pipe.sampling_impl = lambda cond, f, feat, gen=None: sampling(
        cond, f, feat, init_noise=noise)
    stats = run_benchmark(pipe, ds, str(tmp_path / "out"), batch_size=2,
                          save_coord_maps=True)
    assert stats["images"] == 2
    with torch.no_grad():
        want = sampling(*pipe.build_conditioning(t(np.stack(
            [ds[i]["source_image"] for i in range(2)]))),
            init_noise=noise).numpy()
    for i in range(2):
        got = np.load(tmp_path / "out" / "dewarped_pred" / f"coord_p{i}.png.npy")
        np.testing.assert_allclose(got, want[i], atol=1e-6)
