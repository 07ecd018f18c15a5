"""The whole serving slice of ``dvd_tpu_torch`` against ``dvd_tpu``'s
``DewarpPipeline`` in the ``test_pipeline_e2e.py`` tiny configuration
(latent 16, source 128, perception 64, a DiT 48 wide and 2 deep), f32 on
the CPU: same weights through the bridge (DiT zero leaves filled), x_T
pinned, and the U2NetP soft mask held at least 0.05 away from the hard
0.5 threshold so no pixel can flip between frameworks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvd_tpu.config import default_config
from dvd_tpu.evaluation.pipeline import DewarpPipeline as JPipeline
from dvd_tpu.evaluation.pipeline import unwarp_fixed as j_unwarp_fixed
from dvd_tpu.models.dit import DiT as JDiT
from dvd_tpu.models.u2net import U2NetP as JU2NetP
from dvd_tpu.ops.resize import resize_bilinear as j_resize
from dvd_tpu_torch.cli.run_sampling import (build_pipeline, dewarp_image,
                                            resize_like_pil)
from dvd_tpu_torch.evaluation.pipeline import DewarpPipeline, unwarp_fixed
from dvd_tpu_torch.models.dit import DiT
from dvd_tpu_torch.training.convert import load_variables
from test_torch_common import (fill_zero_leaves, mask_margin_shift, nchw,
                               nhwc, np_tree, port, t)

MINI = dict(input_size=16, patch_size=2, hidden_size=48, depth=2,
            num_heads=3)
TINY = dict(image_size=16, source_size=128, perception_size=64,
            compute_dtype="float32")


def tiny_config():
    return default_config().replace(model=TINY, diffusion={"n_batch": 2})


@pytest.fixture(scope="module")
def pair():
    """(JAX pipeline, port pipeline, source, pinned x_T, JAX results)."""
    cfg = tiny_config()
    jp = JPipeline.create(cfg)
    jp.dit = JDiT(tv=True, chain_blocks=False, **MINI)
    jp.init_params(jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    src = rng.rand(2, 128, 128, 3).astype(np.float32)
    noise = rng.randn(4, 16, 16, 2).astype(np.float32)

    dit_vars = fill_zero_leaves(np_tree(jp.dit_vars), 11)
    seg_vars, line_vars, geotr_vars = (np_tree(v) for v in (
        jp.seg_vars, jp.line_vars, jp.geotr_vars))
    src64 = j_resize(jnp.asarray(src), (64, 64), align_corners=True)
    d0 = JU2NetP(1).apply({"params": seg_vars["params"]["msk"],
                           "batch_stats": seg_vars["batch_stats"]["msk"]},
                          src64)[0]
    seg_vars["params"]["msk"]["outconv"]["bias"] += mask_margin_shift(
        np.asarray(d0))
    jp.dit_vars, jp.seg_vars = dit_vars, seg_vars
    jp.line_vars, jp.geotr_vars = line_vars, geotr_vars

    cond, init_flow, init_feat = jp.build_conditioning(jnp.asarray(src))
    flow = jp.sampling_impl(dit_vars, cond, init_flow, init_feat,
                            jax.random.PRNGKey(5),
                            init_noise=jnp.asarray(noise))
    want = dict(cond={k: np.asarray(v) for k, v in cond.items()},
                flow=np.asarray(flow),
                image=np.asarray(j_unwarp_fixed(jnp.asarray(src), flow)))

    pipe = DewarpPipeline.create(cfg, "cpu", dit=DiT(**MINI))
    port(pipe.dit, dit_vars)
    port(pipe.seg, seg_vars)
    port(pipe.line, line_vars)
    load_variables(pipe.geotr, geotr_vars)
    return pipe, src, noise, want


def test_conditioning_matches(pair):
    pipe, src, _, want = pair
    with torch.no_grad():
        cond, init_flow, init_feat = pipe.build_conditioning(t(src))
        d0 = pipe.seg.msk(nchw(j_resize(jnp.asarray(src), (64, 64),
                                        align_corners=True)))[0]
    assert (d0 - 0.5).abs().min().item() > 0.05      # the mask margin
    np.testing.assert_allclose(nhwc(cond["mask_cat"]),
                               want["cond"]["mask_cat"], atol=2e-4)
    np.testing.assert_allclose(nhwc(cond["mask_y512"]),
                               want["cond"]["mask_y512"], atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(nhwc(cond["line_msk"]),
                               want["cond"]["line_msk"], atol=2e-4, rtol=1e-4)
    assert init_flow.abs().max() == 0 and init_feat.shape == (2, 256, 16, 16)


def test_slice_matches_dvd_tpu(pair):
    """dewarp_flow + unwarp_fixed against DewarpPipeline at f32."""
    pipe, src, noise, want = pair
    flow = pipe.dewarp_flow(t(src), init_noise=t(noise))
    assert flow.shape == (2, 16, 16, 2)
    assert np.abs(want["flow"]).max() > 1e-2   # the DiT reached the output
    np.testing.assert_allclose(flow.numpy(), want["flow"], atol=1e-4)
    out = unwarp_fixed(t(src), flow)
    np.testing.assert_allclose(out.numpy(), want["image"], atol=1e-4)


def test_hoisted_sampling_matches_inline(pair):
    """The pyramid and c/m/l token hoists equal the DiT's in-model path
    (raw y512/mask_cat/mask_y512/line_msk inside every denoiser call)."""
    from dvd_tpu_torch.diffusion.sampler import ddim_sample_loop

    pipe, src, noise, _ = pair
    with torch.no_grad():
        cond, init_flow, init_feat = pipe.build_conditioning(t(src))
        hoisted = pipe.sampling_impl(cond, init_flow, init_feat,
                                     init_noise=t(noise))
        inline = ddim_sample_loop(
            lambda x, tt, c, **kw: pipe.dit(x, tt, **c, **kw), pipe.sched,
            cond, init_flow, init_feat, latent_size=16, n_batch=2,
            init_noise=t(noise)).flow
    np.testing.assert_allclose(hoisted.numpy(), inline.numpy(), atol=1e-5)


def test_unwarp_fixed_any_size():
    """An unwarp at a size the TPU kernel's gate rejects (W % 128 != 0)."""
    rng = np.random.RandomState(1)
    src = rng.rand(1, 45, 60, 3).astype(np.float32)
    flow = ((rng.rand(1, 16, 16, 2) - 0.5) * 0.2).astype(np.float32)
    want = np.asarray(j_unwarp_fixed(jnp.asarray(src), jnp.asarray(flow)))
    got = unwarp_fixed(t(src), t(flow)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("override", [
    {"model": {"serve_cond_chunk": 2}},
    {"model": {"train_mode": "stage_1_doctr"}},
    {"model": {"compute_dtype": "float16"}},
    {"model": {"train_mode": "stage_1"}},
    {"model": {"train_mode": "stage_1_transformer"}}])
def test_unported_flags_raise(override):
    with pytest.raises(NotImplementedError):
        DewarpPipeline.create(tiny_config().replace(**override))


def test_resize_like_pil():
    """The CLI's 512^2 source matches PIL's BILINEAR resize of the uint8
    photo (which run_sampling.py uses) to within one grey level."""
    from PIL import Image

    img = (np.random.RandomState(2).rand(45, 60, 3) * 255).astype(np.uint8)
    want = np.asarray(Image.fromarray(img).resize((32, 32), Image.BILINEAR),
                      np.float32)
    got = resize_like_pil(t(img.astype(np.float32)), 32).numpy()
    assert np.abs(got - want).max() <= 1.0


def test_cli_dewarp_image():
    """The CLI's array function on a non-square page, tiny config, CPU."""
    cfg = tiny_config().replace(model={"dit_variant": "DiT-mini"})
    pipe = build_pipeline(cfg, seed=0, device="cpu")
    page = (np.random.RandomState(3).rand(45, 60, 3) * 255).astype(np.uint8)
    out, flow = dewarp_image(pipe, page, seed=0)
    assert out.shape == (45, 60, 3) and flow.shape == (16, 16, 2)
    assert np.isfinite(out).all() and np.abs(flow).max() <= 1.0
    again, _ = dewarp_image(pipe, page, seed=0)
    np.testing.assert_array_equal(out, again)
