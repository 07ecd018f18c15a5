"""Serving the alternative denoisers in the port against ``dvd_tpu`` on the
CPU, in ``tests/test_alt_denoisers.py``'s tiny configuration (latent 16,
source 128, perception 64, width 32, one ResBlock a level, 2 heads,
attention at "8,4", f32, ``train_VGG=False``, one hypothesis):
``DewarpPipeline.create`` + ``dewarp_flow`` + ``unwarp_fixed`` for
``stage_1``, ``stage_1_transformer``, ``stage_1_doctr`` and
``stage_1_doctr`` under ``use_init_flow``.

The denoiser's weights reach the port as a converted weight file through
``maybe_load_pipeline_weights``; the VGG16 pyramid's (and GeoTr's) through
the bridge.  x_T is pinned.  Bars: the VGG plane and init_flow within
2e-4 of max|ref| (the aux nets' bar), the flow and the unwarped image
within 1e-4 of max|ref|.  Then the ``run_sampling`` CLI's ``--image`` and
``--eval_dataset`` entries on the UNet family.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_common  # noqa: F401  (sets torch to 1 thread)
from dvd_tpu.config import default_config as j_default_config
from dvd_tpu.evaluation.pipeline import DewarpPipeline as JPipeline
from dvd_tpu.evaluation.pipeline import unwarp_fixed as j_unwarp_fixed
from dvd_tpu.models.vgg import VGG16Pyramid as JVGG16Pyramid
from dvd_tpu_torch.config import default_config
from dvd_tpu_torch.evaluation.pipeline import DewarpPipeline, unwarp_fixed
from dvd_tpu_torch.training.checkpoint import (maybe_load_pipeline_weights,
                                               save_variables)
from test_torch_common import nhwc, port, random_variables, t

S, SRC, PER = 16, 128, 64
ALT = dict(image_size=S, source_size=SRC, perception_size=PER,
           compute_dtype="float32", train_VGG=False, num_channels=32,
           num_res_blocks=1, num_heads=2, attention_resolutions="8,4")
CASES = [("stage_1", {}), ("stage_1_transformer", {}),
         ("stage_1_doctr", {}), ("stage_1_doctr", {"use_init_flow": True})]


def _close(got, want, rel):
    want = np.asarray(want)
    bar = rel * float(np.abs(want).max())
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= bar, f"max err {err:.3e} > {bar:.3e}"


def configs(mode, flags, tmp_path=None):
    o = dict(model=dict(ALT, train_mode=mode, **flags),
             diffusion={"n_batch": 1})
    if tmp_path is not None:
        o["paths"] = {"model_path": str(tmp_path / "model.pt")}
    return j_default_config().replace(**o), default_config().replace(**o)


def pipelines(mode, flags, tmp_path):
    """(JAX pipeline, port pipeline) with the same seeded weights: the
    denoiser's written as ``model.msgpack`` beside ``paths.model_path`` and
    loaded by ``maybe_load_pipeline_weights``."""
    jcfg, cfg = configs(mode, flags, tmp_path)
    jp = JPipeline.create(jcfg)
    z = jnp.zeros
    jp.dit_vars = random_variables(
        jp.dit, z((1, S, S, 2)), z((1,)), src_feat=z((1, S, S, 64)),
        init_flow=z((1, S, S, 2)), seed=11)
    jp.vgg = JVGG16Pyramid()
    jp.vgg_vars = random_variables(jp.vgg, z((1, SRC, SRC, 3)), seed=4)
    pipe = DewarpPipeline.create(cfg, "cpu")
    if cfg.model.use_init_flow:
        jp.geotr_vars = random_variables(jp.geotr, z((1, PER, PER, 3)), seed=3)
        port(pipe.geotr, jp.geotr_vars)
    save_variables(str(tmp_path / "model.msgpack"), jp.dit_vars)
    loaded = maybe_load_pipeline_weights(pipe, cfg)
    assert loaded == {"dit_vars": True, "geotr_vars": False,
                      "line_vars": False, "seg_vars": False}
    port(pipe.vgg, jp.vgg_vars)
    return jp, pipe


@pytest.mark.parametrize("mode,flags", CASES, ids=lambda c: str(c))
def test_alt_serving_matches_dvd_tpu(mode, flags, tmp_path):
    rng = np.random.RandomState(0)
    src = rng.rand(2, SRC, SRC, 3).astype(np.float32)
    noise = rng.randn(2, S, S, 2).astype(np.float32)
    jp, pipe = pipelines(mode, flags, tmp_path)
    assert not pipe.is_dit and not jp.is_dit
    cond, init_flow, init_feat = jax.jit(jp.conditioning_impl)(
        (jp.seg_vars, jp.line_vars, jp.geotr_vars, jp.vgg_vars),
        jnp.asarray(src))
    want = np.asarray(jp.sampling_impl(jp.dit_vars, cond, init_flow,
                                       init_feat, jax.random.PRNGKey(5),
                                       init_noise=jnp.asarray(noise)))
    with torch.no_grad():
        pcond, pflow0, pfeat = pipe.build_conditioning(t(src))
    assert set(pcond) == set(cond) == {"src_feat"}
    _close(nhwc(pcond["src_feat"]), cond["src_feat"], 2e-4)
    assert pfeat.shape == (2, 256, S, S) and pfeat.abs().max() == 0
    if flags.get("use_init_flow"):
        assert np.abs(np.asarray(init_flow)).max() > 1e-2
        _close(pflow0.numpy(), init_flow, 2e-4)
    else:
        assert pflow0.abs().max() == 0
    got = pipe.dewarp_flow(t(src), init_noise=t(noise)).numpy()
    assert got.shape == (2, S, S, 2)
    assert np.abs(want).max() > 1e-2
    _close(got, want, 1e-4)
    page = rng.rand(2, 45, 60, 3).astype(np.float32)
    img = unwarp_fixed(t(page), t(got)).numpy()
    _close(img, j_unwarp_fixed(jnp.asarray(page), jnp.asarray(want)), 1e-4)


def test_alt_cli_entries(tmp_path, monkeypatch):
    """``run_sampling --image`` and ``--eval_dataset`` serve the UNet family
    through ``--set model.train_mode=stage_1 --set model.train_VGG=False``
    (no new option), each writing a finite flow in [-1, 1]."""
    from PIL import Image

    from dvd_tpu_torch.cli import run_sampling

    monkeypatch.chdir(tmp_path)
    sets = ["--set", "model.train_mode=stage_1",
            "--set", "model.train_VGG=False", "--set", "model.image_size=16",
            "--set", "model.source_size=128",
            "--set", "model.perception_size=64",
            "--set", "model.num_channels=32",
            "--set", "model.num_res_blocks=1", "--set", "model.num_heads=2",
            "--set", "model.attention_resolutions='8,4'",
            "--set", "model.compute_dtype='float32'",
            "--set", f"paths.model_path='{tmp_path}/none.pt'",
            "--device", "cpu"]
    rng = np.random.RandomState(2)
    (tmp_path / "pages").mkdir()
    for i, (h, w) in enumerate(((45, 60), (70, 50))):
        Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(
            tmp_path / "pages" / f"p{i}.png")
    out = tmp_path / "out.png"
    run_sampling.main(["--image", str(tmp_path / "pages" / "p0.png"),
                       "--out", str(out)] + sets)
    flow = np.load(str(out) + ".coords.npy")
    assert np.asarray(Image.open(out)).shape == (45, 60, 3)
    assert flow.shape == (S, S, 2) and np.isfinite(flow).all()
    assert np.abs(flow).max() <= 1 and np.abs(flow).max() > 1e-3
    run_sampling.main(["--eval_dataset", str(tmp_path / "pages"),
                       "--eval_dataset_name", "tiny", "--name", "alt",
                       "--batch", "2"] + sets)
    out = tmp_path / "vis_hp" / "tiny" / "alt" / "dewarped_pred"
    assert sorted(p.name for p in out.glob("*.png")) == [
        "warped_p0.png", "warped_p1.png"]
