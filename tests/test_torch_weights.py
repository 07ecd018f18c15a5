"""Weight files in the port (``training/checkpoint.py``): the inverse
bridge, the EMA snapshots as flax variable files, and serving converted
weights from ``cfg.paths`` -- held against ``dvd_tpu`` on the CPU.

The pipeline test writes the tiny JAX pipeline's variables with
``dvd_tpu``'s own ``save_variables`` at the configured names and serves
them with the port (x_T pinned): the port's flow must be the JAX one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_common  # noqa: F401  (sets torch to 1 thread)
from dvd_tpu.evaluation.pipeline import DewarpPipeline as JPipeline
from dvd_tpu.models.dit import DiT as JDiT
from dvd_tpu.models.geotr import GeoTrSegInf as JGeoTrSegInf
from dvd_tpu.models.textline_unet import TextLineUNet as JTextLineUNet
from dvd_tpu.models.u2net import Seg as JSeg
from dvd_tpu.models.u2net import U2NetP as JU2NetP
from dvd_tpu.models.vgg import VGG16Pyramid as JVGG16Pyramid
from dvd_tpu.ops.resize import resize_bilinear as j_resize
from dvd_tpu.training import checkpoint as jckpt
from dvd_tpu_torch.cli.run_sampling import build_pipeline
from dvd_tpu_torch.config import default_config
from dvd_tpu_torch.models import geotr, layers, textline_unet, u2net, vgg
from dvd_tpu_torch.training import checkpoint as ckpt
from dvd_tpu_torch.training.convert import (load_variables,
                                            state_dict_to_variables,
                                            validate_against)
from dvd_tpu_torch.training.train_state import create_train_state
from test_torch_common import (MINI_DIT, S, SRC, TINY_MODEL, fill_zero_leaves,
                               mask_margin_shift, mini_dit_port,
                               mini_dit_variables, nchw, np_tree,
                               random_variables, t)


def _modules():
    """(port module, its flax counterpart's variable shapes, skip)."""
    z = jnp.zeros
    return {
        "dit": (lambda: mini_dit_port(mini_dit_variables()[1]),
                lambda: mini_dit_variables()[1], ()),
        "seg": (lambda: u2net.Seg(64),
                lambda: random_variables(JSeg(64), z((1, 32, 32, 3))), ()),
        "line": (textline_unet.TextLineUNet,
                 lambda: random_variables(JTextLineUNet(), z((1, 32, 32, 3))),
                 ()),
        "geotr": (lambda: geotr.GeoTrSegInf(64),
                  lambda: random_variables(JGeoTrSegInf(mask_size=64),
                                           z((1, 64, 64, 3))), ("GeoTr",)),
        "geotr_full": (lambda: geotr.GeoTrSegInf(64, full=True,
                                                 image_size=64),
                       lambda: random_variables(JGeoTrSegInf(mask_size=64),
                                                z((1, 64, 64, 3))), ()),
        "vgg": (vgg.VGG16Pyramid,
                lambda: random_variables(JVGG16Pyramid(), z((1, 32, 32, 3))),
                ()),
    }


@pytest.mark.parametrize("name", ["dit", "seg", "line", "geotr", "geotr_full",
                                  "vgg"])
def test_state_dict_to_variables_round_trips(name):
    """state_dict -> variables (the flax tree's structure and shapes) ->
    load_variables into a fresh module: every leaf back bit for bit, in
    f32 and in bf16."""
    make, flax_vars, skip = _modules()[name]
    src = layers.seeded_init_(make(), torch.Generator().manual_seed(9))
    variables = state_dict_to_variables(src.state_dict())
    want = flax_vars()
    # subtrees the port's module does not hold (the mask-only GeoTrSegInf
    # has no GeoTr transformer)
    want["params"] = {k: v for k, v in want["params"].items()
                      if k not in skip}
    for coll in ("params", "batch_stats"):
        assert validate_against(variables, want, coll) == []
    for dtype in (torch.float32, torch.bfloat16):
        dst = make().to(dtype)
        load_variables(dst, state_dict_to_variables(src.to(dtype).state_dict()))
        for (k, a), b in zip(dst.state_dict().items(),
                             src.state_dict().values()):
            assert a.dtype == dtype and torch.equal(a, b), k


def test_ema_snapshot_is_a_dvd_tpu_variable_file(tmp_path):
    """save_ema_snapshots writes ema_{rate}_{step:06d}.msgpack; dvd_tpu's
    load_variables reads it into a tree that its DiT applies to the port
    DiT's output with the EMA weights (the EMA and the BN statistics
    differ from the live model, so both collections count)."""
    jmod, v = mini_dit_variables()
    net = mini_dit_port(v)
    cfg = default_config().replace(
        model=dict(TINY_MODEL, dit_variant="DiT-mini"),
        train={"ema_rate": "0.9999,0.99"})
    state = create_train_state(cfg, net)
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for ema in state.ema_params:
            for p in ema.values():
                p.add_(0.01 * torch.randn(p.shape, generator=g))
        for name, b in net.named_buffers():
            if name.endswith(".mean"):
                b.add_(0.1 * torch.randn(b.shape, generator=g))
    ckpt.save_ema_snapshots(str(tmp_path), cfg, state, 7)
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted([
        "ema_0.99_000007.msgpack", "ema_0.9999_000007.msgpack"])

    rng = np.random.RandomState(5)
    x = rng.randn(2, S, S, 2).astype(np.float32)
    tt = np.array([2.0, 1.0], np.float32)
    cond = dict(y512=rng.rand(2, SRC, SRC, 3), mask_cat=rng.rand(2, SRC, SRC, 1),
                mask_y512=rng.randn(2, S, S, 384), line_msk=rng.randn(2, S, S, 64),
                init_flow=0.1 * rng.randn(2, S, S, 2),
                init_feat=rng.randn(2, S, S, 256))
    cond = {k: v.astype(np.float32) for k, v in cond.items()}
    tree = jckpt.load_variables(str(tmp_path / "ema_0.99_000007.msgpack"))
    assert set(tree) == {"params", "batch_stats"}
    want, _ = jmod.apply(tree, jnp.asarray(x), jnp.asarray(tt),
                         remap_timesteps=True,
                         **{k: jnp.asarray(v) for k, v in cond.items()})
    with torch.no_grad():
        net.load_state_dict({**net.state_dict(), **state.ema_params[1]})
        got, _ = net(t(x), t(tt), init_flow=t(cond["init_flow"]),
                     init_feat=nchw(cond["init_feat"]),
                     y512=nchw(cond["y512"]), mask_cat=nchw(cond["mask_cat"]),
                     mask_y512=nchw(cond["mask_y512"]),
                     line_msk=nchw(cond["line_msk"]), remap_timesteps=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def _tiny_cfg(tmp_path):
    """The tiny serving config with cfg.paths at the reference's file
    names in ``tmp_path`` (.pt / .pth / .npz: the loader looks for the
    .msgpack beside each)."""
    return default_config().replace(
        model=dict(TINY_MODEL, dit_variant="DiT-mini"),
        diffusion={"n_batch": 2},
        paths={"model_path": str(tmp_path / "model1852000.pt"),
               "seg_model_path": str(tmp_path / "seg.pth"),
               "line_seg_model_path": str(tmp_path / "line_model2.npz"),
               "new_seg_model_path": str(tmp_path / "seg_model")})


@pytest.fixture(scope="module")
def jax_weights(tmp_path_factory):
    """dvd_tpu's tiny pipeline: its variables written with dvd_tpu's
    save_variables at the configured names, and its flow with x_T
    pinned."""
    d = tmp_path_factory.mktemp("weights")
    cfg = _tiny_cfg(d)
    jp = JPipeline.create(cfg)
    jp.dit = JDiT(tv=True, chain_blocks=False, **MINI_DIT)
    jp.init_params(jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    src = rng.rand(2, SRC, SRC, 3).astype(np.float32)
    noise = rng.randn(4, S, S, 2).astype(np.float32)
    dit_vars = fill_zero_leaves(np_tree(jp.dit_vars), 11)
    seg_vars = np_tree(jp.seg_vars)
    src64 = j_resize(jnp.asarray(src), (64, 64), align_corners=True)
    d0 = JU2NetP(1).apply({"params": seg_vars["params"]["msk"],
                           "batch_stats": seg_vars["batch_stats"]["msk"]},
                          src64)[0]
    seg_vars["params"]["msk"]["outconv"]["bias"] += mask_margin_shift(
        np.asarray(d0))
    jp.dit_vars, jp.seg_vars = dit_vars, seg_vars
    jp.line_vars, jp.geotr_vars = np_tree(jp.line_vars), np_tree(jp.geotr_vars)
    for name, tree in (("model1852000", jp.dit_vars), ("seg", jp.geotr_vars),
                       ("line_model2", jp.line_vars), ("seg_model", jp.seg_vars)):
        jckpt.save_variables(str(d / f"{name}.msgpack"), tree)
    cond, init_flow, init_feat = jp.build_conditioning(jnp.asarray(src))
    flow = jp.sampling_impl(jp.dit_vars, cond, init_flow, init_feat,
                            jax.random.PRNGKey(5),
                            init_noise=jnp.asarray(noise))
    return cfg, d, src, noise, np.asarray(flow)


def test_served_weights_match_dvd_tpu(jax_weights):
    """build_pipeline + maybe_load_pipeline_weights serves dvd_tpu's
    weight files: 4/4 loaded, and the flow equals dvd_tpu's."""
    cfg, _, src, noise, want = jax_weights
    pipe = build_pipeline(cfg, seed=1, device="cpu")
    loaded = ckpt.maybe_load_pipeline_weights(pipe, cfg)
    assert loaded == {"dit_vars": True, "geotr_vars": True,
                      "line_vars": True, "seg_vars": True}
    assert np.abs(want).max() > 1e-2            # the DiT reached the output
    flow = pipe.dewarp_flow(t(src), init_noise=t(noise))
    np.testing.assert_allclose(flow.numpy(), want, atol=1e-4)


def test_reloaded_weights_change_the_served_result(jax_weights, tmp_path):
    """Loading other weights in place refreshes K2's BN-fold cache: the
    next call serves them, as a fresh pipeline with those weights does.
    A path with no file keeps the weights and reports False."""
    cfg, d, src, noise, _ = jax_weights
    pipe = build_pipeline(cfg, seed=1, device="cpu")
    ckpt.maybe_load_pipeline_weights(pipe, cfg)
    first = pipe.dewarp_flow(t(src), init_noise=t(noise))

    line = ckpt.load_variables(str(d / "line_model2.msgpack"))
    for bn in ("bn_1", "bn_4"):
        line["batch_stats"]["inc"][bn]["mean"] += 0.5
    ckpt.save_variables(str(tmp_path / "line2.msgpack"), line)
    cfg2 = cfg.replace(paths={"line_seg_model_path":
                              str(tmp_path / "line2.msgpack"),
                              "model_path": str(tmp_path / "absent.pt")})
    loaded = ckpt.maybe_load_pipeline_weights(pipe, cfg2)
    assert loaded == {"dit_vars": False, "geotr_vars": True,
                      "line_vars": True, "seg_vars": True}
    second = pipe.dewarp_flow(t(src), init_noise=t(noise))
    assert (second - first).abs().max() > 1e-4

    fresh = build_pipeline(cfg, seed=1, device="cpu")
    ckpt.maybe_load_pipeline_weights(fresh, cfg)
    ckpt.maybe_load_pipeline_weights(fresh, cfg2)
    np.testing.assert_array_equal(
        fresh.dewarp_flow(t(src), init_noise=t(noise)).numpy(),
        second.numpy())
