"""The port's model registry (``dvd_tpu_torch/models/registry.py``), its
refusals and the alternative denoisers' converter rule sets against
``dvd_tpu``'s, on the CPU.

- every ``train_mode`` builds, and each alternative family's module takes
  the flax variables of ``dvd_tpu``'s ``create_model`` for the same config
  through the weight bridge, every key used;
- ``attention_ds``, ``unet_channel_mult``, ``DRIVER_MODES``;
- ``sr`` and ``trg_feat`` refused by serving and training
  (``NotImplementedError`` naming the drivable modes), an alternative
  denoiser with ``train_VGG=True`` refused (``ValueError``);
- ``quantize="int8"`` ignored by the alternative families, as ``dvd_tpu``
  ignores it: the flow equals the one served under ``"none"``;
- ``unet_rules`` + ``preprocess_unet_attention`` and
  ``TRANSFORMER_RULES`` turn a random upstream-layout state_dict (the
  reference's ``UNetModel_stage1`` and ``DDIMWithTransformer`` key names,
  regenerated here: the reference modules are not importable) into the
  same tree as ``dvd_tpu``'s converter, leaf for leaf.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_common  # noqa: F401  (sets torch to 1 thread)
from dvd_tpu.config import default_config as j_default_config
from dvd_tpu.models import registry as jreg
from dvd_tpu.training import convert as J
from dvd_tpu_torch.config import default_config
from dvd_tpu_torch.evaluation.pipeline import DewarpPipeline
from dvd_tpu_torch.models import registry
from dvd_tpu_torch.models.dit import DiT
from dvd_tpu_torch.training import convert as C
from dvd_tpu_torch.training.convert import load_variables
from dvd_tpu_torch.training.train_state import make_train_step
from test_torch_common import random_variables, t

S = 16
ALT = dict(image_size=S, source_size=128, perception_size=64,
           compute_dtype="float32", train_VGG=False, num_channels=32,
           num_res_blocks=1, num_heads=2, attention_resolutions="8,4")
MODES = ("stage_1_dit_cross", "stage_1_dit_cat", "stage_1", "sr",
         "trg_feat", "stage_1_transformer", "stage_1_doctr")


def _cfgs(mode, **over):
    o = dict(model=dict(ALT, train_mode=mode, **over),
             diffusion={"n_batch": 1})
    return j_default_config().replace(**o), default_config().replace(**o)


@pytest.mark.parametrize("mode", MODES)
def test_every_mode_builds(mode):
    jcfg, cfg = _cfgs(mode)
    model, sched = registry.create_model_and_diffusion(cfg, "cpu")
    assert sched.num_timesteps == 3
    assert registry.is_dit_mode(mode) == isinstance(model, DiT) \
        == jreg.is_dit_mode(mode)
    if registry.is_dit_mode(mode):
        return
    # the flax variables of dvd_tpu's model load into the port's
    z = jnp.zeros
    extra = {"sr": dict(local_corr=z((1, S, S, 81))),
             "trg_feat": dict(local_corr=z((1, S, S, 81)),
                              trg_feat=z((1, S, S, 64)))}.get(
        mode, dict(src_feat=z((1, S, S, 64))))
    v = random_variables(jreg.create_model(jcfg), z((1, S, S, 2)), z((1,)),
                         init_flow=z((1, S, S, 2)), **extra)
    report = load_variables(model, v)
    assert not report.skipped


def test_registry_helpers_match_dvd_tpu():
    assert registry.DRIVER_MODES == jreg.DRIVER_MODES
    assert registry.DIT_MODES == jreg.DIT_MODES
    for size, res in ((64, "16,8"), (16, "8,4"), (32, "16"), (256, "32,16,8")):
        assert registry.attention_ds(size, res) == jreg.attention_ds(size, res)
    assert registry.attention_ds(64, "16,8") == (4, 8)
    for size in (8, 16, 32, 64, 256):
        assert registry.unet_channel_mult(size) == jreg.unet_channel_mult(size)
    for bad in (128, 512):
        for mod in (registry, jreg):
            with pytest.raises(ValueError):
                mod.unet_channel_mult(bad)
    for mode in MODES:
        assert registry.is_dit_mode(mode) == jreg.is_dit_mode(mode)


@pytest.mark.parametrize("mode", ["sr", "trg_feat"])
def test_undrivable_modes_refused(mode):
    _, cfg = _cfgs(mode)
    with pytest.raises(NotImplementedError, match="Drivable modes"):
        DewarpPipeline.create(cfg, "cpu")
    with pytest.raises(NotImplementedError, match="Drivable modes"):
        make_train_step(cfg,
                        registry.create_model_and_diffusion(cfg, "cpu")[1])


@pytest.mark.parametrize("mode", ["stage_1", "stage_1_transformer",
                                  "stage_1_doctr"])
def test_alt_mode_with_train_vgg_refused(mode):
    _, cfg = _cfgs(mode, train_VGG=True)
    with pytest.raises(ValueError, match="train_VGG=False"):
        DewarpPipeline.create(cfg, "cpu")


@pytest.mark.parametrize("mode", ["stage_1", "stage_1_transformer",
                                  "stage_1_doctr"])
def test_int8_ignored_by_alt_modes(mode):
    """``create_model`` passes ``quant`` to the DiT alone in both packages:
    under ``quantize="int8"`` the family serves the same flow, with no
    quantized layer."""
    rng = np.random.RandomState(0)
    src = t(rng.rand(1, 128, 128, 3))
    noise = t(rng.randn(1, S, S, 2))
    flows = []
    for quantize in ("none", "int8"):
        _, cfg = _cfgs(mode, quantize=quantize)
        pipe = DewarpPipeline.create(
            cfg, "cpu", generator=torch.Generator().manual_seed(3))
        assert not pipe.is_dit and not hasattr(pipe.dit, "int8_layers")
        flows.append(pipe.dewarp_flow(src, init_noise=noise))
    assert flows[0].abs().max() > 1e-3
    torch.testing.assert_close(flows[1], flows[0], rtol=0, atol=0)


# ------------------------------------------------------------ converter
def _upstream_unet(rng, mc, channel_mult, nrb, attention_ds, heads,
                   in_ch=68, out_ch=2):
    """A random state_dict in the layout of the reference's
    ``UNetModel_stage1`` (``unet.py:552-853``): flat ``input_blocks`` /
    ``output_blocks`` lists, ResBlocks' ``in_layers``/``emb_layers``/
    ``out_layers`` Sequentials, conv1d qkv/proj_out attention."""
    sd = {}
    r = lambda *s: rng.randn(*s).astype(np.float32)

    def lin(name, o, i):
        sd[name + ".weight"], sd[name + ".bias"] = r(o, i), r(o)

    def conv(name, o, i, k=3):
        sd[name + ".weight"], sd[name + ".bias"] = r(o, i, k, k), r(o)

    def norm(name, c):
        sd[name + ".weight"], sd[name + ".bias"] = 1 + r(c), r(c)

    def res(p, cin, cout):
        norm(p + "in_layers.0", cin)
        conv(p + "in_layers.2", cout, cin)
        lin(p + "emb_layers.1", 2 * cout, 4 * mc)
        norm(p + "out_layers.0", cout)
        conv(p + "out_layers.3", cout, cout)
        if cin != cout:
            conv(p + "skip_connection", cout, cin, 1)

    def attn(p, c):
        norm(p + "norm", c)
        sd[p + "qkv.weight"], sd[p + "qkv.bias"] = r(3 * c, c, 1), r(3 * c)
        sd[p + "proj_out.weight"], sd[p + "proj_out.bias"] = r(c, c, 1), r(c)

    lin("time_embed.0", 4 * mc, mc)
    lin("time_embed.2", 4 * mc, 4 * mc)
    conv("input_blocks.0.0", mc, in_ch)
    chans, ch, ds, idx = [mc], mc, 1, 1
    for level, mult in enumerate(channel_mult):
        for _ in range(nrb):
            res(f"input_blocks.{idx}.0.", ch, mult * mc)
            ch = mult * mc
            if ds in attention_ds:
                attn(f"input_blocks.{idx}.1.", ch)
            chans.append(ch)
            idx += 1
        if level != len(channel_mult) - 1:
            conv(f"input_blocks.{idx}.0.op", ch, ch)
            chans.append(ch)
            idx += 1
            ds *= 2
    res("middle_block.0.", ch, ch)
    attn("middle_block.1.", ch)
    res("middle_block.2.", ch, ch)
    j = 0
    for level, mult in reversed(list(enumerate(channel_mult))):
        for i in range(nrb + 1):
            res(f"output_blocks.{j}.0.", ch + chans.pop(), mult * mc)
            ch, li = mult * mc, 1
            if ds in attention_ds:
                attn(f"output_blocks.{j}.1.", ch)
                li = 2
            if level and i == nrb:
                conv(f"output_blocks.{j}.{li}.conv", ch, ch)
                ds //= 2
            j += 1
    norm("out.0", ch)
    conv("out.2", out_ch, ch)
    return sd


def _upstream_transformer(rng, mc, heads, layers, ff, in_ch=68, out_ch=2):
    """A random state_dict in the layout of the reference's
    ``DDIMWithTransformer`` (``transformer.py:57-137``): packed
    ``nn.MultiheadAttention`` projections, ``ffn`` Sequentials."""
    sd = {}
    r = lambda *s: rng.randn(*s).astype(np.float32)
    for name, shape in (("time_embed.0", (4 * mc, mc)),
                        ("time_embed.2", (mc, 4 * mc)),
                        ("x_projection", (mc, in_ch, 3, 3))):
        sd[name + ".weight"], sd[name + ".bias"] = r(*shape), r(shape[0])
    blocks = [f"input_blocks.{i}." for i in range(layers)] + \
        ["middle_block."] + [f"output_blocks.{i}." for i in range(layers)]
    for p in blocks:
        sd[p + "attn.in_proj_weight"] = r(3 * mc, mc)
        sd[p + "attn.in_proj_bias"] = r(3 * mc)
        sd[p + "attn.out_proj.weight"] = r(mc, mc)
        sd[p + "attn.out_proj.bias"] = r(mc)
        for n in ("norm1", "norm2"):
            sd[p + n + ".weight"], sd[p + n + ".bias"] = 1 + r(mc), r(mc)
        sd[p + "ffn.0.weight"], sd[p + "ffn.0.bias"] = r(ff, mc), r(ff)
        sd[p + "ffn.2.weight"], sd[p + "ffn.2.bias"] = r(mc, ff), r(mc)
    sd["out.1.weight"], sd["out.1.bias"] = r(out_ch, mc, 3, 3), r(out_ch)
    return sd


def _same_tree(got, want):
    fg, fw = C.flatten_tree(got), C.flatten_tree(want)
    assert set(fg) == set(fw), sorted(set(fg) ^ set(fw))[:8]
    for k in fw:
        np.testing.assert_array_equal(np.asarray(fg[k]), np.asarray(fw[k]),
                                      err_msg=k)


@pytest.mark.parametrize("config", [
    # (channel_mult, num_res_blocks, attention_ds, heads): the tiny
    # config's, and the registry's production one at width 32
    ((1, 2, 2, 2), 1, (2, 4), 2), ((1, 2, 3, 4), 3, (4, 8), 4)])
def test_unet_rules_match_dvd_tpu(config):
    mult, nrb, ads, heads = config
    sd = _upstream_unet(np.random.RandomState(0), 32, mult, nrb, ads, heads)
    assert np.array_equal(C.unet_qkv_perm(96, heads),
                          J.unet_qkv_perm(96, heads))
    pre = C.preprocess_unet_attention(sd, heads)
    jpre = J.preprocess_unet_attention(sd, heads)
    assert set(pre) == set(jpre)
    for k in pre:
        np.testing.assert_array_equal(pre[k], jpre[k], err_msg=k)
    assert C.unet_rules(mult, nrb, ads) == J.unet_rules(mult, nrb, ads)
    got = C.convert_state_dict(pre, C.unet_rules(mult, nrb, ads))
    _same_tree(got, J.convert_state_dict(jpre, J.unet_rules(mult, nrb, ads)))
    from dvd_tpu_torch.models.unet_denoiser import UNetDenoiser

    report = load_variables(UNetDenoiser(68, 32, 2, nrb, ads, mult, heads),
                            got)
    assert not report.skipped


def test_transformer_rules_match_dvd_tpu():
    sd = _upstream_transformer(np.random.RandomState(1), 32, 2, 2, 64)
    assert C.TRANSFORMER_RULES == J.TRANSFORMER_RULES
    got = C.convert_state_dict(sd, C.TRANSFORMER_RULES)
    _same_tree(got, J.convert_state_dict(sd, J.TRANSFORMER_RULES))
    from dvd_tpu_torch.models.transformer_denoiser import TransformerDenoiser

    load_variables(TransformerDenoiser(model_channels=32, num_heads=2,
                                       num_layers=2, ff_dim=64), got)
