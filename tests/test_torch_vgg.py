"""The port's VGG16 feature pyramid (``dvd_tpu_torch/models/vgg.py``)
against ``dvd_tpu/models/vgg.py`` on the CPU in f32, at a 64^2 source:
every mode, ``sixteen`` refused by both, and the DiT's and the UNet's c20
helpers, each within 2e-4 of max|ref| (the aux nets' bar).  The weights
come from a torchvision ``vgg16`` state_dict through the port's
``VGG16_RULES``, as ``cli/convert_ckpt.py --kind vgg`` converts them; the
CLI's ``--validate`` round trip is checked too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_common  # noqa: F401  (sets torch to 1 thread)
from dvd_tpu.models import vgg as jvgg
from dvd_tpu_torch.cli import convert_ckpt as cli
from dvd_tpu_torch.models import layers, vgg
from dvd_tpu_torch.training import checkpoint as ckpt
from dvd_tpu_torch.training import convert as C
from test_torch_common import nchw, nhwc, np_tree, port

# torchvision vgg16.features index of each port conv
FEATURES = {"level_0_conv0": 0, "level_1_conv0": 2, "level_2_conv0": 5,
            "level_2_conv1": 7, "level_3_conv0": 10, "level_3_conv1": 12,
            "level_3_conv2": 14}


def torchvision_state_dict(seed: int = 0) -> dict:
    """A seeded port pyramid's weights in torchvision ``vgg16``'s layout,
    with the levels past /8 and the classifier the rules drop."""
    src = layers.seeded_init_(vgg.VGG16Pyramid(),
                              torch.Generator().manual_seed(seed))
    sd = {}
    for k, v in src.state_dict().items():
        name, leaf = k.split(".")
        sd[f"features.{FEATURES[name]}.{leaf}"] = v
    rng = np.random.RandomState(seed)
    for i in (17, 19, 21, 24, 26, 28):
        sd[f"features.{i}.weight"] = torch.randn(4, 4, 3, 3)
        sd[f"features.{i}.bias"] = torch.zeros(4)
    sd["classifier.0.weight"] = torch.from_numpy(rng.randn(5, 6).astype(np.float32))
    return src, sd


def _close(got, want, rel=2e-4):
    want = np.asarray(want)
    bar = rel * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= bar, f"max err {err:.3e} > {bar:.3e}"


@pytest.fixture(scope="module")
def pair():
    _, sd = torchvision_state_dict()
    variables = C.convert_state_dict({k: v.numpy() for k, v in sd.items()},
                                     C.VGG16_RULES)
    x = np.random.RandomState(1).rand(2, 64, 64, 3).astype(np.float32)
    return np_tree(variables), port(vgg.VGG16Pyramid(), variables), x


@pytest.mark.parametrize("mode", ["eigth", "quarter", "full"])
def test_vgg_pyramid_matches_dvd_tpu(pair, mode):
    variables, net, x = pair
    want = jvgg.VGG16Pyramid().apply(variables, jnp.asarray(x), mode=mode)
    with torch.no_grad():
        got = net(nchw(x), mode)
    assert len(got) == len(want) == {"eigth": 3, "quarter": 1, "full": 4}[mode]
    for g, w in zip(got, want):
        assert g.shape[1] == w.shape[-1] and g.shape[2:] == w.shape[1:3]
        _close(nhwc(g), w)


def test_vgg_sixteen_raises(pair):
    variables, net, x = pair
    with pytest.raises(NotImplementedError):
        jvgg.VGG16Pyramid().apply(variables, jnp.asarray(x), mode="sixteen")
    with pytest.raises(NotImplementedError):
        net(nchw(x), "sixteen")


def test_c20_helpers_match_dvd_tpu(pair):
    variables, net, x = pair
    feats = jvgg.VGG16Pyramid().apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = net(nchw(x))
    c20 = vgg.c20_for_dit(got, 8)
    assert c20.shape == (2, 256, 8, 8)
    _close(nhwc(c20), jvgg.c20_for_dit(feats, 8))
    _close(nhwc(vgg.c20_for_unet(got, 16)), jvgg.c20_for_unet(feats, 16))
    with pytest.raises(ValueError):
        vgg.c20_for_dit(got, 16)


def test_convert_ckpt_validate_vgg(tmp_path):
    """``convert_ckpt --kind vgg --validate``: a torchvision file converted,
    loaded into the port's VGG16Pyramid through the weight bridge, and
    written; the written file serves the source weights bit for bit."""
    src, sd = torchvision_state_dict(seed=2)
    path, dst = tmp_path / "vgg16.pth", tmp_path / "vgg16.msgpack"
    torch.save(sd, path)
    cli.main(["--kind", "vgg", "--src", str(path), "--dst", str(dst),
              "--validate"])
    net = vgg.VGG16Pyramid()
    C.load_variables(net, ckpt.load_variables(str(dst)))
    for k, v in src.state_dict().items():
        assert torch.equal(net.state_dict()[k], v), k
