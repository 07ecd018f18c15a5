"""int8 serving (``model.quantize="int8"``) of ``dvd_tpu_torch`` against
``dvd_tpu``'s on the CPU: ``ops/quant.py``, the W8A8 layers, the SATRN
decoder, DiT-mini and the tiny ``DewarpPipeline``, with the same weights
(f32, through the bridge) and the same inputs (numpy, from a seed).

The int8 ops are bit for bit against ``dvd_tpu``'s eager ones; a jitted
``int8_dense`` is within 4 f32 ulps (XLA divides by 127 as a product
with the reciprocal).  Modules are held to 1e-4 of max|ref|, the port's
f32 DiT/SATRN bar.  Upstream of a quantize pass the two frameworks' f32 results differ
by a few ulps, which can move an element across a rounding tie: its int8
code then differs by one step.  :class:`CodeBook` records ``dvd_tpu``'s
codes, finds the port's flips (each exactly one step, and rare), counts
them and replays ``dvd_tpu``'s code there, so the bar holds for
everything else.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvd_tpu.models import dit as jdit
from dvd_tpu.models import layers as jlayers
from dvd_tpu.models import satrn as jsatrn
from dvd_tpu.ops import quant as jquant
from dvd_tpu_torch.models import dit, layers, satrn
from dvd_tpu_torch.ops import quant
from test_torch_common import (MINI_DIT, SRC, TINY_MODEL, S,
                               fill_zero_leaves, mask_margin_shift,
                               mini_dit_variables, nchw, nhwc, np_tree, port,
                               random_variables, t, torch_named)

KEY = jax.random.PRNGKey(0)
REL = 1e-4          # the port's f32 DiT/SATRN bar, x max|ref|


def _rand(*shape, seed=0, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)
            ).astype(np.float32)


class CodeBook:
    """``dvd_tpu``'s int8 codes in the order its run made them, and their
    replay into the port's run: each port quantize pass is matched to the
    unused record of its shape with the fewest differing codes; every
    difference must be one step (a flip at a rounding tie), and the
    record's codes are returned in place of the port's."""

    def __init__(self, monkeypatch):
        self.mp, self.want, self.flips, self.codes = monkeypatch, [], 0, 0

    def record(self):
        orig = jquant.quantize_rows

        def rec(x):
            q, s = orig(x)
            self.want.append(np.asarray(q))
            return q, s

        self.mp.setattr(jquant, "quantize_rows", rec)

    def replay(self):
        orig, used = quant.quantize_rows, set()

        def rep(x):
            q, s = orig(x)
            got = q.numpy()
            cands = [i for i, w in enumerate(self.want)
                     if i not in used and w.shape == got.shape]
            assert cands, f"no dvd_tpu quantize pass of shape {got.shape}"
            i = min(cands, key=lambda j: np.count_nonzero(self.want[j] != got))
            diff = self.want[i].astype(np.int32) - got
            assert np.abs(diff).max() <= 1, "an int8 code moved by > 1 step"
            used.add(i)
            self.flips += np.count_nonzero(diff)
            self.codes += got.size
            return torch.from_numpy(self.want[i].copy()), s

        for mod in (quant, layers, satrn):
            self.mp.setattr(mod, "quantize_rows", rep)

    def check(self):
        """Flips are rare: at most one code in a thousand."""
        assert self.codes > 0
        assert self.flips <= 1e-3 * self.codes, (self.flips, self.codes)


def _close_rel(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


# ------------------------------------------------------------- the ops
def _tie_rows():
    """Rows whose scale is exactly 1 (max 127), so x / s lands on .5
    ties, and an all-zero row."""
    x = np.zeros((3, 16), np.float32)
    x[0, :8] = [127, 0.5, 1.5, 2.5, -2.5, -0.5, 3.5, -126.5]
    x[1, :4] = [-127, 0.5, 64.5, -64.5]
    return x


QUANT_INPUTS = {
    "rank2": lambda: _rand(64, 96),
    "rank3": lambda: _rand(2, 17, 48, seed=1, scale=3.0),
    "ties_and_zero_rows": _tie_rows,
    "tiny_and_huge": lambda: np.concatenate(
        [_rand(4, 24, seed=2, scale=1e-6), _rand(4, 24, seed=3, scale=1e5)]),
}


@pytest.mark.parametrize("case", sorted(QUANT_INPUTS))
def test_quantize_rows_equals_dvd_tpu(case):
    x = QUANT_INPUTS[case]()
    wq, ws = jquant.quantize_rows(jnp.asarray(x))
    q, s = quant.quantize_rows(t(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ws))
    if case == "ties_and_zero_rows":   # half to even; zero rows give 0
        np.testing.assert_array_equal(q.numpy()[0, :8],
                                      [127, 0, 2, 2, -2, 0, 4, -126])
        assert not q.numpy()[2].any()


def test_quantize_rows_of_bf16_input():
    x = _rand(8, 32, seed=4)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    wq, ws = jquant.quantize_rows(xb)
    q, s = quant.quantize_rows(t(x).bfloat16())
    np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ws))


@pytest.mark.parametrize("rank", [2, 3])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("prequant", [False, True])
def test_int8_dense_equals_dvd_tpu(rank, bias, prequant):
    """Bit for bit against dvd_tpu's eager ``int8_dense``, the formula as
    written.  Its jitted one is the same formula rounded otherwise: XLA
    divides by 127 as a multiplication by the reciprocal (the scale then
    differs by one ulp on a few rows) and fuses the rescale, so the port
    is within 4 ulps of the product's magnitude of it."""
    x = _rand(*((37, 64) if rank == 2 else (3, 19, 64)), seed=5)
    kernel = _rand(64, 40, seed=6, scale=0.1)                 # (K, N)
    b = _rand(40, seed=7) if bias else None
    jx, jk = jnp.asarray(x), jnp.asarray(kernel)
    jb = None if b is None else jnp.asarray(b)
    jpre = jquant.quantize_rows(jx) if prequant else None
    eager = np.asarray(jquant.int8_dense(jx, jk, jb, prequant=jpre))
    jitted = np.asarray(jax.jit(jquant.int8_dense)(jx, jk, jb, jpre))
    pre = quant.quantize_rows(t(x)) if prequant else None
    got = quant.int8_dense(t(x), t(kernel.T), None if b is None else t(b),
                           prequant=pre).numpy()
    assert got.shape == eager.shape and got.dtype == np.float32
    np.testing.assert_array_equal(got, eager)
    mag = np.maximum(np.abs(got), np.abs(got - (0 if b is None else b)))
    assert (np.abs(got - jitted) <= 4 * np.spacing(mag)).all()


def test_int8_dense_out_dtype_and_cached_weight():
    """``out_dtype`` casts last; the cached codes of a Linear give the same
    result as quantizing its weight in the call."""
    x = _rand(20, 48, seed=8)
    lin = torch.nn.Linear(48, 24)
    want = quant.int8_dense(t(x), lin.weight, lin.bias)
    got = quant.qlinear(lin, t(x))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    bf = quant.int8_dense(t(x), lin.weight, lin.bias, out_dtype=torch.bfloat16)
    assert bf.dtype == torch.bfloat16
    torch.testing.assert_close(bf, want.bfloat16(), rtol=0, atol=0)


def _rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12)


@pytest.mark.parametrize("rank, bar", [(2, 0.02), (3, 0.03)])
def test_int8_dense_close_to_exact(rank, bar):
    """``tests/test_quant.py``'s bounds against the f32 product."""
    x = _rand(*((64, 96) if rank == 2 else (2, 17, 96)), seed=9)
    w = _rand(96, 128, seed=10, scale=0.05)
    b = _rand(128, seed=11, scale=0.1) if rank == 2 else None
    got = quant.int8_dense(t(x), t(w.T), None if b is None else t(b))
    want = x @ w + (0 if b is None else b)
    assert _rel_err(got.numpy(), want) < bar


def test_int8_dense_zero_rows_safe():
    out = quant.int8_dense(torch.zeros(4, 8), torch.ones(3, 8))
    assert torch.isfinite(out).all() and not out.any()


def test_int_mm_shape_rules_name_the_layer():
    """The card's ``_int_mm`` rules, checked before any launch: M > 16, K
    and N multiples of 8.  The CPU has no such rule."""
    a8 = torch.zeros(32, 24, dtype=torch.int8)
    quant._check_int_mm(a8, torch.zeros(24, 16, dtype=torch.int8), "ok")
    for a, b in (((16, 24), (24, 16)), ((32, 20), (20, 16)),
                 ((32, 24), (24, 12))):
        with pytest.raises(ValueError, match="blocks_1.attn.qkv"):
            quant._check_int_mm(torch.zeros(a, dtype=torch.int8),
                                torch.zeros(b, dtype=torch.int8),
                                "blocks_1.attn.qkv")
    out = quant.int_mm(torch.ones(3, 5, dtype=torch.int8),
                       torch.ones(5, 7, dtype=torch.int8))
    assert out.dtype == torch.int32 and (out == 5).all()


def test_int8_weight_cache_follows_loads():
    """Quantized once per weight set: reused while the weight is
    unchanged, redone after an in-place load; bf16 weights refused."""
    lin = torch.nn.Linear(16, 8)
    first = quant.int8_weight(lin)
    assert quant.int8_weight(lin) is first
    sd = {k: v * 2 for k, v in lin.state_dict().items()}
    lin.load_state_dict(sd)
    second = quant.int8_weight(lin)
    assert second is not first
    want = quant.quantize_rows(lin.weight.detach())
    torch.testing.assert_close(second[0], want[0], rtol=0, atol=0)
    torch.testing.assert_close(second[1], want[1].flatten(), rtol=0, atol=0)
    with pytest.raises(TypeError):
        quant.int8_weight(torch.nn.Linear(16, 8).bfloat16())


# ------------------------------------------------------------ the layers
def _init(mod, *args, **kw):
    return np_tree(mod.init(KEY, *args, **kw))


def test_self_attention_int8(monkeypatch):
    x = _rand(2, 16, 48)
    v = fill_zero_leaves(_init(jlayers.SelfAttention(48, 3), jnp.asarray(x)),
                         1)
    book = CodeBook(monkeypatch)
    book.record()
    want = jlayers.SelfAttention(48, 3, quant=True).apply(v, jnp.asarray(x))
    book.replay()
    with torch.no_grad():
        got = port(layers.SelfAttention(48, 3, quant=True), v)(t(x))
    book.check()
    _close_rel(got, want)


def test_cross_attention_int8_shares_prequant(monkeypatch):
    """k and v project one tensor: one quantize pass serves both (the
    query's, the key/value's and the output projection's: 3 activation
    passes besides the 4 weights')."""
    q, kv = _rand(2, 16, 48), _rand(2, 20, 48, seed=1)
    jargs = (jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv))
    v = fill_zero_leaves(_init(jlayers.CrossAttention(48, 3), *jargs), 1)
    book = CodeBook(monkeypatch)
    book.record()
    want = jlayers.CrossAttention(48, 3, quant=True).apply(
        v, jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv))
    book.replay()
    calls = []
    seen = quant.quantize_rows

    def counted(x):
        calls.append(tuple(x.shape))
        return seen(x)

    for mod in (quant, layers):
        monkeypatch.setattr(mod, "quantize_rows", counted)
    kvt = t(kv)
    with torch.no_grad():
        got = port(layers.CrossAttention(48, 3, quant=True), v)(t(q), kvt, kvt)
    book.check()
    _close_rel(got, want)
    assert sorted(calls) == sorted([(48, 48)] * 4 + [(2, 16, 48), (2, 20, 48),
                                                     (2, 16, 48)])


def test_mlp_int8(monkeypatch):
    x = _rand(2, 16, 48)
    v = fill_zero_leaves(_init(jlayers.Mlp(192, 48), jnp.asarray(x)), 1)
    book = CodeBook(monkeypatch)
    book.record()
    want = jlayers.Mlp(192, 48, quant=True).apply(v, jnp.asarray(x))
    book.replay()
    with torch.no_grad():
        got = port(layers.Mlp(48, 192, 48, quant=True), v)(t(x))
    book.check()
    _close_rel(got, want)


def test_satrn_decoder_int8(monkeypatch):
    """f32 compute; the 1x1 convs and the projections W8A8, the depthwise
    3x3 in f32."""
    feat = _rand(2, 4, 4, 32)
    kw = dict(n_layers=2, n_head=2, d_k=8, d_v=8, d_model=32, n_position=8,
              d_inner=64)
    v = fill_zero_leaves(_init(jsatrn.Decoder(**kw), jnp.asarray(feat)), 1)
    book = CodeBook(monkeypatch)
    book.record()
    want = jsatrn.Decoder(quant=True, **kw).apply(v, jnp.asarray(feat))
    book.replay()
    net = port(satrn.Decoder(2, 2, 8, 8, 32, 8, 64, quant=True), v)
    assert net.layer_stack_0.feed_forward.conv1.quant
    assert not net.layer_stack_0.feed_forward.depthwise_conv.quant
    with torch.no_grad():
        got = net(t(feat))
    book.check()
    _close_rel(got, want)


def _dit_inputs(seed=0):
    rng = np.random.RandomState(seed)
    return dict(
        x=rng.randn(2, 16, 16, 2).astype(np.float32),
        t=np.array([1000 * 2 / 3, 1000 / 3], np.float32),
        y512=rng.rand(2, 128, 128, 3).astype(np.float32),
        mask_cat=rng.rand(2, 128, 128, 1).astype(np.float32),
        mask_y512=rng.randn(2, 16, 16, 384).astype(np.float32),
        line_msk=rng.randn(2, 16, 16, 64).astype(np.float32),
        init_flow=(rng.randn(2, 16, 16, 2) * 0.1).astype(np.float32),
        init_feat=rng.randn(2, 16, 16, 256).astype(np.float32))


def test_dit_mini_int8(monkeypatch):
    """DiT-mini with ``quant`` against dvd_tpu's int8 DiT: the prediction
    within 1e-4 of max|ref|, the (unquantized) pyramid features as in the
    f32 test; 68 int8 products a call at 4 streams (32 in the live
    block, 36 in the decoder)."""
    a = {k: jnp.asarray(v) for k, v in _dit_inputs().items()}
    x, tt = a.pop("x"), a.pop("t")
    jmod = jdit.DiT(tv=True, chain_blocks=False, **MINI_DIT)
    v = fill_zero_leaves(_init(jmod, x, tt, remap_timesteps=False, **a), 7)
    inp = _dit_inputs(1)
    a = {k: jnp.asarray(w) for k, w in inp.items()}
    book = CodeBook(monkeypatch)
    book.record()
    want_pred, want_feat = jdit.DiT(tv=True, chain_blocks=False, quant=True,
                                    **MINI_DIT).apply(
        v, a.pop("x"), a.pop("t"), remap_timesteps=True, **a)
    book.replay()
    products = []
    mm = quant.int_mm
    monkeypatch.setattr(quant, "int_mm", lambda *args: products.append(1)
                        or mm(*args))
    net = port(dit.DiT(**MINI_DIT, quant=True), v)
    assert len(net.int8_layers()) == 2 * 8 + 6 * 6   # both blocks, decoder
    with torch.no_grad():
        pred, feat = net(
            t(inp["x"]), t(inp["t"]), init_flow=t(inp["init_flow"]),
            init_feat=nchw(inp["init_feat"]), y512=nchw(inp["y512"]),
            mask_cat=nchw(inp["mask_cat"]), mask_y512=nchw(inp["mask_y512"]),
            line_msk=nchw(inp["line_msk"]), remap_timesteps=True)
    book.check()
    assert len(products) == 4 * 8 + 6 * 6
    np.testing.assert_allclose(nhwc(feat), want_feat, atol=1e-4, rtol=1e-4)
    assert np.abs(np.asarray(want_pred) - inp["init_flow"]).max() > 1e-2
    _close_rel(pred, want_pred)


# ------------------------------------------------- weights and pipeline
def _int8_cfg(compute_dtype="float32", **paths):
    from dvd_tpu_torch.config import default_config

    return default_config().replace(
        model=dict(TINY_MODEL, dit_variant="DiT-mini", quantize="int8",
                   compute_dtype=compute_dtype),
        diffusion={"n_batch": 2}, paths=paths)


def test_int8_codes_from_converted_f32_weights(tmp_path):
    """dvd_tpu's DiT-mini variables, drawn so almost no weight is a bf16
    value, written with dvd_tpu's ``save_variables`` and served by the
    port's bf16-compute int8 pipeline through
    ``maybe_load_pipeline_weights``: every int8 layer's codes and scales
    equal dvd_tpu's quantization of the same f32 kernel (which a bf16
    copy of the weights would not give), and the rest of the DiT is
    stored in bf16."""
    from dvd_tpu.training import checkpoint as jckpt
    from dvd_tpu_torch.evaluation.pipeline import DewarpPipeline
    from dvd_tpu_torch.training.checkpoint import maybe_load_pipeline_weights

    _, v = mini_dit_variables()
    jckpt.save_variables(str(tmp_path / "dit.msgpack"), v)
    cfg = _int8_cfg("bfloat16", model_path=str(tmp_path / "dit.pt"))
    pipe = DewarpPipeline.create(cfg, "cpu",
                                 generator=torch.Generator().manual_seed(3))
    assert maybe_load_pipeline_weights(pipe, cfg)["dit_vars"]
    want = torch_named(v["params"], dit.DiT(**MINI_DIT, quant=True))
    qlayers = pipe.dit.int8_layers()
    assert len(qlayers) == 2 * 8 + 6 * 6
    differs = 0
    for name, layer in qlayers:
        w = want[f"{name}.weight"].reshape(layer.weight.shape[0], -1)
        assert layer.weight.dtype == torch.float32
        assert np.mean(w != w.astype(jnp.bfloat16).astype(np.float32)) > 0.9
        jq, js = jquant.quantize_rows(jnp.asarray(w))
        q, s = quant.int8_weight(layer)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js).ravel())
        bq, _ = quant.quantize_rows(torch.from_numpy(w).bfloat16())
        differs += int((bq != q).any())
    assert differs > len(qlayers) // 2       # a bf16 copy would not do
    assert pipe.dit.obs_embedder.proj.weight.dtype == torch.bfloat16
    assert pipe.dit.decoder.layer_stack_0.norm1.scale.dtype == torch.bfloat16


@pytest.fixture(scope="module")
def int8_pair():
    """dvd_tpu's tiny int8 pipeline (DiT-mini, f32 and bf16 compute) and
    its weights, source and pinned x_T: its f32 flow sampled eagerly with
    its int8 codes recorded, its bf16 flow jitted."""
    from dvd_tpu.config import default_config as j_default_config
    from dvd_tpu.evaluation.pipeline import DewarpPipeline as JPipeline
    from dvd_tpu.evaluation.pipeline import unwarp_fixed as j_unwarp_fixed
    from dvd_tpu.models.u2net import U2NetP as JU2NetP
    from dvd_tpu.ops.resize import resize_bilinear as j_resize

    mp = pytest.MonkeyPatch()
    rng = np.random.RandomState(0)
    src = rng.rand(2, SRC, SRC, 3).astype(np.float32)
    noise = rng.randn(4, S, S, 2).astype(np.float32)
    out = {"src": src, "noise": noise}
    for dt in ("float32", "bfloat16"):
        over = dict(model=dict(TINY_MODEL, quantize="int8", compute_dtype=dt),
                    diffusion={"n_batch": 2})
        jp = JPipeline.create(j_default_config().replace(**over))
        jp.dit = jdit.DiT(tv=True, chain_blocks=False, quant=True,
                          dtype=jnp.dtype(dt), **MINI_DIT)
        if dt == "float32":     # seeded variables, without compiling init
            img = jnp.zeros((1, 64, 64, 3))
            seg = random_variables(jp.seg, img, seed=1)
            d0 = JU2NetP(1).apply(
                {"params": seg["params"]["msk"],
                 "batch_stats": seg["batch_stats"]["msk"]},
                j_resize(jnp.asarray(src), (64, 64), align_corners=True))[0]
            seg["params"]["msk"]["outconv"]["bias"] += mask_margin_shift(
                np.asarray(d0))
            out["vars"] = dict(dit=mini_dit_variables()[1], seg=seg,
                               line=random_variables(jp.line, img, seed=2),
                               geotr=random_variables(jp.geotr, img, seed=3))
        w = out["vars"]
        jp.dit_vars, jp.seg_vars = w["dit"], w["seg"]
        jp.line_vars, jp.geotr_vars = w["line"], w["geotr"]
        cond, init_flow, init_feat = jp.build_conditioning(jnp.asarray(src))
        if dt == "float32":
            book = CodeBook(mp)
            book.record()
            with jax.disable_jit():
                flow = jp.sampling_impl(w["dit"], cond, init_flow, init_feat,
                                        jax.random.PRNGKey(5),
                                        init_noise=jnp.asarray(noise))
            mp.undo()
            out["book"] = book.want
        else:
            flow = jax.jit(jp.sampling_impl)(
                w["dit"], cond, init_flow, init_feat, jax.random.PRNGKey(5),
                init_noise=jnp.asarray(noise))
        out[dt] = (np.asarray(flow), np.asarray(
            j_unwarp_fixed(jnp.asarray(src), flow)))
    return out


def _port_int8_pipeline(pair, compute_dtype):
    from dvd_tpu_torch.evaluation.pipeline import DewarpPipeline
    from dvd_tpu_torch.training.convert import load_variables

    w = pair["vars"]
    pipe = DewarpPipeline.create(_int8_cfg(compute_dtype), "cpu",
                                 dit=dit.DiT(**MINI_DIT, quant=True))
    for net in ("dit", "seg", "line"):
        port(getattr(pipe, net), w[net])
    load_variables(pipe.geotr, w["geotr"])
    return pipe


def test_int8_pipeline_matches_dvd_tpu(int8_pair, monkeypatch):
    """dewarp_flow + unwarp_fixed, f32 compute, 3 DDIM steps x 2
    hypotheses: the flow and the image within 1e-4 of max|ref| of
    dvd_tpu's, its int8 codes replayed where a tie flipped (counted)."""
    from dvd_tpu_torch.evaluation.pipeline import unwarp_fixed

    pipe = _port_int8_pipeline(int8_pair, "float32")
    book = CodeBook(monkeypatch)
    book.want = int8_pair["book"]
    book.replay()
    flow = pipe.dewarp_flow(t(int8_pair["src"]),
                            init_noise=t(int8_pair["noise"]))
    book.check()
    want_flow, want_image = int8_pair["float32"]
    assert np.abs(want_flow).max() > 1e-2          # the DiT reached it
    _close_rel(flow, want_flow)
    image = unwarp_fixed(t(int8_pair["src"]), flow)
    _close_rel(image, want_image)


def test_int8_pipeline_bf16_matches_dvd_tpu(int8_pair):
    """bf16 compute: the port's flow against dvd_tpu's (jitted) within
    twice dvd_tpu's own bf16 effect on the CPU, its bf16 flow against its
    f32 one (three random-weight DDIM steps amplify rounding)."""
    pipe = _port_int8_pipeline(int8_pair, "bfloat16")
    assert pipe.dit.blocks_1.attn.qkv.weight.dtype == torch.float32
    flow = pipe.dewarp_flow(t(int8_pair["src"]),
                            init_noise=t(int8_pair["noise"]))
    assert flow.dtype == torch.float32 and torch.isfinite(flow).all()
    want = int8_pair["bfloat16"][0]
    own = np.abs(want - int8_pair["float32"][0]).max()
    err = np.abs(flow.numpy() - want).max()
    assert 0 < own and err <= 2 * own, (err, own)


def test_int8_cannot_be_trained():
    """int8 is serving only: the train state and ``train()`` raise, as
    dvd_tpu's ``create_train_state`` does."""
    from dvd_tpu_torch.evaluation.pipeline import DewarpPipeline
    from dvd_tpu_torch.training.train_loop import train
    from dvd_tpu_torch.training.train_state import create_train_state

    cfg = _int8_cfg()
    with pytest.raises(ValueError, match="quantize"):
        create_train_state(cfg, dit.DiT(**MINI_DIT))
    with pytest.raises(ValueError, match="quantize"):
        train(cfg, iter(()), max_steps=1, device="cpu")
    with pytest.raises(ValueError, match="quant"):     # an fp DiT under int8
        DewarpPipeline.create(cfg, "cpu", dit=dit.DiT(**MINI_DIT))
