"""The training slice's models of ``dvd_tpu_torch`` against ``dvd_tpu`` at
f32 on the CPU: the SATRN decoder and the DiT in train mode (batch
statistics, running-stat update, gradients), the training rollout, and
the composed-warp losses with their gradients.

Dropout is off on both sides (flax's ``nn.Dropout`` patched to the
identity; the port's modules built with ``dropout=0``): the frameworks
draw different random bits.  Both sides get the same seeded weights
(through the bridge) and the same noise, drawn from the JAX keys the JAX
functions split (``losses.py:136``) and handed to the port.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_common  # noqa: F401  (sets torch to 1 thread)
from dvd_tpu.diffusion import losses as jL
from dvd_tpu.diffusion.sampler import \
    rollout_states_for_training as j_rollout
from dvd_tpu.diffusion.schedule import make_schedule as j_make_schedule
from dvd_tpu.models import satrn as jsatrn
from dvd_tpu_torch.diffusion import losses as L
from dvd_tpu_torch.diffusion.sampler import rollout_states_for_training
from dvd_tpu_torch.diffusion.schedule import make_schedule
from dvd_tpu_torch.models import satrn
from dvd_tpu_torch.models.layers import commit_batch_stats
from test_torch_common import (COND_KEYS, MINI_DIT, S, assert_trees_close,
                               fill_zero_leaves, mini_dit_port,
                               mini_dit_variables, nchw, nhwc,
                               no_flax_dropout, np_tree, port, t, torch_named,
                               train_batch)


def test_satrn_decoder_train_mode(monkeypatch):
    """Batch-statistics BN: output, running stats and every parameter
    gradient against ``jax.value_and_grad`` of the flax decoder with
    ``deterministic=True, use_running_average=False``."""
    no_flax_dropout(monkeypatch)
    rng = np.random.RandomState(0)
    feat = rng.randn(2, 4, 4, 32).astype(np.float32)
    ct = rng.randn(2, 16, 32).astype(np.float32)
    mod = jsatrn.Decoder(n_layers=2, n_head=2, d_k=8, d_v=8, d_model=32,
                         n_position=8, d_inner=64)
    v = fill_zero_leaves(np_tree(mod.init(jax.random.PRNGKey(0),
                                          jnp.asarray(feat))), 1)

    def f(params):
        out, st = mod.apply({"params": params,
                             "batch_stats": v["batch_stats"]},
                            jnp.asarray(feat), deterministic=True,
                            use_running_average=False,
                            mutable=["batch_stats"])
        return jnp.sum(out * jnp.asarray(ct)), (out, st["batch_stats"])

    (_, (want, stats)), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        v["params"])
    net = port(satrn.Decoder(2, 2, 8, 8, 32, 8, 64, dropout=0.0), v)
    out = net(t(feat), train=True)
    (out * t(ct)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=1e-4)
    assert_trees_close(_grads_of(net), torch_named(grads, net), rel=1e-4)
    commit_batch_stats(net)
    assert_trees_close(dict(net.named_buffers()),
                       torch_named(stats, net, "batch_stats"), rel=1e-6)


def _grads_of(net):
    return {k: p.grad for k, p in net.named_parameters() if p.grad is not None}


@pytest.fixture(scope="module")
def mini():
    return mini_dit_variables()


def _dit_pair(mini):
    mod, v = mini
    return mod, v, mini_dit_port(v)


def _inputs(seed, b=2):
    rng = np.random.RandomState(seed)
    return dict(
        x=rng.randn(b, S, S, 2).astype(np.float32),
        t=np.arange(b, dtype=np.float32) % 3,
        y512=rng.rand(b, 128, 128, 3).astype(np.float32),
        mask_cat=rng.rand(b, 128, 128, 1).astype(np.float32),
        mask_y512=rng.randn(b, 16, 16, 384).astype(np.float32),
        line_msk=rng.randn(b, 16, 16, 64).astype(np.float32),
        init_flow=(rng.randn(b, 16, 16, 2) * 0.1).astype(np.float32),
        init_feat=rng.randn(b, 16, 16, 256).astype(np.float32))


def _port_kwargs(inp):
    return dict(init_flow=t(inp["init_flow"]),
                init_feat=nchw(inp["init_feat"]), y512=nchw(inp["y512"]),
                mask_cat=nchw(inp["mask_cat"]),
                mask_y512=nchw(inp["mask_y512"]),
                line_msk=nchw(inp["line_msk"]))


def test_dit_train_mode_mixed_seed(mini, monkeypatch):
    """``train=True`` with a per-sample ``seed_init_feat`` (one sample
    seeded from the pyramid, one not): output, features and the BN
    running statistics after the update."""
    no_flax_dropout(monkeypatch)
    mod, v, net = _dit_pair(mini)
    inp = _inputs(1)
    seed = np.array([True, False])
    a = {k: jnp.asarray(x) for k, x in inp.items()}
    apply = jax.jit(functools.partial(
        mod.apply, remap_timesteps=False, train=True,
        mutable=["batch_stats"]))
    (want_pred, want_feat), st = apply(
        v, a.pop("x"), a.pop("t"), seed_init_feat=jnp.asarray(seed),
        rngs={"dropout": jax.random.PRNGKey(1)}, **a)
    pred, feat = net(t(inp["x"]), t(inp["t"]),
                     seed_init_feat=torch.from_numpy(seed),
                     remap_timesteps=False, train=True, **_port_kwargs(inp))
    assert np.abs(np.asarray(want_pred) - inp["init_flow"]).max() > 1e-2
    np.testing.assert_allclose(pred.detach().numpy(), np.asarray(want_pred),
                               atol=1e-4)
    np.testing.assert_allclose(nhwc(feat), np.asarray(want_feat), atol=1e-4,
                               rtol=1e-4)
    commit_batch_stats(net)
    assert_trees_close(dict(net.named_buffers()),
                       torch_named(st["batch_stats"], net, "batch_stats"),
                       rel=1e-5)


def test_rollout_states_for_training(mini, monkeypatch):
    """The vectorised training rollout at t = (0, 1, 2): every sample's
    hand-off state, with x_T from the JAX key the loss splits off
    (``losses.py:136``) and train-mode model calls on both sides."""
    no_flax_dropout(monkeypatch)
    mod, v, net = _dit_pair(mini)
    b = 3
    inp = _inputs(2, b)
    tt = np.array([0, 1, 2])
    k_roll = jax.random.split(jax.random.PRNGKey(3))[1]
    x_t = np.asarray(jax.random.normal(k_roll, (b, 16, 16, 2), jnp.float32))
    jcond = {k: jnp.asarray(inp[k])
             for k in ("y512", "mask_cat", "mask_y512", "line_msk")}

    def j_model_fn(x, tm, cond, **kw):
        out, _ = mod.apply(v, x, tm, **cond, **kw, train=True,
                           mutable=["batch_stats"],
                           rngs={"dropout": jax.random.PRNGKey(0)})
        return out

    want_flow, want_feat = jax.jit(functools.partial(
        j_rollout, j_model_fn, j_make_schedule(steps=3), latent_size=16))(
        jcond, jnp.asarray(inp["init_flow"]), jnp.asarray(inp["init_feat"]),
        jnp.asarray(tt), rng=k_roll)
    kw = _port_kwargs(inp)
    init_flow, init_feat = kw.pop("init_flow"), kw.pop("init_feat")

    def model_fn(x, tm, cond, **k):
        return net(x, tm, **cond, **k, train=True)

    flow, feat = rollout_states_for_training(
        model_fn, make_schedule(steps=3), kw, init_flow, init_feat,
        torch.from_numpy(tt), latent_size=16, noise=t(x_t))
    np.testing.assert_allclose(flow.numpy(), np.asarray(want_flow), atol=1e-4)
    np.testing.assert_allclose(nhwc(feat), np.asarray(want_feat), atol=1e-4,
                               rtol=1e-4)
    # t == T-1 keeps the initial state; the others moved
    np.testing.assert_array_equal(flow[2].numpy(), inp["init_flow"][2])
    assert np.abs(flow[0].numpy() - inp["init_flow"][0]).max() > 1e-2


def _j_model_fn(mod, params, batch_stats):
    def model_fn(x, tt, cond, **kw):
        out, _ = mod.apply({"params": params, "batch_stats": batch_stats},
                           x, tt, **cond, **kw, train=True,
                           mutable=["batch_stats"],
                           rngs={"dropout": jax.random.PRNGKey(0)})
        return out
    return model_fn


def _conv_as_slices(conv):
    """``lax.conv_general_dilated`` for stride-1 NHWC/HWIO convolutions as
    the sum it defines: a matmul over the kernel's shifted input slices
    (or, depthwise, a weighted sum of them).  XLA's CPU convolution runs
    orders of magnitude slower in float64 than in f32, this form about as
    fast; other convolutions (the strided patch embedders) go to
    ``conv``."""

    def f(lhs, rhs, window_strides, padding, *, lhs_dilation=None,
          rhs_dilation=None, dimension_numbers=None, feature_group_count=1,
          precision=None, preferred_element_type=None):
        kh, kw, cin_g, cout = rhs.shape
        n, h, w, cin = lhs.shape
        if tuple(window_strides) != (1, 1):
            return conv(lhs, rhs, window_strides, padding,
                        lhs_dilation=lhs_dilation, rhs_dilation=rhs_dilation,
                        dimension_numbers=dimension_numbers,
                        feature_group_count=feature_group_count,
                        precision=precision,
                        preferred_element_type=preferred_element_type)
        assert tuple(lhs_dilation or (1, 1)) == (1, 1) \
            and tuple(rhs_dilation or (1, 1)) == (1, 1)
        if isinstance(padding, str):
            assert padding == "SAME", padding
            padding = [((kh - 1) // 2, kh // 2), ((kw - 1) // 2, kw // 2)]
        x = jnp.pad(lhs, ((0, 0), tuple(padding[0]), tuple(padding[1]),
                          (0, 0)))
        cols = [x[:, i:i + h, j:j + w, :] for i in range(kh)
                for j in range(kw)]
        if feature_group_count == 1:
            return jnp.concatenate(cols, -1) @ rhs.reshape(-1, cout)
        assert feature_group_count == cin == cout and cin_g == 1
        k = rhs.reshape(kh * kw, cout)
        return sum(c * k[i] for i, c in enumerate(cols))

    return f


def _reference_in_float64(monkeypatch):
    """Run ``dvd_tpu``'s DiT in float64 (x64 on) for one test: its steps
    that compute in f32 whatever the model dtype (the DiT's layer norm, the
    attention softmax, the timestep embedding) in the input's dtype, so no
    f32 rounding is left in the run, and its stride-1 convolutions as
    :func:`_conv_as_slices`.  The formulas are the reference's; the
    convolution form is checked against XLA's here."""
    from dvd_tpu.models import dit as jdit
    from dvd_tpu.models import layers as jlayers

    def layer_norm(x, eps=1e-6):
        mean = jnp.mean(x, axis=-1, keepdims=True)
        return (x - mean) * jax.lax.rsqrt(
            jnp.var(x, axis=-1, keepdims=True) + eps)

    def scaled_dot_attention(q, k, v, scale=None):
        scale = q.shape[-1] ** -0.5 if scale is None else scale
        p = jax.nn.softmax(jnp.einsum("nhqd,nhkd->nhqk", q, k) * scale, -1)
        return jnp.einsum("nhqk,nhkd->nhqd", p, v)

    def timestep_embedding(tt, dim, max_period=10000.0):
        half = dim // 2
        freqs = jnp.exp(-np.log(max_period)
                        * jnp.arange(half, dtype=jnp.float64) / half)
        args = tt.astype(jnp.float64)[:, None] * freqs[None]
        return jnp.concatenate([jnp.cos(args), jnp.sin(args)], axis=-1)

    conv = jax.lax.conv_general_dilated
    slices = _conv_as_slices(conv)
    rng = np.random.RandomState(5)
    dn = ("NHWC", "HWIO", "NHWC")
    with jax.enable_x64(True):
        for kshape, groups in (((3, 3, 5, 7), 1), ((1, 1, 5, 7), 1),
                               ((3, 3, 1, 5), 5)):
            x = jnp.asarray(rng.randn(2, 6, 6, 5))
            k = jnp.asarray(rng.randn(*kshape))
            want = conv(x, k, (1, 1), "SAME", dimension_numbers=dn,
                        feature_group_count=groups)
            np.testing.assert_allclose(
                slices(x, k, (1, 1), "SAME", feature_group_count=groups),
                want, rtol=1e-12, atol=1e-12)
    monkeypatch.setattr(jax.lax, "conv_general_dilated", slices)
    monkeypatch.setattr(jdit, "layer_norm", layer_norm)
    monkeypatch.setattr(jlayers, "scaled_dot_attention", scaled_dot_attention)
    monkeypatch.setattr(jsatrn, "scaled_dot_attention", scaled_dot_attention)
    monkeypatch.setattr(jlayers, "timestep_embedding", timestep_embedding)


@pytest.mark.parametrize("variant", ["time_variant", "composed"])
def test_losses_and_gradients(mini, variant, monkeypatch):
    """Loss and per-sample MSE (<= 1e-4 relative) and every gradient tensor
    (<= 1e-4 of its own largest element) against ``jax.value_and_grad`` of
    the same loss, at t = (0, 1, 2) with smooth random flows.

    Both sides run in float64: in f32 the port's small gradients move with
    rounding by far more than 1e-4 of their largest element (the SATRN
    feed-forward's BN -> ReLU kinks flip with the last bit of their input,
    and BN's backward cancels), so f32 could not tell a wrong small
    gradient from rounding.  In float64 the closest tensor comes to 0.09
    of its bar.  The floor only catches the gradients that are zero by
    invariance (a LayerNorm bias feeding a BN, a key bias under softmax),
    about 1e-18 on both sides; the smallest other tensor peaks at 1.5e-5."""
    from dvd_tpu.models.dit import DiT as JDiT

    no_flax_dropout(monkeypatch)
    _reference_in_float64(monkeypatch)
    _, v = mini
    jb, pb = train_batch(3)
    tt = np.array([0, 1, 2])
    zf = np.zeros((3, S, S, 2))
    zfeat = np.zeros((3, S, S, 256))
    with jax.enable_x64(True):
        mod = JDiT(tv=True, chain_blocks=False, dtype=jnp.float64, **MINI_DIT)
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), v)
        jb = {k: jnp.asarray(np.asarray(x), jnp.float64) for k, x in jb.items()}
        rng = jax.random.PRNGKey(4)
        if variant == "time_variant":
            # drawn as the JAX loss draws them: the noise in the flow's
            # dtype, the rollout's x_T in f32 (``sampler.py:183``)
            k_noise, k_roll = jax.random.split(rng)
            noises = dict(
                noise=jax.random.normal(k_noise, (3, S, S, 2), jnp.float64),
                rollout_noise=jax.random.normal(k_roll, (3, S, S, 2),
                                                jnp.float32))
            j_loss, loss = jL.time_variant_loss, L.time_variant_loss
        else:
            noises = dict(noise=jax.random.normal(rng, (3, S, S, 2),
                                                  jnp.float64))
            j_loss, loss = jL.composed_warp_loss, L.composed_warp_loss

        def f(params):
            terms = j_loss(_j_model_fn(mod, params, v64["batch_stats"]),
                           j_make_schedule(steps=3),
                           {k: jb[k] for k in COND_KEYS}, jnp.asarray(zf),
                           jnp.asarray(zfeat), jb["flow64"], jb["flow_inter"],
                           jb["mask"], jnp.asarray(tt), rng)
            return terms["loss"], terms

        (_, want), want_g = jax.jit(jax.value_and_grad(f, has_aux=True))(
            v64["params"])
        want_g = jax.tree_util.tree_map(np.asarray, want_g)
        noises = {k: torch.from_numpy(np.array(x))
                  for k, x in noises.items()}
        want = {k: np.asarray(x) for k, x in want.items()}
    net = mini_dit_port(v).double()

    def model_fn(x, tm, cond, **kw):
        return net(x, tm, **cond, **kw, train=True)

    terms = loss(model_fn, make_schedule(steps=3),
                 {k: pb[k].double() for k in COND_KEYS},
                 torch.from_numpy(zf), nchw(zfeat).double(),
                 pb["flow64"].double(), pb["flow_inter"].double(),
                 pb["mask"].double(), torch.from_numpy(tt), **noises)
    terms["loss"].backward()
    np.testing.assert_allclose(terms["loss"].item(), float(want["loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(terms["mse_per"].detach().numpy(),
                               want["mse_per"], rtol=1e-4)
    got = _grads_of(net)
    want_named = torch_named(want_g, net)
    # the dead block: zeros in JAX, no gradient here
    for k in set(want_named) - set(got):
        assert not want_named.pop(k).any(), k
    assert_trees_close(got, want_named, rel=1e-4, floor=1e-9)
