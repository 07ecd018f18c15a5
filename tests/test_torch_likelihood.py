"""The port's likelihood stack (``diffusion/likelihood.py`` and
``gaussian.py``'s ``q_posterior_mean`` / ``predict_xstart_from_eps``)
against ``dvd_tpu``'s on the CPU at f32: each function within 1e-6
relative on the same inputs (NHWC there, NCHW here); the analytic cases
of ``tests/test_likelihood.py`` on the port; ``calc_bpd_loop`` with a
perfect denoiser within 1e-6 and with DiT-mini within 1e-3 of max|ref|
(the DiT's parity bar), each step's noise pinned to ``dvd_tpu``'s own
``fold_in(rng, t)`` draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

import test_torch_common  # noqa: F401  (sets torch to 1 thread)
from dvd_tpu.diffusion import gaussian as jG
from dvd_tpu.diffusion import likelihood as jL
from dvd_tpu.diffusion.schedule import make_schedule as j_make_schedule
from dvd_tpu_torch.diffusion import gaussian as G
from dvd_tpu_torch.diffusion import likelihood as L
from dvd_tpu_torch.diffusion.schedule import make_schedule
from test_torch_common import (SRC, S, mini_dit_port, mini_dit_variables,
                               nchw, t)


def _close(got, want, rtol=1e-6, floor=0.0):
    """Within ``rtol`` of each element and ``rtol * max(floor, max|want|)``
    absolute."""
    want = np.asarray(want)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    if got.ndim == 4 and got.shape != want.shape:     # NCHW vs NHWC
        got = np.transpose(got, (0, 2, 3, 1))
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(floor, np.abs(want).max()))


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(0)
    f = lambda *s: rng.uniform(-0.95, 0.95, s).astype(np.float32)
    x0, xt, px = f(3, 6, 6, 2), f(3, 6, 6, 2), f(3, 6, 6, 2)
    return {"x0": x0, "xt": xt, "pred": 1.3 * px, "t": np.array([0, 1, 2]),
            "eps": rng.randn(3, 6, 6, 2).astype(np.float32)}


def test_elementwise_functions_match_dvd_tpu(inputs):
    rng = np.random.RandomState(1)
    a, b, c, d = (rng.randn(4, 5).astype(np.float32) for _ in range(4))
    _close(L.normal_kl(t(a), t(b), t(c), t(d)),
           jL.normal_kl(a, b, c, d))
    _close(L.normal_kl(t(a), t(b), 0.0, 0.0), jL.normal_kl(a, b, 0.0, 0.0))
    x = np.linspace(-4, 4, 101).astype(np.float32)
    _close(L.approx_standard_normal_cdf(t(x)),
           jL.approx_standard_normal_cdf(jnp.asarray(x)))
    # sigma of 1.4-3.9 buckets and x within one sigma of the mean (the edge
    # buckets included), where a bucket holds 10-50% of the mass: in f32 a
    # difference of two CDFs is relative rounding of eps / mass, and in the
    # tails it is all rounding
    xs = np.linspace(-1, 1, 256).astype(np.float32)
    ls = (rng.rand(256) - 4.5).astype(np.float32)
    m = (xs + np.exp(ls) * rng.uniform(-1, 1, 256)).astype(np.float32)
    _close(L.discretized_gaussian_log_likelihood(t(xs), means=t(m),
                                                 log_scales=t(ls)),
           jL.discretized_gaussian_log_likelihood(
               jnp.asarray(xs), means=jnp.asarray(m),
               log_scales=jnp.asarray(ls)))
    _close(L.mean_flat(nchw(inputs["x0"])), jL.mean_flat(inputs["x0"]))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_schedule_functions_match_dvd_tpu(inputs, dtype):
    """Within 1e-6, but for the decoder NLL (vb at t == 0) in f32: there
    each pixel's likelihood is a bucket of 0.0078 under a Gaussian of
    sigma 0.48, a difference of two CDFs near 0.5 that keeps a few
    hundredths of their bits, so f32 rounding alone moves it by ~1e-5 of
    itself (held within 2e-4 of the batch's max); float64 holds it to
    1e-6 too."""
    with jax.enable_x64(dtype == "float64"):
        _schedule_functions(inputs, dtype)


def _schedule_functions(inputs, dtype):
    js, ps = j_make_schedule(steps=3), make_schedule(steps=3)
    if dtype == "float64":
        js = type(js)(**{k: jnp.asarray(np.asarray(v), jnp.float64)
                         if hasattr(v, "shape") else v
                         for k, v in vars(js).items()})
        ps = type(ps)(**{k: v.double() if torch.is_tensor(v)
                         and v.is_floating_point() else v
                         for k, v in vars(ps).items()})
        inputs = {k: v.astype(np.float64) if v.dtype == np.float32 else v
                  for k, v in inputs.items()}
    x0, xt, pred = (_nchw(inputs[k]) for k in ("x0", "xt", "pred"))
    tt = torch.from_numpy(inputs["t"])
    jt = jnp.asarray(inputs["t"])
    _close(G.q_posterior_mean(ps, x0, xt, tt),
           jG.q_posterior_mean(js, inputs["x0"], inputs["xt"], jt))
    _close(G.predict_xstart_from_eps(ps, xt, tt, _nchw(inputs["eps"])),
           jG.predict_xstart_from_eps(js, inputs["xt"], jt, inputs["eps"]))
    for clip in (True, False):
        got = L.p_mean_variance_from_xstart(ps, xt, tt, pred,
                                            clip_denoised=clip)
        want = jL.p_mean_variance_from_xstart(js, inputs["xt"], jt,
                                              inputs["pred"],
                                              clip_denoised=clip)
        for g, w in zip(got, want):
            _close(g, w)
        got = L.vb_terms_bpd(ps, x0, xt, tt, pred, clip_denoised=clip)
        want = jL.vb_terms_bpd(js, inputs["x0"], inputs["xt"], jt,
                               inputs["pred"], clip_denoised=clip)
        out, jout = got["output"], np.asarray(want["output"])
        if dtype == "float32":       # t = 0, 1, 2: the NLL at row 0
            assert abs(out[0].item() - jout[0]) <= 2e-4 * np.abs(jout).max()
            out, jout = out[1:], jout[1:]
        _close(out, jout)
        _close(got["pred_xstart"], want["pred_xstart"])
    _close(L.prior_bpd(ps, x0), jL.prior_bpd(js, inputs["x0"]))


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x,
                                                              (0, 3, 1, 2))))


def _pinned_noise(rng, shape, T=3):
    """dvd_tpu's calc_bpd_loop draws, by timestep, as the port's pin."""
    return torch.stack([nchw(np.asarray(jax.random.normal(
        jax.random.fold_in(rng, ti), shape))) for ti in range(T)])


def _check_bpd(got, want, rtol):
    """Every key within ``rtol`` x max(1, max|ref|): the perfect
    denoiser's MSEs are rounding about zero (~1e-14)."""
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == tuple(np.shape(want[k])), k
        _close(got[k], want[k], rtol, floor=1.0)


def test_bpd_loop_perfect_denoiser_matches_dvd_tpu(inputs):
    x0 = inputs["x0"]
    rng = jax.random.PRNGKey(4)
    want = jL.calc_bpd_loop(lambda x_t, tt: jnp.asarray(x0),
                            j_make_schedule(steps=3), jnp.asarray(x0), rng)
    got = L.calc_bpd_loop(lambda x_t, tt: nchw(x0), make_schedule(steps=3),
                          nchw(x0), None,
                          noise=_pinned_noise(rng, x0.shape))
    _check_bpd(got, want, 1e-6)
    assert float(got["xstart_mse"].abs().max()) == 0.0


def test_bpd_loop_dit_mini_matches_dvd_tpu(monkeypatch):
    """DiT-mini as the denoiser (conditioning from a seed, zero init
    flow): every key within 1e-3 of its max|ref|."""
    test_torch_common.no_flax_dropout(monkeypatch)
    mod, v = mini_dit_variables()
    net = mini_dit_port(v)
    rng = np.random.RandomState(2)
    b = 2
    cond = {"y512": rng.rand(b, SRC, SRC, 3).astype(np.float32),
            "mask_cat": np.ones((b, SRC, SRC, 1), np.float32),
            "mask_y512": (0.1 * rng.randn(b, S, S, 384)).astype(np.float32),
            "line_msk": (0.1 * rng.randn(b, S, S, 64)).astype(np.float32)}
    x0 = test_torch_common.smooth_field(rng, b, S, 0.3)
    zf = np.zeros((b, S, S, 2), np.float32)
    sched, jsched = make_schedule(steps=3), j_make_schedule(steps=3)

    def jfn(x_t, tt):
        return mod.apply(v, x_t, jG.model_t(jsched, tt),
                         init_flow=jnp.asarray(zf),
                         **{k: jnp.asarray(c) for k, c in cond.items()})[0]

    pcond = {k: nchw(c) for k, c in cond.items()}

    def pfn(x_t, tt):
        with torch.no_grad():
            out = net(x_t.permute(0, 2, 3, 1), G.model_t(sched, tt),
                      init_flow=t(zf), **pcond)[0]
        return out.permute(0, 3, 1, 2)

    key = jax.random.PRNGKey(7)
    want = jL.calc_bpd_loop(jfn, jsched, jnp.asarray(x0), key)
    got = L.calc_bpd_loop(pfn, sched, nchw(x0), None,
                          noise=_pinned_noise(key, x0.shape))
    assert float(np.abs(np.asarray(want["xstart_mse"])).max()) > 1e-3
    for k in want:
        w = np.asarray(want[k])
        g = got[k].numpy()
        assert np.abs(g - w).max() <= 1e-3 * np.abs(w).max(), k


def test_exported_as_dvd_tpu_exports_it():
    import dvd_tpu.diffusion as jD
    import dvd_tpu_torch.diffusion as D

    assert set(D.__all__) == set(jD.__all__)
    assert D.calc_bpd_loop is L.calc_bpd_loop


# ------------------------------- tests/test_likelihood.py's analytic cases
def test_normal_kl_analytic():
    m1, s1, m2, s2 = 0.3, 1.7, -0.5, 0.9
    want = np.log(s2 / s1) + (s1 ** 2 + (m1 - m2) ** 2) / (2 * s2 ** 2) - 0.5
    got = L.normal_kl(torch.tensor(m1), torch.tensor(2 * np.log(s1)),
                      torch.tensor(m2), torch.tensor(2 * np.log(s2)))
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    assert float(L.normal_kl(1.0, 0.3, 1.0, 0.3)) == pytest.approx(0.0)


def test_discretized_gaussian_vs_scipy():
    xs = np.linspace(-1, 1, 256)
    mean, std = 0.1, 0.25
    got = L.discretized_gaussian_log_likelihood(
        torch.tensor(xs), means=torch.tensor(mean),
        log_scales=torch.tensor(np.log(std))).numpy()
    want = np.log(stats.norm.cdf(xs + 1 / 255, mean, std)
                  - stats.norm.cdf(xs - 1 / 255, mean, std))
    interior = (xs > -0.999) & (xs < 0.999)
    np.testing.assert_allclose(np.exp(got[interior]), np.exp(want[interior]),
                               atol=1e-4)
    bulk = interior & (want > -5)
    np.testing.assert_allclose(got[bulk], want[bulk], atol=5e-2)
    assert 0.98 < np.exp(got).sum() < 1.02


def test_vb_terms_perfect_model_small_kl():
    sched = make_schedule(steps=3)
    rng = np.random.RandomState(0)
    x0 = torch.from_numpy(rng.uniform(-0.9, 0.9, (2, 2, 8, 8))
                          .astype(np.float32))
    tt = torch.tensor([1, 2])
    x_t = G.q_sample(sched, x0, tt, torch.from_numpy(
        rng.randn(2, 2, 8, 8).astype(np.float32)))
    out = L.vb_terms_bpd(sched, x0, x_t, tt, x0)
    assert out["output"].shape == (2,)
    assert torch.isfinite(out["output"]).all()
    worse = L.vb_terms_bpd(sched, x0, x_t, tt, -x0)
    assert (worse["output"] > out["output"]).all()


def test_bpd_loop_shapes_and_ordering():
    sched = make_schedule(steps=3)
    x0 = torch.from_numpy(np.random.RandomState(2).uniform(
        -0.9, 0.9, (2, 2, 8, 8)).astype(np.float32))
    out = L.calc_bpd_loop(lambda x_t, tt: x0, sched, x0,
                          torch.Generator().manual_seed(0))
    assert out["vb"].shape == out["xstart_mse"].shape == (3, 2)
    assert out["total_bpd"].shape == (2,)
    assert float(out["xstart_mse"].abs().max()) == 0.0
    np.testing.assert_allclose(out["total_bpd"].numpy(),
                               (out["vb"].sum(0) + out["prior_bpd"]).numpy(),
                               rtol=1e-6)


def test_prior_bpd_near_zero_for_heavy_noise():
    sched = make_schedule(steps=1000)
    assert float(L.prior_bpd(sched, torch.full((1, 2, 4, 4), 0.5))[0]) < 1e-3


def test_mean_flat():
    x = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
    np.testing.assert_allclose(L.mean_flat(x).numpy(),
                               x.reshape(2, -1).mean(-1).numpy())
