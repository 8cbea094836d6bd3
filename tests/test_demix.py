"""DEMIX blind mixing-estimation tests (reference parity: pyfasst/demixTF.py)."""
import numpy as np

from pyfasst_jax.models.demix import DEMIX, local_directions


def _anechoic(F, g, d):
    f = np.arange(F)
    return np.stack([np.ones(F), g * np.exp(-1j * np.pi * f * d / (F - 1))],
                    axis=1)


def _mixture(rng, F=65, N=96, gains=(0.4, 1.0, 2.0), delays=(-3.0, 0.5, 2.5),
             bands=((2, 14), (20, 34), (42, 60))):
    X = 0
    for g, d, (lo, hi) in zip(gains, delays, bands):
        s = np.zeros((F, N), complex)
        s[lo:hi] = (rng.standard_normal((hi - lo, N))
                    + 1j * rng.standard_normal((hi - lo, N)))
        X = X + _anechoic(F, g, d)[:, None, :] * s[..., None]
    return X


def test_local_directions_single_source(rng):
    F, N = 33, 64
    g, d = 0.7, 1.5
    s = rng.standard_normal((F, N)) + 1j * rng.standard_normal((F, N))
    X = _anechoic(F, g, d)[:, None, :] * s[..., None]
    u, conf, lam1 = local_directions(X)
    g_est = np.abs(u[5:-5, :, 1]) / np.abs(u[5:-5, :, 0])
    assert abs(np.median(g_est) - g) < 0.05
    assert np.median(conf[5:-5]) > 50


def test_demix_recovers_gains_and_delays(rng):
    gains, delays = (0.4, 1.0, 2.0), (-3.0, 0.5, 2.5)
    X = _mixture(rng, gains=gains, delays=delays)
    dm = DEMIX(X=X)
    g, d = dm.comp_parameters(3)
    order = np.argsort(g)
    np.testing.assert_allclose(np.sort(g), sorted(gains), rtol=0.12)
    true_d = [delays[i] for i in np.argsort(gains)]
    assert np.max(np.abs(d[order] - true_d)) < 0.8

    A = dm.mixing(65)
    assert A.shape == (3, 65, 2, 1)
    # unit reference channel
    np.testing.assert_allclose(np.abs(A[:, :, 0, 0]), 1.0, atol=1e-6)


def test_demix_estimates_source_count(rng):
    X3 = _mixture(rng)                      # 3 well-separated sources
    assert DEMIX(X=X3).estimate_count() == 3
    X2 = _mixture(rng, gains=(0.4, 2.0), delays=(-3.0, 2.5),
                  bands=((2, 20), (36, 60)))
    assert DEMIX(X=X2).estimate_count() == 2
    g, d = DEMIX(X=X2).comp_parameters()    # K=None -> auto
    assert len(g) == 2


def test_demix_count_on_unequal_mixtures(rng):
    """BIC count estimation survives strongly unequal bin shares/loudness
    (the round-1 elbow rule was documented biased-low here)."""
    # unequal BIN COUNT: 36 rows vs 10 vs 8
    Xb = _mixture(rng, gains=(0.4, 1.0, 2.0), delays=(-3.0, 0.5, 2.5),
                  bands=((2, 38), (42, 52), (55, 63)))
    assert DEMIX(X=Xb).estimate_count() == 3
    # unequal LOUDNESS: two sources 10x quieter than the first
    F, N = 65, 96
    X = 0
    for amp, g, d, (lo, hi) in zip(
            (1.0, 0.1, 0.1), (0.4, 1.0, 2.0), (-3.0, 0.5, 2.5),
            ((2, 22), (24, 42), (44, 62))):
        s = np.zeros((F, N), complex)
        s[lo:hi] = amp * (rng.standard_normal((hi - lo, N))
                          + 1j * rng.standard_normal((hi - lo, N)))
        X = X + _anechoic(F, g, d)[:, None, :] * s[..., None]
    assert DEMIX(X=X).estimate_count() == 3


def test_refine_parameters_subsample_accuracy(rng):
    """The sub-sample refinement must land delays within ~0.15 samples
    (a ~1-sample error in the EM seed collapses conv separation -- see
    comp_parameters docstring)."""
    F, N = 129, 220
    gains = [0.6, 1.5]
    delays = [-2.3, 3.7]
    X = np.zeros((F, N, 2), complex)
    for j, (g, d) in enumerate(zip(gains, delays)):
        s = np.zeros((F, N), complex)
        sl = slice(4 + 50 * j, 54 + 50 * j)         # disjoint-ish bands
        s[sl] = rng.standard_normal((50, N)) + 1j * rng.standard_normal(
            (50, N))
        a = np.stack([np.ones(F), g * np.exp(
            -1j * np.pi * np.arange(F) * d / (F - 1))], 1)
        X += a[:, None, :] * s[..., None]
    dm = DEMIX(X=X)
    g_est, d_est = dm.comp_parameters(K=2)
    order = np.argsort(d_est)
    ref = np.argsort(delays)
    for i, k in zip(order, ref):
        assert abs(d_est[i] - delays[k]) < 0.15, (d_est, delays)
        assert abs(g_est[i] / gains[k] - 1.0) < 0.1, (g_est, gains)
