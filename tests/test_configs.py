"""Miniature integration tests of the BASELINE.json acceptance configs.

configs[0] (instantaneous NMF) is covered by test_em_properties; configs[3]
(HMM/GSMM) by test_hmm; configs[4] (batch/sharded) by test_sharding. Here:
configs[1] anechoic convolutive rank-1 (+ ERB fixed basis) and configs[2]
reverberant full-rank spatial covariances.
"""
import numpy as np
import jax
import jax.numpy as jnp

from pyfasst_jax.models.components import (
    CONV, FasstParams, SpatialComp, SpectralComp,
)
from pyfasst_jax.ops.gem import annealing_endpoints, run_gem
from pyfasst_jax.ops.wiener import separate_sources
from pyfasst_jax.tf.filterbank import spectral_basis
from pyfasst_jax.utils.config import GEMConfig


def _sdr(est, ref):
    return 10 * np.log10(np.sum(np.abs(ref) ** 2)
                         / max(np.sum(np.abs(est - ref) ** 2), 1e-12))


def _best_perm_sdr(Y, Y_true):
    import itertools
    J = Y_true.shape[0]
    return max(min(_sdr(Y[p[j]], Y_true[j]) for j in range(J))
               for p in itertools.permutations(range(J)))


def _anechoic_mixing(F, gains, delays):
    """a_j(f) = [1, g e^{-2 pi i f delta / (2(F-1))}] (delay in samples)."""
    f = np.arange(F)
    A = np.stack([np.ones(F), gains * np.exp(-1j * np.pi * f * delays
                                             / (F - 1))], axis=1)
    return A[..., None]  # (F, 2, 1)


def test_conv_anechoic_three_sources(rng):
    """configs[1]: anechoic convolutive stereo, 3 sources, rank-1 + ERB FB."""
    F, N, J = 65, 96, 3
    gains = [0.4, 1.0, 2.0]
    delays = [-3.0, 0.5, 2.5]
    bands = [(2, 14), (20, 34), (42, 60)]
    A_true = [_anechoic_mixing(F, g, d) for g, d in zip(gains, delays)]
    S, Y_true, X = [], [], 0.0
    for j in range(J):
        s = np.zeros((F, N), complex)
        lo, hi = bands[j]
        s[lo:hi] = (rng.standard_normal((hi - lo, N))
                    + 1j * rng.standard_normal((hi - lo, N)))
        img = A_true[j][:, :, 0][:, None, :] * s[..., None]
        Y_true.append(img)
        X = X + img
    Y_true = np.stack(Y_true)

    # ERB fixed frequency basis (BASELINE configs[1] front-end)
    FB_erb = spectral_basis("erb", 24, F, 16000, (F - 1) * 2)
    # DEMIX initialization (the reference's intended flow for conv models)
    from pyfasst_jax.models.demix import DEMIX
    dm = DEMIX(X=X)
    dm.comp_parameters(J)
    A0 = dm.mixing(F)
    spat = tuple(SpatialComp(A=jnp.asarray(A0[j], jnp.complex64),
                             mix_type=CONV) for j in range(J))
    spec = tuple(SpectralComp(
        FB=jnp.asarray(FB_erb, jnp.float32),
        FW=jnp.asarray(0.5 + rng.random((FB_erb.shape[1], 4)), jnp.float32),
        TW=jnp.asarray(0.5 + rng.random((4, N)), jnp.float32),
        spat_ind=j, free=(False, True, True, False)) for j in range(J))
    params = FasstParams(spat=spat, spec=spec)

    Xj = jnp.asarray(X, jnp.complex64)
    cfg = GEMConfig(niter=120)
    params, ll = jax.block_until_ready(run_gem(params, Xj, cfg))
    assert bool(jnp.all(jnp.isfinite(ll)))
    _, sigma1 = annealing_endpoints(Xj, cfg)
    Y = np.asarray(separate_sources(params, Xj, sigma1))
    best = _best_perm_sdr(Y, Y_true)
    assert best > 8.0, f"conv separation SDR too low: {best:.2f} dB"


def test_full_rank_reverberant_underdetermined(rng):
    """configs[2]: full-rank spatial covariances, 4 sources, stereo
    (underdetermined J > I), diffuse-ish images."""
    F, N, J = 49, 80, 4
    bands = [(2, 10), (14, 24), (28, 36), (38, 46)]
    angles = np.linspace(0.2, 1.35, J)
    Y_true, X = [], 0.0
    for j in range(J):
        lo, hi = bands[j]
        s = np.zeros((F, N), complex)
        s[lo:hi] = (rng.standard_normal((hi - lo, N))
                    + 1j * rng.standard_normal((hi - lo, N)))
        a = np.array([np.cos(angles[j]), np.sin(angles[j])])
        # small frequency-dependent perturbation simulates reverberant
        # full-rank spreading around the main direction
        perturb = 0.15 * (rng.standard_normal((F, 2))
                          + 1j * rng.standard_normal((F, 2)))
        mix_vec = a[None, :] + perturb                     # (F, 2)
        img = mix_vec[:, None, :] * s[..., None]
        Y_true.append(img)
        X = X + img
    Y_true = np.stack(Y_true)

    spat = []
    for j in range(J):
        a = np.array([np.cos(angles[j]), np.sin(angles[j])])
        A0 = np.stack([a, 0.3 * np.array([-a[1], a[0]])], axis=1)  # (2, 2)
        A0 = np.tile(A0[None], (F, 1, 1)).astype(np.complex64)
        spat.append(SpatialComp(A=jnp.asarray(A0), mix_type=CONV))
    spec = tuple(SpectralComp(
        FB=jnp.asarray(0.5 + rng.random((F, 3)), jnp.float32),
        TW=jnp.asarray(0.5 + rng.random((3, N)), jnp.float32),
        spat_ind=j) for j in range(J))
    params = FasstParams(spat=tuple(spat), spec=spec)

    Xj = jnp.asarray(X, jnp.complex64)
    cfg = GEMConfig(niter=120)
    params, ll = jax.block_until_ready(run_gem(params, Xj, cfg))
    assert bool(jnp.all(jnp.isfinite(ll)))
    assert params.spat[0].rank == 2
    _, sigma1 = annealing_endpoints(Xj, cfg)
    Y = np.asarray(separate_sources(params, Xj, sigma1))
    best = _best_perm_sdr(Y, Y_true)
    # 4 sources / 2 channels with strongly perturbed (rank-2) mixing: ~3 dB
    # is in line with SiSEC-style underdetermined results; the assert guards
    # against collapse, not against the physics of J > I separation.
    assert best > 2.5, f"full-rank separation SDR too low: {best:.2f} dB"
