"""GEM property tests (SURVEY.md §4): monotonicity, conservation, recovery."""
import numpy as np
import jax
import jax.numpy as jnp
from jax import enable_x64

from pyfasst_jax.models.components import FasstParams, SpatialComp, SpectralComp
from pyfasst_jax.ops.gem import annealing_endpoints, run_gem
from pyfasst_jax.ops.wiener import separate_sources
from pyfasst_jax.utils.config import GEMConfig


def _problem(rng, F=33, N=48, J=2, K=3):
    X = (rng.standard_normal((F, N, 2)) + 1j * rng.standard_normal((F, N, 2)))
    spat = tuple(SpatialComp(A=jnp.asarray(np.abs(rng.standard_normal((2, 1)))
                                           + 0.3)) for _ in range(J))
    spec = tuple(SpectralComp(FB=jnp.asarray(0.5 + rng.random((F, K))),
                              TW=jnp.asarray(0.5 + rng.random((K, N))),
                              spat_ind=j) for j in range(J))
    return X, FasstParams(spat=spat, spec=spec)


def test_loglik_monotone_no_ann(rng):
    """With a fixed noise PSD, GEM must not decrease the log-likelihood."""
    with enable_x64():
        X, params = _problem(rng)
        cfg = GEMConfig(niter=30, annealing="no_ann")
        Xj = jnp.asarray(X)
        _, ll = jax.block_until_ready(run_gem(params, Xj, cfg))
        ll = np.asarray(ll)
        diffs = np.diff(ll)
        tol = 1e-9 * np.abs(ll).max()
        assert np.all(diffs >= -tol), diffs.min()


def test_separation_conserves_mixture(rng):
    """Sum of Wiener posterior images ~= mixture as Sigma_b -> 0."""
    with enable_x64():
        X, params = _problem(rng)
        cfg = GEMConfig(niter=10)
        Xj = jnp.asarray(X)
        params, _ = run_gem(params, Xj, cfg)
        _, sigma1 = annealing_endpoints(Xj, cfg)
        Y = np.asarray(separate_sources(params, Xj, sigma1))
        recon = Y.sum(axis=0)
        rel = np.linalg.norm(recon - X) / np.linalg.norm(X)
        assert rel < 1e-4, rel


def test_recovers_panned_sources(rng):
    """Two spectrally-distinct sources panned to different stereo directions
    must come back with sensible SDR (BASELINE.json configs[0] in miniature)."""
    F, N = 65, 80
    # source 1: low-band harmonic-ish; source 2: high-band noise
    S1 = np.zeros((F, N), complex)
    S1[4:12] = (rng.standard_normal((8, N)) + 1j * rng.standard_normal((8, N))) * 3
    S2 = np.zeros((F, N), complex)
    S2[40:60] = rng.standard_normal((20, N)) + 1j * rng.standard_normal((20, N))
    a1, a2 = np.array([0.95, 0.31]), np.array([0.31, 0.95])
    X = S1[..., None] * a1 + S2[..., None] * a2          # (F, N, 2)
    Y_true = np.stack([S1[..., None] * a1, S2[..., None] * a2])

    spat = tuple(SpatialComp(A=jnp.asarray(np.abs(
        rng.standard_normal((2, 1))) + 0.5, jnp.float32)) for _ in range(2))
    spec = tuple(SpectralComp(
        FB=jnp.asarray(0.5 + rng.random((F, 4)), jnp.float32),
        TW=jnp.asarray(0.5 + rng.random((4, N)), jnp.float32),
        spat_ind=j) for j in range(2))
    params = FasstParams(spat=spat, spec=spec)

    Xj = jnp.asarray(X, jnp.complex64)
    cfg = GEMConfig(niter=100)
    params, ll = jax.block_until_ready(run_gem(params, Xj, cfg))
    _, sigma1 = annealing_endpoints(Xj, cfg)
    Y = np.asarray(separate_sources(params, Xj, sigma1))

    # permutation-invariant SDR in the TF domain
    def sdr(est, ref):
        return 10 * np.log10(np.sum(np.abs(ref) ** 2)
                             / max(np.sum(np.abs(est - ref) ** 2), 1e-12))

    perms = [(0, 1), (1, 0)]
    best = max(min(sdr(Y[p[0]], Y_true[0]), sdr(Y[p[1]], Y_true[1]))
               for p in perms)
    assert best > 10.0, f"SDR too low: {best:.2f} dB"


def test_nmf_updates_nonincrease_is_divergence(rng):
    """SURVEY.md §4 unit row: the multiplicative IS-NMF factor updates must
    not increase IS(P, V) on random data -- including the 4-factor
    FB.FW.TW.TB chain."""
    from pyfasst_jax.models.components import SpectralComp
    from pyfasst_jax.ops.mstep import _nmf_factor_updates
    from pyfasst_jax.utils.signal import is_distortion

    F, N, L, K, M = 21, 34, 6, 4, 12
    P = jnp.asarray(0.1 + rng.random((F, N)), jnp.float32)

    comp = SpectralComp(
        FB=jnp.asarray(0.5 + rng.random((F, L)), jnp.float32),
        FW=jnp.asarray(0.5 + rng.random((L, K)), jnp.float32),
        TW=jnp.asarray(0.5 + rng.random((K, M)), jnp.float32),
        TB=jnp.asarray(0.5 + rng.random((M, N)), jnp.float32),
        free=(True, True, True, True), spat_ind=0)
    V = comp.power()
    d0 = float(is_distortion(P, V))
    d = d0
    for _ in range(12):
        comp, V = _nmf_factor_updates(comp, P, V, eps=1e-30)
        d_new = float(is_distortion(P, V))
        assert d_new <= d * (1 + 1e-4), (d, d_new)
        d = d_new
    assert d < 0.5 * d0    # actually makes progress, not just holds still
