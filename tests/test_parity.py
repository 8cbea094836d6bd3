"""GEM engine parity vs the float64 NumPy oracle (SURVEY.md §4).

The oracle (tests/oracle) stands in for the reference while /root/reference
is empty. In x64 mode the JAX engine and the oracle implement identical
arithmetic (same eps, floors, schedule, update order), so agreement to ~1e-6
relative after 10 full GEM iterations is the pass bar ("bit-level parity on
the CPU path" in BASELINE.json -- up to associativity-of-summation noise).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax import enable_x64

from pyfasst_jax.models.components import (
    FasstParams, SpatialComp, SpectralComp,
)
from pyfasst_jax.ops.gem import run_gem
from pyfasst_jax.utils.config import GEMConfig
from tests.oracle import oracle_gem_run, oracle_separate, params_from_pytree
from tests.oracle.fasst_oracle import (
    annealing_endpoints as np_annealing_endpoints,
)


def _tiny_problem(rng, F=33, N=40, J=2, K=3, dtype=np.float64,
                  mix_type="inst"):
    X = (rng.standard_normal((F, N, 2)) + 1j * rng.standard_normal((F, N, 2))
         ).astype(np.complex128)
    # spectrally color the two channels so sources are identifiable
    X[:, :, 0] *= np.linspace(0.5, 2.0, F)[:, None]
    spat, spec = [], []
    for j in range(J):
        if mix_type == "inst":
            A = np.abs(rng.standard_normal((2, 1))) + 0.3
        else:
            A = (rng.standard_normal((F, 2, 1))
                 + 1j * rng.standard_normal((F, 2, 1))) * 0.5
        spat.append(SpatialComp(A=jnp.asarray(A), mix_type=mix_type,
                                free=True))
        spec.append(SpectralComp(
            FB=jnp.asarray(0.5 + rng.random((F, K))),
            TW=jnp.asarray(0.5 + rng.random((K, N))),
            spat_ind=j, free=(True, False, True, False)))
    return X, FasstParams(spat=tuple(spat), spec=tuple(spec))


@pytest.mark.parametrize("annealing", ["ann", "no_ann", "ann_ns_inj"])
def test_gem_parity_x64(rng, annealing):
    with enable_x64():
        X, params = _tiny_problem(rng)
        niter = 10
        cfg = GEMConfig(niter=niter, annealing=annealing)
        oparams = params_from_pytree(params)

        Xj = jnp.asarray(X)
        got_params, got_ll = jax.block_until_ready(run_gem(params, Xj, cfg))

        oparams, want_ll = oracle_gem_run(oparams, X, niter,
                                          annealing=annealing)

        np.testing.assert_allclose(np.asarray(got_ll), want_ll, rtol=1e-6)
        for j in range(2):
            np.testing.assert_allclose(np.asarray(got_params.spat[j].A),
                                       oparams.spat[j].A, rtol=1e-5, atol=1e-9)
            np.testing.assert_allclose(np.asarray(got_params.spec[j].FB),
                                       oparams.spec[j].FB, rtol=1e-5, atol=1e-12)
            np.testing.assert_allclose(np.asarray(got_params.spec[j].TW),
                                       oparams.spec[j].TW, rtol=1e-5, atol=1e-12)


def test_gem_parity_conv_x64(rng):
    with enable_x64():
        X, params = _tiny_problem(rng, mix_type="conv")
        cfg = GEMConfig(niter=8)
        oparams = params_from_pytree(params)
        Xj = jnp.asarray(X)
        got_params, got_ll = jax.block_until_ready(run_gem(params, Xj, cfg))
        oparams, want_ll = oracle_gem_run(oparams, X, 8)
        np.testing.assert_allclose(np.asarray(got_ll), want_ll, rtol=1e-6)
        for j in range(2):
            np.testing.assert_allclose(np.asarray(got_params.spat[j].A),
                                       oparams.spat[j].A, rtol=1e-4, atol=1e-8)


def test_separation_parity_x64(rng):
    with enable_x64():
        X, params = _tiny_problem(rng)
        cfg = GEMConfig(niter=5)
        Xj = jnp.asarray(X)
        params2, _ = run_gem(params, Xj, cfg)

        from pyfasst_jax.ops.gem import annealing_endpoints
        from pyfasst_jax.ops.wiener import separate_sources
        _, sigma1 = annealing_endpoints(Xj, cfg)
        got = np.asarray(separate_sources(params2, jnp.asarray(X), sigma1))

        oparams, _ = oracle_gem_run(params_from_pytree(params), X, 5)
        _, osig = np_annealing_endpoints(X, 1e-2, 3e-6)
        want = oracle_separate(oparams, X, osig)
        np.testing.assert_allclose(got, want, rtol=5e-5, atol=1e-6)


def test_f32_tracks_oracle_loosely(rng):
    """The default f32 path should track the f64 oracle to ~1% loglik."""
    X, params = _tiny_problem(rng)
    params = jax.tree.map(
        lambda a: a.astype(jnp.complex64) if jnp.iscomplexobj(a)
        else a.astype(jnp.float32), params)
    cfg = GEMConfig(niter=10)
    Xj = jnp.asarray(X, jnp.complex64)
    _, got_ll = jax.block_until_ready(run_gem(params, Xj, cfg))
    _, want_ll = oracle_gem_run(params_from_pytree(params), X, 10)
    np.testing.assert_allclose(np.asarray(got_ll), want_ll, rtol=1e-2)


def test_gem_parity_fullrank_x64(rng):
    """x64 engine vs oracle for the rank-2 (full-rank) spatial branch
    (configs[2]): exercises ops/estep.py's rank>=2 T4/posterior path and
    the per-frequency rank-2 spatial solve."""
    with enable_x64():
        F, N, K = 21, 18, 3
        X = (rng.standard_normal((F, N, 2))
             + 1j * rng.standard_normal((F, N, 2)))
        X[:, :, 0] *= np.linspace(0.5, 2.0, F)[:, None]
        spat, spec = [], []
        for j in range(2):
            A = (rng.standard_normal((F, 2, 2))
                 + 1j * rng.standard_normal((F, 2, 2))) * 0.5
            spat.append(SpatialComp(A=jnp.asarray(A), mix_type="conv",
                                    free=True))
            spec.append(SpectralComp(
                FB=jnp.asarray(0.5 + rng.random((F, K))),
                TW=jnp.asarray(0.5 + rng.random((K, N))),
                spat_ind=j, free=(True, False, True, False)))
        params = FasstParams(spat=tuple(spat), spec=tuple(spec))
        cfg = GEMConfig(niter=8)
        oparams = params_from_pytree(params)
        got_params, got_ll = jax.block_until_ready(
            run_gem(params, jnp.asarray(X), cfg))
        oparams, want_ll = oracle_gem_run(oparams, X, 8)
        np.testing.assert_allclose(np.asarray(got_ll), want_ll, rtol=1e-6)
        for j in range(2):
            np.testing.assert_allclose(np.asarray(got_params.spat[j].A),
                                       oparams.spat[j].A, rtol=1e-4,
                                       atol=1e-8)
            np.testing.assert_allclose(np.asarray(got_params.spec[j].FB),
                                       oparams.spec[j].FB, rtol=1e-5,
                                       atol=1e-12)


def test_gem_parity_mixed_rank_x64(rng):
    """Mixed rank-1 + rank-2 sources through the same jitted loop."""
    with enable_x64():
        F, N, K = 17, 14, 2
        X = (rng.standard_normal((F, N, 2))
             + 1j * rng.standard_normal((F, N, 2)))
        A1 = (rng.standard_normal((F, 2, 1))
              + 1j * rng.standard_normal((F, 2, 1))) * 0.5
        A2 = (rng.standard_normal((F, 2, 2))
              + 1j * rng.standard_normal((F, 2, 2))) * 0.5
        spat = (SpatialComp(A=jnp.asarray(A1), mix_type="conv", free=True),
                SpatialComp(A=jnp.asarray(A2), mix_type="conv", free=True))
        spec = tuple(SpectralComp(FB=jnp.asarray(0.5 + rng.random((F, K))),
                                  TW=jnp.asarray(0.5 + rng.random((K, N))),
                                  spat_ind=j) for j in range(2))
        params = FasstParams(spat=spat, spec=spec)
        cfg = GEMConfig(niter=8)
        oparams = params_from_pytree(params)
        got_params, got_ll = jax.block_until_ready(
            run_gem(params, jnp.asarray(X), cfg))
        oparams, want_ll = oracle_gem_run(oparams, X, 8)
        np.testing.assert_allclose(np.asarray(got_ll), want_ll, rtol=1e-6)


def test_gem_parity_simm_x64(rng):
    """x64 engine vs oracle for the multiplicative source-filter chain
    (multiChanSourceF0Filter's lead component: fixed WF0/WGAMMA bases,
    free TW + free TW2 smooth-filter activations)."""
    with enable_x64():
        F, N, K0, Kg, Knmf = 25, 20, 5, 4, 3
        X = (rng.standard_normal((F, N, 2))
             + 1j * rng.standard_normal((F, N, 2)))
        X[:, :, 0] *= np.linspace(0.6, 1.8, F)[:, None]
        spat = (SpatialComp(A=jnp.asarray([[0.9], [0.4]])),
                SpatialComp(A=jnp.asarray([[0.3], [0.8]])))
        lead = SpectralComp(
            FB=jnp.asarray(0.5 + rng.random((F, K0))),
            TW=jnp.asarray(0.5 + rng.random((K0, N))),
            FB2=jnp.asarray(0.5 + rng.random((F, Kg))),
            TW2=jnp.asarray(0.5 + rng.random((Kg, N))),
            spat_ind=0, free=(False, False, True, False),
            free2=(False, True))
        acc = SpectralComp(FB=jnp.asarray(0.5 + rng.random((F, Knmf))),
                           TW=jnp.asarray(0.5 + rng.random((Knmf, N))),
                           spat_ind=1)
        params = FasstParams(spat=spat, spec=(lead, acc))
        cfg = GEMConfig(niter=8)
        oparams = params_from_pytree(params)
        got_params, got_ll = jax.block_until_ready(
            run_gem(params, jnp.asarray(X), cfg))
        oparams, want_ll = oracle_gem_run(oparams, X, 8)
        np.testing.assert_allclose(np.asarray(got_ll), want_ll, rtol=1e-6)
        np.testing.assert_allclose(np.asarray(got_params.spec[0].TW),
                                   oparams.spec[0].TW, rtol=1e-5, atol=1e-12)
        np.testing.assert_allclose(np.asarray(got_params.spec[0].TW2),
                                   oparams.spec[0].TW2, rtol=1e-5, atol=1e-12)
        np.testing.assert_allclose(np.asarray(got_params.spec[1].FB),
                                   oparams.spec[1].FB, rtol=1e-5, atol=1e-12)


def test_gem_parity_simm_free_bases_x64(rng):
    """SIMM chain with every factor free (exercises the FB and FB2 update
    rules and the renormalization fallback to the second chain)."""
    with enable_x64():
        F, N, K0, Kg = 19, 16, 3, 2
        X = (rng.standard_normal((F, N, 2))
             + 1j * rng.standard_normal((F, N, 2)))
        spat = (SpatialComp(A=jnp.asarray([[0.8], [0.5]])),)
        lead = SpectralComp(
            FB=jnp.asarray(0.5 + rng.random((F, K0))),
            TW=jnp.asarray(0.5 + rng.random((K0, N))),
            FB2=jnp.asarray(0.5 + rng.random((F, Kg))),
            TW2=jnp.asarray(0.5 + rng.random((Kg, N))),
            spat_ind=0, free=(True, False, True, False),
            free2=(True, True))
        params = FasstParams(spat=spat, spec=(lead,))
        cfg = GEMConfig(niter=8)
        oparams = params_from_pytree(params)
        got_params, got_ll = jax.block_until_ready(
            run_gem(params, jnp.asarray(X), cfg))
        oparams, want_ll = oracle_gem_run(oparams, X, 8)
        np.testing.assert_allclose(np.asarray(got_ll), want_ll, rtol=1e-6)
        for name in ("FB", "TW", "FB2", "TW2"):
            np.testing.assert_allclose(
                np.asarray(getattr(got_params.spec[0], name)),
                getattr(oparams.spec[0], name), rtol=1e-5, atol=1e-12)


def _tiny_problem_i3(rng, F=19, N=16, K=2, mix_type="inst", ranks=(1, 1)):
    """General-I fixture (I=3): exercises ops/engine_general.py."""
    I = 3
    X = (rng.standard_normal((F, N, I)) + 1j * rng.standard_normal((F, N, I))
         ).astype(np.complex128)
    X[:, :, 0] *= np.linspace(0.5, 2.0, F)[:, None]
    spat, spec = [], []
    for j, R in enumerate(ranks):
        if mix_type == "inst":
            A = np.abs(rng.standard_normal((I, R))) + 0.3
        else:
            A = (rng.standard_normal((F, I, R))
                 + 1j * rng.standard_normal((F, I, R))) * 0.5
        spat.append(SpatialComp(A=jnp.asarray(A), mix_type=mix_type,
                                free=True))
        spec.append(SpectralComp(
            FB=jnp.asarray(0.5 + rng.random((F, K))),
            TW=jnp.asarray(0.5 + rng.random((K, N))),
            spat_ind=j, free=(True, False, True, False)))
    return X, FasstParams(spat=tuple(spat), spec=tuple(spec))


@pytest.mark.parametrize("annealing", ["ann", "ann_ns_inj"])
def test_gem_parity_i3_inst_x64(rng, annealing):
    """x64 engine vs oracle at I=3 channels (instantaneous rank-1 sources):
    the general unrolled-Cholesky E-step (ops/engine_general.py) against the
    np.linalg general-I oracle branch, incl. the noise-injection
    corrections."""
    with enable_x64():
        X, params = _tiny_problem_i3(rng)
        niter = 8
        cfg = GEMConfig(niter=niter, annealing=annealing)
        oparams = params_from_pytree(params)
        got_params, got_ll = jax.block_until_ready(
            run_gem(params, jnp.asarray(X), cfg))
        oparams, want_ll = oracle_gem_run(oparams, X, niter,
                                          annealing=annealing)
        np.testing.assert_allclose(np.asarray(got_ll), want_ll, rtol=1e-6)
        for j in range(2):
            np.testing.assert_allclose(np.asarray(got_params.spat[j].A),
                                       oparams.spat[j].A, rtol=1e-5,
                                       atol=1e-9)
            np.testing.assert_allclose(np.asarray(got_params.spec[j].FB),
                                       oparams.spec[j].FB, rtol=1e-5,
                                       atol=1e-12)


def test_gem_parity_i3_conv_mixed_rank_x64(rng):
    """I=3 convolutive with mixed ranks incl. a full-rank (R=3) source:
    exercises the general engine's R x R Woodbury posterior, the (F, R, R)
    T4 passthrough in ops/mstep.py, and the per-frequency I=3 spatial
    solve."""
    with enable_x64():
        X, params = _tiny_problem_i3(rng, mix_type="conv", ranks=(1, 3))
        cfg = GEMConfig(niter=8)
        oparams = params_from_pytree(params)
        got_params, got_ll = jax.block_until_ready(
            run_gem(params, jnp.asarray(X), cfg))
        oparams, want_ll = oracle_gem_run(oparams, X, 8)
        np.testing.assert_allclose(np.asarray(got_ll), want_ll, rtol=1e-6)
        for j in range(2):
            np.testing.assert_allclose(np.asarray(got_params.spat[j].A),
                                       oparams.spat[j].A, rtol=1e-4,
                                       atol=1e-8)


def test_separation_parity_i3_x64(rng):
    """Wiener separation at I=3 vs the general-I oracle, plus the
    mixture-conservation property sum_j y_j ~ x away from the noise floor."""
    with enable_x64():
        X, params = _tiny_problem_i3(rng)
        cfg = GEMConfig(niter=5)
        Xj = jnp.asarray(X)
        params2, _ = run_gem(params, Xj, cfg)

        from pyfasst_jax.ops.gem import annealing_endpoints
        from pyfasst_jax.ops.wiener import separate_sources
        _, sigma1 = annealing_endpoints(Xj, cfg)
        got = np.asarray(separate_sources(params2, Xj, sigma1))

        oparams, _ = oracle_gem_run(params_from_pytree(params), X, 5)
        _, osig = np_annealing_endpoints(X, 1e-2, 3e-6)
        want = oracle_separate(oparams, X, osig)
        np.testing.assert_allclose(got, want, rtol=5e-5, atol=1e-6)


@pytest.mark.parametrize("constraint", ["GMM", "HMM"])
def test_gem_parity_state_models_x64(rng, constraint):
    """x64 engine vs oracle for the GSMM/HMM spectral E-step (configs[3])."""
    with enable_x64():
        F, N, Q = 21, 18, 3
        X = (rng.standard_normal((F, N, 2))
             + 1j * rng.standard_normal((F, N, 2)))
        trans = (np.full(Q, 1.0 / Q) if constraint == "GMM"
                 else 0.8 * np.eye(Q) + 0.1 * (1 - np.eye(Q)))
        spat = (SpatialComp(A=jnp.asarray([[0.9], [0.4]])),
                SpatialComp(A=jnp.asarray([[0.4], [0.9]])))
        spec = (SpectralComp(FB=jnp.asarray(0.5 + rng.random((F, Q))),
                             TW=jnp.asarray(0.5 + rng.random((Q, N))),
                             trans=jnp.asarray(trans), spat_ind=0,
                             free=(True, False, True, False),
                             constraint=constraint),
                SpectralComp(FB=jnp.asarray(0.5 + rng.random((F, 2))),
                             TW=jnp.asarray(0.5 + rng.random((2, N))),
                             spat_ind=1))
        params = FasstParams(spat=spat, spec=spec)
        cfg = GEMConfig(niter=8)
        oparams = params_from_pytree(params)
        got_params, got_ll = jax.block_until_ready(
            run_gem(params, jnp.asarray(X), cfg))
        oparams, want_ll = oracle_gem_run(oparams, X, 8)
        np.testing.assert_allclose(np.asarray(got_ll), want_ll, rtol=1e-6)
        np.testing.assert_allclose(np.asarray(got_params.spec[0].TW),
                                   oparams.spec[0].TW, rtol=1e-4, atol=1e-10)
        np.testing.assert_allclose(np.asarray(got_params.spec[0].FB),
                                   oparams.spec[0].FB, rtol=1e-4, atol=1e-10)
