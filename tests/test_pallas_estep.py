"""Fused E-step kernel (Pallas through Triton) vs the XLA path: parity in
interpret mode on the CPU, the routing rule, and one compiled check on a
card (marker `gpu`)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pyfasst_jax.models.components import FasstParams, SpatialComp, SpectralComp
from pyfasst_jax.ops.estep import compute_suff_stats
from pyfasst_jax.ops.gem import spatial_covs
from pyfasst_jax.ops.mstep import _as_conv_A
from pyfasst_jax.ops.pallas_estep import pallas_suff_stats


def _problem(rng, F=33, N=70, J=2, K=3):
    X = jnp.asarray(rng.standard_normal((F, N, 2))
                    + 1j * rng.standard_normal((F, N, 2)), jnp.complex64)
    spat = tuple(SpatialComp(A=jnp.asarray(
        np.abs(rng.standard_normal((2, 1))) + 0.3, jnp.float32))
        for _ in range(J))
    spec = tuple(SpectralComp(
        FB=jnp.asarray(0.5 + rng.random((F, K)), jnp.float32),
        TW=jnp.asarray(0.5 + rng.random((K, N)), jnp.float32),
        spat_ind=j) for j in range(J))
    params = FasstParams(spat=spat, spec=spec)
    v = params.all_source_powers()
    Rj = spatial_covs(params, F)
    A_conv = tuple(_as_conv_A(c, F) for c in params.spat)
    sigma = jnp.asarray(0.01 + 0.005 * rng.random(F), jnp.float32)
    return X, v, Rj, A_conv, sigma, (1,) * J


def test_pallas_estep_matches_xla(rng):
    X, v, Rj, A_conv, sigma, ranks = _problem(rng)
    want = compute_suff_stats(X, v, Rj, sigma, ranks, A_conv=A_conv)
    got = pallas_suff_stats(X, v, Rj, sigma, ranks, A_conv, interpret=True)

    np.testing.assert_allclose(np.asarray(got.xi), np.asarray(want.xi),
                               rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(float(got.loglik), float(want.loglik),
                               rtol=1e-4)
    J = v.shape[0]
    for j in range(J):
        np.testing.assert_allclose(np.asarray(got.Txs[j]),
                                   np.asarray(want.Txs[j]),
                                   rtol=2e-4, atol=1e-4)
        np.testing.assert_allclose(np.asarray(got.T4[j]),
                                   np.asarray(want.T4[j]),
                                   rtol=2e-4, atol=1e-5)
        for k in range(J):
            np.testing.assert_allclose(np.asarray(got.Tss[j][k]),
                                       np.asarray(want.Tss[j][k]),
                                       rtol=2e-4, atol=1e-4)
            if j != k:
                np.testing.assert_allclose(np.asarray(got.T7[j][k]),
                                           np.asarray(want.T7[j][k]),
                                           rtol=2e-4, atol=1e-4)


def test_pallas_estep_three_sources(rng):
    X, v, Rj, A_conv, sigma, ranks = _problem(rng, F=17, N=40, J=3)
    want = compute_suff_stats(X, v, Rj, sigma, ranks, A_conv=A_conv)
    got = pallas_suff_stats(X, v, Rj, sigma, ranks, A_conv, interpret=True)
    np.testing.assert_allclose(np.asarray(got.xi), np.asarray(want.xi),
                               rtol=3e-4, atol=1e-6)
    np.testing.assert_allclose(float(got.loglik), float(want.loglik),
                               rtol=1e-4)


def test_pallas_estep_multitile_accumulation(rng):
    """N spanning many frame tiles exercises the cross-tile sum of the
    per-tile partial statistics."""
    X, v, Rj, A_conv, sigma, ranks = _problem(rng, F=9, N=2500, J=2)
    want = compute_suff_stats(X, v, Rj, sigma, ranks, A_conv=A_conv)
    got = pallas_suff_stats(X, v, Rj, sigma, ranks, A_conv, interpret=True)
    np.testing.assert_allclose(float(got.loglik), float(want.loglik),
                               rtol=2e-4)
    for j in range(2):
        np.testing.assert_allclose(np.asarray(got.Txs[j]),
                                   np.asarray(want.Txs[j]),
                                   rtol=5e-4, atol=1e-3)
        np.testing.assert_allclose(np.asarray(got.T4[j]),
                                   np.asarray(want.T4[j]),
                                   rtol=5e-4, atol=1e-4)
        for k in range(2):
            np.testing.assert_allclose(np.asarray(got.Tss[j][k]),
                                       np.asarray(want.Tss[j][k]),
                                       rtol=5e-4, atol=1e-3)


def _rank2_problem(rng, F=21, N=50, J=2):
    X = jnp.asarray(rng.standard_normal((F, N, 2))
                    + 1j * rng.standard_normal((F, N, 2)), jnp.complex64)
    spat = []
    for j in range(J):
        A = (rng.standard_normal((F, 2, 2))
             + 1j * rng.standard_normal((F, 2, 2))) * 0.5
        spat.append(SpatialComp(A=jnp.asarray(A, jnp.complex64),
                                mix_type="conv"))
    spec = tuple(SpectralComp(
        FB=jnp.asarray(0.5 + rng.random((F, 3)), jnp.float32),
        TW=jnp.asarray(0.5 + rng.random((3, N)), jnp.float32),
        spat_ind=j) for j in range(J))
    params = FasstParams(spat=tuple(spat), spec=spec)
    v = params.all_source_powers()
    Rj = spatial_covs(params, F)
    A_conv = tuple(_as_conv_A(c, F) for c in params.spat)
    sigma = jnp.asarray(0.01 + 0.005 * rng.random(F), jnp.float32)
    return X, v, Rj, A_conv, sigma, (2,) * J


def test_pallas_estep_rank2(rng):
    """Full-rank (rank-2) sources through the generated kernel."""
    X, v, Rj, A_conv, sigma, ranks = _rank2_problem(rng)
    want = compute_suff_stats(X, v, Rj, sigma, ranks, A_conv=A_conv)
    got = pallas_suff_stats(X, v, Rj, sigma, ranks, A_conv, interpret=True)
    np.testing.assert_allclose(np.asarray(got.xi), np.asarray(want.xi),
                               rtol=3e-4, atol=1e-5)
    np.testing.assert_allclose(float(got.loglik), float(want.loglik),
                               rtol=1e-4)
    for j in range(2):
        np.testing.assert_allclose(np.asarray(got.Txs[j]),
                                   np.asarray(want.Txs[j]),
                                   rtol=5e-4, atol=1e-3)
        np.testing.assert_allclose(np.asarray(got.T4[j]),
                                   np.asarray(want.T4[j]),
                                   rtol=5e-4, atol=1e-4)
        for k in range(2):
            np.testing.assert_allclose(np.asarray(got.Tss[j][k]),
                                       np.asarray(want.Tss[j][k]),
                                       rtol=5e-4, atol=1e-3)
            if j != k:
                np.testing.assert_allclose(np.asarray(got.T7[j][k]),
                                           np.asarray(want.T7[j][k]),
                                           rtol=5e-4, atol=1e-3)


def test_pallas_estep_mixed_ranks(rng):
    """One rank-1 + one rank-2 source (padded mixing columns)."""
    F, N = 17, 40
    X = jnp.asarray(rng.standard_normal((F, N, 2))
                    + 1j * rng.standard_normal((F, N, 2)), jnp.complex64)
    A2 = (rng.standard_normal((F, 2, 2))
          + 1j * rng.standard_normal((F, 2, 2))) * 0.5
    spat = (SpatialComp(A=jnp.asarray(np.abs(rng.standard_normal((2, 1)))
                                      + 0.3, jnp.float32)),
            SpatialComp(A=jnp.asarray(A2, jnp.complex64), mix_type="conv"))
    spec = tuple(SpectralComp(
        FB=jnp.asarray(0.5 + rng.random((F, 3)), jnp.float32),
        TW=jnp.asarray(0.5 + rng.random((3, N)), jnp.float32),
        spat_ind=j) for j in range(2))
    params = FasstParams(spat=spat, spec=spec)
    v = params.all_source_powers()
    Rj = spatial_covs(params, F)
    A_conv = tuple(_as_conv_A(c, F) for c in params.spat)
    sigma = jnp.asarray(0.02 + 0.005 * rng.random(F), jnp.float32)
    ranks = (1, 2)
    want = compute_suff_stats(X, v, Rj, sigma, ranks, A_conv=A_conv)
    got = pallas_suff_stats(X, v, Rj, sigma, ranks, A_conv, interpret=True)
    np.testing.assert_allclose(np.asarray(got.xi), np.asarray(want.xi),
                               rtol=3e-4, atol=1e-5)
    np.testing.assert_allclose(float(got.loglik), float(want.loglik),
                               rtol=1e-4)
    for j in range(2):
        np.testing.assert_allclose(np.asarray(got.Txs[j]),
                                   np.asarray(want.Txs[j]),
                                   rtol=5e-4, atol=1e-3)


def test_pallas_estep_noise_inject(rng):
    """'ann_ns_inj' corrections through the kernel (vs XLA path)."""
    X, v, Rj, A_conv, sigma, ranks = _problem(rng, F=17, N=40, J=2)
    want = compute_suff_stats(X, v, Rj, sigma, ranks, A_conv=A_conv,
                              noise_inject=True)
    got = pallas_suff_stats(X, v, Rj, sigma, ranks, A_conv,
                            noise_inject=True, interpret=True)
    np.testing.assert_allclose(np.asarray(got.xi), np.asarray(want.xi),
                               rtol=3e-4, atol=1e-6)
    np.testing.assert_allclose(float(got.loglik), float(want.loglik),
                               rtol=1e-4)
    for j in range(2):
        np.testing.assert_allclose(np.asarray(got.Txs[j]),
                                   np.asarray(want.Txs[j]),
                                   rtol=5e-4, atol=1e-4)
        for k in range(2):
            np.testing.assert_allclose(np.asarray(got.Tss[j][k]),
                                       np.asarray(want.Tss[j][k]),
                                       rtol=5e-4, atol=1e-4)


def test_pallas_estep_real_cov_specialization(rng):
    """real_cov=True (instantaneous/real mixing) must match the generic
    kernel and the XLA path exactly: it only deletes arithmetic on
    identically-zero imaginary parts."""
    X, v, Rj, A_conv, sigma, ranks = _problem(rng)
    want = compute_suff_stats(X, v, Rj, sigma, ranks, A_conv=A_conv)
    got = pallas_suff_stats(X, v, Rj, sigma, ranks, A_conv, interpret=True,
                            real_cov=True)
    np.testing.assert_allclose(np.asarray(got.xi), np.asarray(want.xi),
                               rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(float(got.loglik), float(want.loglik),
                               rtol=1e-4)
    J = v.shape[0]
    for j in range(J):
        np.testing.assert_allclose(np.asarray(got.Txs[j]),
                                   np.asarray(want.Txs[j]),
                                   rtol=2e-4, atol=1e-4)
        np.testing.assert_allclose(np.asarray(got.T4[j]),
                                   np.asarray(want.T4[j]),
                                   rtol=2e-4, atol=1e-5)
        for k in range(J):
            np.testing.assert_allclose(np.asarray(got.Tss[j][k]),
                                       np.asarray(want.Tss[j][k]),
                                       rtol=2e-4, atol=1e-4)
            if j != k:
                # real mixing + real Sigma_x^-1 A columns: T7 is real
                assert float(np.abs(np.imag(np.asarray(
                    got.T7[j][k]))).max()) == 0.0
                np.testing.assert_allclose(np.asarray(got.T7[j][k]),
                                           np.asarray(want.T7[j][k]),
                                           rtol=2e-4, atol=1e-4)


def test_pallas_estep_real_cov_rank2_ns_inj(rng):
    """The specialization composes with rank-2 sources and noise injection."""
    X, v, Rj, A_conv, sigma, _ = _problem(rng, F=17, N=40)
    # promote source 0 to a rank-2 REAL mixing
    A0 = jnp.asarray(np.abs(rng.standard_normal((17, 2, 2))) + 0.3,
                     jnp.float32).astype(jnp.complex64)
    A_conv = (A0,) + A_conv[1:]
    from pyfasst_jax.ops import herm
    Rj = jnp.stack([herm.herm_from_mixing(A_conv[0]),
                    herm.herm_from_mixing(A_conv[1])])
    ranks = (2, 1)
    want = compute_suff_stats(X, v, Rj, sigma, ranks, A_conv=A_conv,
                              noise_inject=True)
    got = pallas_suff_stats(X, v, Rj, sigma, ranks, A_conv, interpret=True,
                            real_cov=True, noise_inject=True)
    np.testing.assert_allclose(np.asarray(got.xi), np.asarray(want.xi),
                               rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(float(got.loglik), float(want.loglik),
                               rtol=1e-4)
    for j in range(2):
        np.testing.assert_allclose(np.asarray(got.T4[j]),
                                   np.asarray(want.T4[j]),
                                   rtol=2e-4, atol=1e-5)
        for k in range(2):
            np.testing.assert_allclose(np.asarray(got.Tss[j][k]),
                                       np.asarray(want.Tss[j][k]),
                                       rtol=2e-4, atol=1e-4)


def test_pallas_estep_ragged_edges(rng):
    """F and N that are not multiples of the (BF, BN) tile: the masked
    loads zero the padded rows and frames, every statistic matches."""
    from pyfasst_jax.ops.pallas_estep import BF, BN
    F, N = 3 * BF + 1, BN + 2
    X, v, Rj, A_conv, sigma, ranks = _rank2_problem(rng, F=F, N=N)
    want = compute_suff_stats(X, v, Rj, sigma, ranks, A_conv=A_conv,
                              noise_inject=True)
    got = pallas_suff_stats(X, v, Rj, sigma, ranks, A_conv,
                            noise_inject=True, interpret=True)
    np.testing.assert_allclose(np.asarray(got.xi), np.asarray(want.xi),
                               rtol=3e-4, atol=1e-5)
    np.testing.assert_allclose(float(got.loglik), float(want.loglik),
                               rtol=1e-4)
    for j in range(2):
        np.testing.assert_allclose(np.asarray(got.T4[j]),
                                   np.asarray(want.T4[j]),
                                   rtol=5e-4, atol=1e-4)
        for k in range(2):
            np.testing.assert_allclose(np.asarray(got.Tss[j][k]),
                                       np.asarray(want.Tss[j][k]),
                                       rtol=5e-4, atol=1e-3)


def test_stat_layout_counts_every_column():
    from pyfasst_jax.ops.pallas_estep import stat_layout
    n, off = stat_layout((1, 2))
    # ll + t4 (1 + 4) + txs (4 + 8) + tss (2 + 4 + 4 + 8) + t7 (4 + 4)
    assert n == 1 + 5 + 12 + 18 + 8
    assert off["ll"] == 0 and off[("t4", 1)] == 2
    assert ("t7", 0, 0) not in off and off[("t7", 1, 0)] == n - 4


@pytest.mark.parametrize("I, ranks, dtype, covered", [
    (2, (1, 1), jnp.complex64, True),
    (2, (2, 2), jnp.complex64, True),
    (2, (1, 1, 1, 1), jnp.complex64, True),
    (2, (1, 2), jnp.complex64, True),
    (2, (2, 2, 2), jnp.complex64, False),      # 6 sub-sources
    (2, (1, 1, 1, 1, 1), jnp.complex64, False),
    (3, (1, 1), jnp.complex64, False),         # general-I engine
    (2, (1, 3), jnp.complex64, False),
    (2, (1, 1), jnp.complex128, False),        # float64 parity mode
])
def test_kernel_covers_rule(I, ranks, dtype, covered):
    from pyfasst_jax.ops.pallas_estep import kernel_covers
    assert kernel_covers(I, ranks, dtype) is covered


def _lowered_text(params, X, cfg, platform):
    from pyfasst_jax.ops.gem import run_gem
    return run_gem.trace(params, X, cfg).lower(
        lowering_platforms=(platform,)).as_text()


@pytest.mark.parametrize("J, rank, use_pallas, platform, kernel", [
    (2, 1, True, "cuda", True),
    (2, 1, True, "cpu", False),
    (2, 1, False, "cuda", False),
    (3, 2, True, "cuda", False),
])
def test_gem_routes_estep_by_platform(rng, J, rank, use_pallas, platform,
                                      kernel):
    """The GEM step lowers the Triton kernel only for CUDA and only for
    covered models with use_pallas on; everything else gets XLA's E-step."""
    import dataclasses
    from pyfasst_jax.utils.config import GEMConfig
    F, N = 9, 20
    X = jnp.asarray(rng.standard_normal((F, N, 2))
                    + 1j * rng.standard_normal((F, N, 2)), jnp.complex64)
    if rank == 1:
        spat = tuple(SpatialComp(A=jnp.asarray(
            np.abs(rng.standard_normal((2, 1))) + 0.3, jnp.float32))
            for _ in range(J))
    else:
        spat = tuple(SpatialComp(A=jnp.asarray(
            rng.standard_normal((F, 2, 2)), jnp.complex64), mix_type="conv")
            for _ in range(J))
    spec = tuple(SpectralComp(
        FB=jnp.asarray(0.5 + rng.random((F, 3)), jnp.float32),
        TW=jnp.asarray(0.5 + rng.random((3, N)), jnp.float32),
        spat_ind=j) for j in range(J))
    cfg = dataclasses.replace(GEMConfig(niter=2), use_pallas=use_pallas)
    text = _lowered_text(FasstParams(spat=spat, spec=spec), X, cfg,
                         platform)
    assert ("triton" in text) is kernel


def test_multi_device_mesh_turns_kernel_off():
    from pyfasst_jax.parallel import make_mesh
    from pyfasst_jax.parallel.sharding import mesh_config
    from pyfasst_jax.utils.config import GEMConfig
    cfg = GEMConfig(niter=3)
    assert mesh_config(cfg, make_mesh(1)).use_pallas
    assert not mesh_config(cfg, make_mesh(4)).use_pallas
    assert mesh_config(cfg, make_mesh(4)).niter == 3


@pytest.fixture
def cuda_device():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("compiled Triton kernel: needs a CUDA device")
    return jax.devices()[0]


@pytest.mark.gpu
def test_compiled_kernel_matches_xla_at_flagship_width(cuda_device):
    """The compiled kernel against the XLA E-step on the 513 x 863
    flagship plane (chip_smoke's kernel phase, batch of 2)."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    import chip_smoke
    for errs in chip_smoke.phase_kernel(n_batch=2).values():
        assert max(errs.values()) < chip_smoke.KERNEL_RTOL
