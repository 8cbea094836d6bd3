"""The jitted GEM loop: estimate FASST parameters a posteriori.

Reference parity: pyfasst/audioModel.py::estim_param_a_posteriori /
GEM_iteration (UNVERIFIED; mount empty, see SURVEY.md §3.2). The reference
runs 200-500 Python-level GEM iterations; here the whole loop is ONE compiled
XLA program (lax.fori_loop whose body is E-step + spatial/spectral M-steps +
renormalization), so per-iteration dispatch overhead is zero and XLA fuses the
elementwise (f, n)-plane work across the step.

Annealing (SURVEY.md §A): the additive noise PSD Sigma_b(f) is interpolated
from sigma0(f) down to sigma1(f) over the run; it is load-bearing for the
conditioning of the per-bin 2x2 inverses, not just local-optima escape.
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from pyfasst_jax.models.components import FasstParams
from pyfasst_jax.ops import herm
from pyfasst_jax.ops.estep import compute_suff_stats
from pyfasst_jax.ops.mstep import renormalize, update_spatial, update_spectral
from pyfasst_jax.utils.config import AnnealingMode, GEMConfig


def observed_covariance(X: jnp.ndarray) -> jnp.ndarray:
    """Packed empirical covariance Rxx(f,n) = x x^H from the STFT (F, N, I=2).

    Reference parity: FASST.comp_transf_Cx (UNVERIFIED). Kept for inspection/
    compat; the E-step itself works directly on X (see estep.py numerics).
    """
    return herm.herm_from_outer(X[..., 0], X[..., 1])


def annealing_endpoints(X: jnp.ndarray, cfg: GEMConfig):
    """sigma0(f), sigma1(f) as fractions of the mean per-frequency power of
    the mixture STFT X (F, N, 2).

    Silent frequency bins are floored at power_floor_frac of the global mean
    power so sigma stays inside float32 range (and the 1/sigma pooled-solve
    weights stay bounded).
    """
    return endpoints_from_power(jnp.mean(jnp.abs(X) ** 2, axis=(1, 2)), cfg)


def endpoints_from_power(Pm: jnp.ndarray, cfg: GEMConfig):
    """Endpoints from a precomputed per-frequency mean power Pm (F,).

    Split out so batch callers can compute Pm on the UNPADDED frames (zero
    padding would otherwise dilute the mean and shrink the noise floor).
    """
    floor = jnp.maximum(cfg.power_floor_frac * jnp.mean(Pm), cfg.eps)
    Pm = jnp.maximum(Pm, floor)
    return cfg.sigma_start_frac * Pm, cfg.sigma_end_frac * Pm


def noise_psd(it, niter: int, sigma0, sigma1, mode: AnnealingMode):
    if mode == AnnealingMode.NO_ANN:
        return sigma1
    w = 1.0 - it / jnp.maximum(niter - 1, 1)
    return w * sigma0 + (1.0 - w) * sigma1


def spatial_covs(params: FasstParams, F: int) -> jnp.ndarray:
    """(J, F, 4) packed R_j for all spatial components."""
    return jnp.stack([c.spatial_cov(F) for c in params.spat])


def gem_step(params: FasstParams, X: jnp.ndarray, sigma: jnp.ndarray,
             cfg: GEMConfig, spatial_enabled=None, x4=None
             ) -> Tuple[FasstParams, jnp.ndarray]:
    """One GEM iteration; returns updated params and the step log-likelihood.

    X is the complex mixture STFT (F, N, 2). x4 optionally carries
    pallas_estep.pack_x4(X), hoisted out of the loop by run_gem (X is
    constant across iterations).
    """
    from pyfasst_jax.ops.mstep import _as_conv_A
    from pyfasst_jax.ops.pallas_estep import kernel_covers, pallas_suff_stats

    F = X.shape[0]
    ranks = tuple(c.rank for c in params.spat)
    v = params.all_source_powers()                    # (J, F, N)
    A_conv = tuple(_as_conv_A(c, F) for c in params.spat)
    noise_inject = cfg.annealing == AnnealingMode.ANN_NS_INJ
    if X.shape[-1] != 2:
        # I > 2 channels: the packed-Hermitian 2x2 fast path does not apply;
        # the general unrolled-Cholesky engine covers any channel count
        # (trace-time dispatch -- the branch is resolved at compile time).
        from pyfasst_jax.ops.engine_general import suff_stats_general
        stats = suff_stats_general(X, v, A_conv, sigma, ranks, eps=cfg.eps,
                                   noise_inject=noise_inject)
        params = update_spatial(params, stats, sigma, enabled=spatial_enabled)
        params = update_spectral(params, stats, eps=cfg.eps, v=v)
        if cfg.renormalize:
            params = renormalize(params)
        return params, stats.loglik
    Rj = spatial_covs(params, F)                      # (J, F, 4)

    def xla_stats():
        return compute_suff_stats(X, v, Rj, sigma, ranks, eps=cfg.eps,
                                  noise_inject=noise_inject, A_conv=A_conv)

    if cfg.use_pallas and kernel_covers(2, ranks, X.dtype):
        # instantaneous models have real mixing (a trace-time dtype fact):
        # the kernel then deletes all identically-zero imaginary arithmetic
        real_cov = all(not jnp.iscomplexobj(c.A) for c in params.spat)

        def kernel_stats():
            return pallas_suff_stats(X, v, Rj, sigma, ranks, A_conv,
                                     eps=cfg.eps, noise_inject=noise_inject,
                                     x4=x4, real_cov=real_cov)

        # resolved when lowering: the compiled kernel for CUDA, the XLA
        # E-step for every other platform (the CPU reference included)
        stats = jax.lax.platform_dependent(cuda=kernel_stats,
                                           default=xla_stats)
    else:
        stats = xla_stats()
    params = update_spatial(params, stats, sigma, enabled=spatial_enabled)
    params = update_spectral(params, stats, eps=cfg.eps, v=v)
    if cfg.renormalize:
        params = renormalize(params)
    return params, stats.loglik


@functools.partial(jax.jit, static_argnames=("cfg",))
@jax.default_matmul_precision("highest")
def run_gem(params: FasstParams, X: jnp.ndarray, cfg: GEMConfig,
            start_iter=0, sigma_endpoints=None, end_iter=None
            ) -> Tuple[FasstParams, jnp.ndarray]:
    """Run GEM iterations [start_iter, end_iter or cfg.niter) as one
    compiled fori_loop.

    X is the complex mixture STFT (F, N, 2). Returns (params,
    logliks[niter]) with entries outside the executed range left zero.
    This is THE entry point the host API wraps (reference:
    estim_param_a_posteriori). start_iter/end_iter are DYNAMIC (traced)
    bounds, so chunked runs (checkpoint every K iterations, resume) reuse
    one executable; the annealing schedule stays a pure function of the
    iteration index against the FULL cfg.niter, so a chunked or resumed
    trajectory is exactly the uninterrupted one. sigma_endpoints, if given,
    is a (sigma0, sigma1) pair of (F,) arrays overriding the endpoints
    derived from X -- used by the batch path, where X carries zero padding
    that would dilute the per-frequency mean power.

    Matmul precision is pinned to full float32 ("highest"): reduced-
    precision matmul passes (TF32 on a GPU) destroy the E-step reductions
    and the IS-NMF update ratios.
    """
    from pyfasst_jax.ops.pallas_estep import kernel_covers, pack_x4

    sigma0, sigma1 = (annealing_endpoints(X, cfg) if sigma_endpoints is None
                      else sigma_endpoints)
    logliks = jnp.zeros((cfg.niter,), jnp.float32)

    hold = int(cfg.spatial_hold_frac * cfg.niter)
    # pack the constant mixture plane once, not once per iteration
    ranks = tuple(c.rank for c in params.spat)
    x4 = (pack_x4(X) if cfg.use_pallas
          and kernel_covers(X.shape[-1], ranks, X.dtype) else None)

    def body(it, carry):
        params, logliks = carry
        sigma = noise_psd(it, cfg.niter, sigma0, sigma1, cfg.annealing)
        params, ll = gem_step(params, X, sigma, cfg,
                              spatial_enabled=(it >= hold), x4=x4)
        logliks = logliks.at[it].set(ll.astype(jnp.float32))
        return params, logliks

    stop = cfg.niter if end_iter is None else end_iter
    return jax.lax.fori_loop(start_iter, stop, body, (params, logliks))
