"""Multichannel Wiener separation.

Reference parity: pyfasst/audioModel.py::separate_spat_comps /
separate_spatial_filter_comp (UNVERIFIED; mount empty, see SURVEY.md §3.3).
Posterior-mean source images (SURVEY.md §A):

    y^_j(f,n) = v_j(f,n) R_j(f) Sigma_x(f,n)^-1 x(f,n)

which sum to x as Sigma_b -> 0 (conservation; tested). The spatial-filter
variant drops the PSD weighting and uses only the spatial covariances
(a PSD-independent beamformer-style mask).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from pyfasst_jax.models.components import FasstParams
from pyfasst_jax.ops import herm
from pyfasst_jax.ops.estep import (
    cross_terms, mixture_cov, stable_inv, stable_mixture_det,
)
from pyfasst_jax.ops.gem import spatial_covs


_I8 = jnp.asarray([1.0, 0, 0, 0, 0, 0, 1.0, 0])  # packed general identity


def _herm_adj(P):
    """Packed adjugate of a packed Hermitian: [d, a, -b]."""
    return jnp.stack([P[..., 1], P[..., 0], -P[..., 2], -P[..., 3]], axis=-1)


@jax.jit
@jax.default_matmul_precision("highest")
def separate_sources(params: FasstParams, X: jnp.ndarray,
                     sigma: jnp.ndarray):
    """Wiener posterior-mean source images y^_j = v_j R_j Sigma_x^-1 x.

    X: (F, N, I=2) complex mixture STFT. Returns (J, F, N, 2) complex.

    Float32 numerics: computing R_j Sigma_x^-1 naively multiplies R_j by a
    noisy adjugate; near the annealed noise floor the (exactly zero for
    rank-1) product R_j adj(R_j) = det(R_j) I survives only as rounding noise
    amplified by 1/det, and the masks blow up by orders of magnitude. The
    2x2 adjugate is LINEAR, so we expand it analytically:

      R_j adj(Sigma_x) = sum_{k != j} v_k R_j adj(R_k)
                         + v_j det(R_j) I + sigma R_j,

    with det(R_j) substituted statically (0 for rank-1, |det A_j|^2 for
    rank-2) and det(Sigma_x) from the nonnegative-monomial expansion.
    """
    from pyfasst_jax.ops.mstep import _as_conv_A

    if X.shape[-1] != 2:
        # general channel count: unrolled-Cholesky engine (trace-time dispatch)
        from pyfasst_jax.ops.engine_general import separate_sources_general
        return separate_sources_general(params, X, sigma)

    F = X.shape[0]
    J = params.n_spat
    v = params.all_source_powers()                 # (J, F, N)
    Rj = spatial_covs(params, F)                   # (J, F, 4)
    A_conv = tuple(_as_conv_A(c, F) for c in params.spat)
    trR, Xc = cross_terms(Rj, A_conv)
    det = stable_mixture_det(v, trR, Xc, sigma)    # (F, N)
    detR = jnp.stack([0.5 * Xc[j, j] for j in range(J)])  # (J, F)
    adjR = _herm_adj(Rj)                           # (J, F, 4)
    Rj_gen = herm.herm_as_gen(Rj)                  # (J, F, 8)
    x0, x1 = X[..., 0], X[..., 1]
    outs = []
    for j in range(J):
        num = sigma[:, None, None] * Rj_gen[j][:, None, :]
        num = num + (v[j] * detR[j][:, None])[..., None] * _I8
        for k in range(J):
            if k == j:
                continue
            Mjk = herm.mul(Rj[j], adjR[k])          # (F, 8) general
            num = num + v[k][..., None] * Mjk[:, None, :]
        y0, y1 = herm.gen_apply(num, x0, x1)
        scale = v[j] / det
        outs.append(jnp.stack([y0 * scale, y1 * scale], axis=-1))
    return jnp.stack(outs)                          # (J, F, N, 2)


@functools.partial(jax.jit, static_argnames=("det_floor",))
def separate_spatial_filter(params: FasstParams, X: jnp.ndarray,
                            sigma: jnp.ndarray, det_floor: float = 1e-30):
    """PSD-independent spatial filtering: G_j = R_j (sum_j' R_j' + sigma I)^-1.

    One filter per source per frequency (no time variation) -- the
    'spatial filter' separation variant of the reference.
    """
    if X.shape[-1] != 2:
        from pyfasst_jax.ops.engine_general import (
            separate_spatial_filter_general,
        )
        return separate_spatial_filter_general(params, X, sigma)
    F = X.shape[0]
    Rj = spatial_covs(params, F)                   # (J, F, 4)
    Stot = herm.add_noise_diag(jnp.sum(Rj, axis=0), sigma)
    Si = herm.inv(Stot, det_floor)                 # (F, 4)
    G = herm.mul(Rj, Si[None])                     # (J, F, 8)
    y0, y1 = herm.gen_apply(G[:, :, None, :], X[None, ..., 0], X[None, ..., 1])
    return jnp.stack([y0, y1], axis=-1)


def posterior_psd_masks(params: FasstParams, X: jnp.ndarray,
                        sigma: jnp.ndarray):
    """Convenience: per-source Wiener PSD ratios v_j tr(R_j) / tr(Sigma_x)."""
    F = X.shape[0]
    v = params.all_source_powers()
    Rj = spatial_covs(params, F)
    Sx = mixture_cov(v, Rj, sigma)
    return (v * herm.trace(Rj)[:, :, None]) / jnp.maximum(
        herm.trace(Sx)[None], 1e-30)


__all__ = ["separate_sources", "separate_spatial_filter",
           "posterior_psd_masks"]
