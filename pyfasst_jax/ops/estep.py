"""GEM E-step: exact Gaussian sufficient statistics.

Reference parity: pyfasst/audioModel.py::comp_suff_stat (UNVERIFIED; mount
empty, see SURVEY.md §3.2). The reference loops over frequency bins in Python;
here the whole (f, n)-plane is elementwise math plus batched matmul
reductions over frames, and -- critically for float32 -- every
statistic is accumulated in a *cancellation-free* form. With

    y(f,n)   = Sigma_x^-1 x            (2-vector)
    w_j(f,n) = A_j^H y                 (R_j-vector; the unit-PSD Wiener image
                                        of source j's sub-sources: s^_j = v_j w_j)

the sufficient statistics are outer products (errors enter squared):

    xi_j     = [v^2 ||w_j||^2 + v tr_R((I + v A^H S_j^-1 A)^-1)] / R_j
    Txs_j(f) = sum_n v_j x w_j^H                      -> R^_xs,j
    Tss_jk(f)= sum_n v_j v_k w_j w_k^H                -> Wiener part of R^_ss
    T4_j(f)  = sum_n v_j (I + v_j A_j^H S_j^-1 A_j)^-1   (diag posterior cov,
               Sherman-Morrison/Woodbury through the leave-one-out
               S_j = sum_{k != j} v_k R_k + sigma I -- subtract-free)
    T7_jk(f) = sum_n v_j v_k A_j^H Sigma_x^-1 A_k    (cross posterior cov,
               j != k)

so the M-step blocks are  R^_ss[j,j] = Tss_jj + T4_j  and
R^_ss[j,k] = Tss_jk - T7_jk, with NO congruences of summed statistics at
M-step time (a congruence after summation reintroduces first-order
cancellation and was observed to blow up the mixing solves).
det(Sigma_x) comes from the nonnegative-monomial expansion below.
"""
from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from pyfasst_jax.ops import herm
from pyfasst_jax.utils.pytree import pytree_dataclass


@pytree_dataclass
class SuffStats:
    """Per-source reduced statistics of one E-step (see module docstring).

    Txs: tuple over j of complex (F, 2, R_j).
    Tss: nested tuple (j, k) of complex (F, R_j, R_k).
    T4:  tuple over j: (F,) for rank-1, packed Hermitian (F, 4) for rank-2.
    T7:  nested tuple (j, k), complex (F, R_j, R_k); None on the diagonal.
    """

    xi: jnp.ndarray      # (J, F, N) posterior sub-source PSDs
    Txs: tuple
    Tss: tuple
    T4: tuple
    T7: tuple
    loglik: jnp.ndarray  # scalar: sum_{f,n} -(logdet Sigma_x + x^H Sigma_x^-1 x)


def mixture_cov(v: jnp.ndarray, Rj: jnp.ndarray, sigma: jnp.ndarray):
    """Packed Sigma_x(f,n) = sum_j v_j(f,n) R_j(f) + sigma(f) I, (F, N, 4)."""
    Sx = jnp.einsum("jfn,jfk->fnk", v, Rj)
    return herm.add_noise_diag(Sx, sigma[:, None])


def cross_terms(Rj: jnp.ndarray, A_conv) -> Tuple[jnp.ndarray,
                                                  jnp.ndarray]:
    """Per-frequency spatial invariants for the cancellation-free determinant.

    Returns trR (J, F) and X (J, J, F) with
        X[j, k] = tr(R_j) tr(R_k) - tr(R_j R_k)
    computed WITHOUT the subtraction, via Lagrange's identity over the
    mixing columns:
        X[j, k] = sum_{r, s} |A_j[0, r] A_k[1, s] - A_j[1, r] A_k[0, s]|^2,
    which also covers the diagonal (X[j, j] = 2 det R_j, exactly 0 for
    rank-1). The subtracted form cancels catastrophically in float32 when
    two sources' directions are near-parallel (e.g. the low frequencies of
    anechoic/convolutive models), poisoning det(Sigma_x).
    """
    trR = herm.trace(Rj)                                  # (J, F)
    J = Rj.shape[0]
    rows = []
    for j in range(J):
        a = A_conv[j]                                     # (F, 2, Rj)
        row = []
        for k in range(J):
            b = A_conv[k]                                 # (F, 2, Rk)
            c = (a[:, 0, :, None] * b[:, 1, None, :]
                 - a[:, 1, :, None] * b[:, 0, None, :])   # (F, Rj, Rk)
            row.append(jnp.sum(jnp.real(c) ** 2 + jnp.imag(c) ** 2,
                               axis=(1, 2)))
        rows.append(jnp.stack(row))
    return trR, jnp.stack(rows)                           # (J, J, F)


def stable_mixture_det(v, trR, X, sigma):
    """det Sigma_x(f,n) as a sum of NONNEGATIVE monomials:

        det = sigma^2 + sigma sum_j v_j tr(R_j) + 1/2 sum_{j,k} v_j v_k X_jk.

    The naive a*d - |b|^2 carries float32 cancellation noise ~eps * v^2 that
    swamps the true det once one source dominates a bin (cond(Sigma_x) over
    ~1e6), which is what collapsed long float32 GEM runs. Every term here is
    >= 0, so the result is exact to f32 rounding and needs no floors.
    """
    s = sigma[:, None]
    lin = jnp.einsum("jfn,jf->fn", v, trR)
    quad = 0.5 * jnp.einsum("jfn,kfn,jkf->fn", v, v, X)
    return s * s + s * lin + quad


def stable_inv(S, det):
    """Packed inverse from adjugate entries and an externally computed det."""
    r = 1.0 / det
    return jnp.stack([S[..., 1] * r, S[..., 0] * r,
                      -S[..., 2] * r, -S[..., 3] * r], axis=-1)


def _apply_AH(A, y0, y1):
    """w = A^H y for A (F, 2, R) complex, y components (F, N) -> (F, N, R)."""
    return (jnp.conj(A[:, None, 0, :]) * y0[..., None]
            + jnp.conj(A[:, None, 1, :]) * y1[..., None])


def compute_suff_stats(
    X: jnp.ndarray,            # (F, N, 2) complex mixture STFT
    v: jnp.ndarray,            # (J, F, N) source PSDs
    Rj: jnp.ndarray,           # (J, F, 4) packed spatial covariances
    sigma: jnp.ndarray,        # (F,) annealed noise PSD
    ranks: Tuple[int, ...],    # static spatial ranks R_j
    eps: float = 1e-30,
    noise_inject: bool = False,
    A_conv: Tuple = (),        # per j: complex (F, I, R) mixing
) -> SuffStats:
    """One E-step over the full (f, n) plane. All shapes static.

    Float32 safety rules (each found by bisecting a collapsing run against
    the float64 oracle; all mirrored there):
      - dets via nonnegative monomials (stable_mixture_det / cross_terms);
      - statistics as outer products of x, y, w (never congruences of sums);
      - posterior variances via leave-one-out Woodbury (never rank - v*tr).
    """
    trR, Xc = cross_terms(Rj, A_conv)
    Sx = mixture_cov(v, Rj, sigma)                      # (F, N, 4)
    detSx = stable_mixture_det(v, trR, Xc, sigma)       # (F, N) > 0
    Sxi = stable_inv(Sx, detSx)                          # (F, N, 4)

    x0, x1 = X[..., 0], X[..., 1]
    y0, y1 = herm.herm_apply(Sxi, x0, x1)                # y = Sigma_x^-1 x
    trSxiRxx = jnp.maximum(
        jnp.real(jnp.conj(x0) * y0 + jnp.conj(x1) * y1), 0.0)

    J = v.shape[0]
    # w_j = A_j^H y and, for noise injection, z_j = Sigma_x^-1 A_j columns.
    w = [_apply_AH(A_conv[j], y0, y1) for j in range(J)]  # (F, N, Rj)
    if noise_inject:
        # 'ann_ns_inj': observed covariance becomes x x^H + sigma I; the
        # additive corrections flow through z_j = Sigma_x^-1 A_j, (2, F, N, R).
        z = []
        for j in range(J):
            cols = []
            for r in range(ranks[j]):
                u0, u1 = herm.herm_apply(Sxi, A_conv[j][:, None, 0, r],
                                         A_conv[j][:, None, 1, r])
                cols.append(jnp.stack([u0, u1], axis=0))   # (2, F, N)
            z.append(jnp.stack(cols, axis=-1))             # (2, F, N, Rj)
        trSxiRxx = trSxiRxx + sigma[:, None] * herm.trace(Sxi)

    xi_list, T4_list, Txs_list = [], [], []
    for j in range(J):
        wj = w[j]
        trCR_j = jnp.sum(jnp.real(wj) ** 2 + jnp.imag(wj) ** 2, axis=-1)
        if noise_inject:
            zj = z[j]                                     # (2, F, N, Rj)
            trCR_j = trCR_j + sigma[:, None] * jnp.sum(
                jnp.abs(zj) ** 2, axis=(0, -1))
        if J == 1:
            Sj = jnp.zeros_like(Sx)
        else:
            Sj = sum(v[k][..., None] * Rj[k][:, None, :]
                     for k in range(J) if k != j)
        Sj = herm.add_noise_diag(Sj, sigma[:, None])     # (F, N, 4)
        vmask = v.at[j].set(0.0)                          # leave-one-out det
        Sji = stable_inv(Sj, stable_mixture_det(vmask, trR, Xc, sigma))
        t = herm.trace_prod(Sji, Rj[j][:, None, :])      # (F, N) >= 0
        vt = v[j] * t
        if ranks[j] >= 2:
            # full-rank: G = I_2 + v A^H S^-1 A is Hermitian PD with
            # det >= 1 -- its inverse needs no loading and no subtraction.
            M = herm.sandwich22(A_conv[j][:, None], Sji)  # (F, N, 4)
            G = herm.add_noise_diag(v[j][..., None] * M, 1.0)
            dG = jnp.maximum(herm.det(G), 1.0)
            Ginv = jnp.stack([G[..., 1], G[..., 0],
                              -G[..., 2], -G[..., 3]], axis=-1) / dG[..., None]
            T4_list.append(jnp.einsum("fn,fnc->fc", v[j], Ginv))
            coef = jnp.maximum((2.0 + vt) / dG, 0.0)
        else:
            den = 1.0 + vt
            coef = jnp.maximum((2.0 + vt) / den - 1.0, 0.0)
            T4_list.append(jnp.sum(v[j] / den, axis=-1))  # (F,)
        xi_list.append((v[j] * v[j] * trCR_j + v[j] * coef) / ranks[j])

        # R^_xs statistic: sum_n v_j x w_j^H  (F, 2, Rj)
        Txs = jnp.stack([
            jnp.einsum("fn,fnr->fr", v[j], x0[..., None] * jnp.conj(wj)),
            jnp.einsum("fn,fnr->fr", v[j], x1[..., None] * jnp.conj(wj)),
        ], axis=1)
        if noise_inject:
            Txs = Txs + sigma[:, None, None] * jnp.einsum(
                "fn,ifnr->fir", v[j], z[j])
        Txs_list.append(Txs)
    xi = jnp.maximum(jnp.stack(xi_list), eps)

    # Cross statistics: Tss_jk = sum_n v_j v_k w_j w_k^H (F, Rj, Rk) and the
    # cross posterior covariance T7_jk = sum_n v_j v_k A_j^H Sigma_x^-1 A_k.
    Tss, T7 = [], []
    for j in range(J):
        row_ss, row_7 = [], []
        for k in range(J):
            vv = v[j] * v[k]
            row_ss.append(jnp.einsum("fn,fnr,fns->frs", vv, w[j],
                                     jnp.conj(w[k])))
            if k == j:
                row_7.append(None)
            else:
                # M_jk(f,n) = A_j^H Sigma_x^-1 A_k: columns through herm_apply
                cols = []
                for r in range(ranks[k]):
                    u0, u1 = herm.herm_apply(Sxi, A_conv[k][:, None, 0, r],
                                             A_conv[k][:, None, 1, r])
                    cols.append(_apply_AH(A_conv[j], u0, u1))  # (F, N, Rj)
                Mjk = jnp.stack(cols, axis=-1)            # (F, N, Rj, Rk)
                row_7.append(jnp.einsum("fn,fnrs->frs", vv, Mjk))
        Tss.append(tuple(row_ss))
        T7.append(tuple(row_7))
    if noise_inject:
        Tss = [list(r) for r in Tss]
        for j in range(J):
            for k in range(J):
                vv = v[j] * v[k]
                corr = jnp.einsum("fn,ifnr,ifns->frs", vv * sigma[:, None],
                                  jnp.conj(z[j]), z[k])
                Tss[j][k] = Tss[j][k] + corr
        Tss = [tuple(r) for r in Tss]

    loglik = -jnp.sum(jnp.log(detSx) + trSxiRxx)
    return SuffStats(xi=xi, Txs=tuple(Txs_list), Tss=tuple(Tss),
                     T4=tuple(T4_list), T7=tuple(T7), loglik=loglik)
