"""General-I (I != 2 channels) GEM E-step and Wiener separation.

Reference parity: the FASST model is generic in the channel count I
(SURVEY.md §A; pyfasst/audioModel.py's math is I-generic even though its
hot primitive inv_herm_mat_2d is stereo-tuned, UNVERIFIED -- mount empty).
The packed-Hermitian 2x2 fast path (ops/estep.py, ops/wiener.py) remains
the stereo engine; this module is the I x I generalization the round-2
verdict asked for, dispatched on X.shape[-1] in ops/gem.py and
ops/wiener.py.

Design: all I x I linear algebra is UNROLLED over nested lists
of (F, N) planes -- static I and spatial ranks specialize the trace, every
operation is elementwise over the (f, n) plane (work XLA fuses with the
surrounding statistics), and there is no batched LAPACK-style primitive
anywhere.

Float32 numerics -- the square-root (QR row-update) form. A plain Cholesky
of Sigma_x = sigma I + sum_j v_j A_j A_j^H collapses in float32: late in
annealing cond(Sigma_x) ~ v_max/sigma exceeds 1e8, the pivot subtraction
d_i = M_ii - sum |L_im|^2 cancels catastrophically (computed pivots go
NEGATIVE while the true pivots are >= sigma), and the E-step statistics and
the Wiener masks blow up by orders of magnitude (observed: separated-image
energy 10x the mixture). The 2x2 engine survives through closed-form
nonnegative-monomial determinants (ops/estep.py); the general-I equivalent
used here is the square-root Kalman-filter trick: maintain the
upper-triangular factor R with R^H R = Sigma_x directly, starting from the
EXACT factor sqrt(sigma) I and absorbing each scaled mixing row
sqrt(v_j) a_jr^H with a Givens rotation. Every pivot update is
h = sqrt(a^2 + |b|^2) -- a nonnegative accumulation with NO subtraction --
so R_ii >= sqrt(sigma) holds computationally, log det Sigma_x =
2 sum_i log R_ii is exact to rounding, and every solve is triangular with
cond(R) = sqrt(cond(Sigma_x)): the condition exponent is HALVED, which is
the difference between garbage and ~1e-3-relative statistics at the
annealed noise floor. The posterior-variance statistics keep the same
subtract-free leave-one-out Woodbury form as the 2x2 path, with
G_j = I_R + v_j A_j^H S_j^-1 A_j itself accumulated in square-root form
(pivots >= 1) and tr(G^-1) = ||R_G^-1||_F^2 -- a sum of squares, >= 0 by
construction.

Mirrored in float64 in tests/oracle/fasst_oracle.py (estep_general, plain
np.linalg -- in float64 the factorization choice is immaterial); x64 parity
is tested at I=3 in tests/test_parity.py.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import jax.numpy as jnp

from pyfasst_jax.ops.estep import SuffStats


# -- unrolled square-root accumulation ----------------------------------------
# Upper-triangular factors are nested lists R[i][k] (k >= i) of
# broadcast-compatible (f, n) planes with real diagonals; static I unrolls
# at trace time.

def _abs2(z):
    return jnp.real(z) ** 2 + jnp.imag(z) ** 2


def _sqrt_identity(diag, I: int) -> List[List[jnp.ndarray]]:
    """R = diag * I (the exact factor of diag^2 * I); diag a real plane."""
    return [[diag if i == k else None for k in range(I)] for i in range(I)]


def _absorb_row(R: List[List[jnp.ndarray]], u: Sequence[jnp.ndarray],
                I: int) -> None:
    """Rank-1 QR row-update: R^H R += u u^H, in place.

    The appended row is w = conj(u); each Givens step zeroes w[i] against
    the real pivot R[i][i] via h = sqrt(a^2 + |w_i|^2) -- no subtraction
    ever reaches a pivot, so R[i][i] >= its initial value throughout.
    """
    w = [jnp.conj(u[k]) for k in range(I)]
    for i in range(I):
        a = R[i][i]
        wi = w[i]
        h = jnp.sqrt(a * a + _abs2(wi))
        c = a / h
        s = jnp.conj(wi) / h
        g = wi / h
        for k in range(i + 1, I):
            Rik, wk = R[i][k], w[k]
            if Rik is None:                      # still the identity pattern
                R[i][k] = s * wk
                w[k] = c * wk
            else:
                R[i][k] = c * Rik + s * wk
                w[k] = c * wk - g * Rik
        R[i][i] = h


def _sqrt_factor(diag, scaled_rows, I: int) -> List[List[jnp.ndarray]]:
    """Factor of diag^2 I + sum_r u_r u_r^H (diag real, u_r complex I-vecs)."""
    R = _sqrt_identity(diag, I)
    for u in scaled_rows:
        _absorb_row(R, u, I)
    for i in range(I):                            # fill untouched zeros
        for k in range(i + 1, I):
            if R[i][k] is None:
                R[i][k] = jnp.zeros_like(R[i][i]) * 1j
    return R


def _logdet(R: List[List[jnp.ndarray]]) -> jnp.ndarray:
    out = None
    for i in range(len(R)):
        t = jnp.log(R[i][i])
        out = t if out is None else out + t
    return 2.0 * out


def _solve(R: List[List[jnp.ndarray]], b: Sequence[jnp.ndarray]
           ) -> List[jnp.ndarray]:
    """Solve (R^H R) y = b: forward substitution on R^H, back on R."""
    n = len(R)
    z = []
    for i in range(n):
        s = b[i]
        for m in range(i):
            s = s - jnp.conj(R[m][i]) * z[m]
        z.append(s / R[i][i])
    y: List[jnp.ndarray] = [None] * n
    for i in reversed(range(n)):
        s = z[i]
        for k in range(i + 1, n):
            s = s - R[i][k] * y[k]
        y[i] = s / R[i][i]
    return y


def _forward_cols(R, A: jnp.ndarray, N: int) -> List[List[jnp.ndarray]]:
    """W = R^-H A for A (F, I, Rk): W[r][i] planes, so that
    A^H (R^H R)^-1 A = W^H W."""
    F, I, Rk = A.shape
    out = []
    for r in range(Rk):
        b = [jnp.broadcast_to(A[:, i, r][:, None], (F, N)) for i in range(I)]
        z = []
        for i in range(I):
            s = b[i]
            for m in range(i):
                s = s - jnp.conj(R[m][i]) * z[m]
            z.append(s / R[i][i])
        out.append(z)
    return out


def _solve_cols(R, A: jnp.ndarray, N: int) -> List[List[jnp.ndarray]]:
    """U = (R^H R)^-1 A for A (F, I, Rk): U[r][i] is an (F, N) plane."""
    F, I, Rk = A.shape
    out = []
    for r in range(Rk):
        b = [jnp.broadcast_to(A[:, i, r][:, None], (F, N)) for i in range(I)]
        out.append(_solve(R, b))
    return out


def _tri_inv(R: List[List[jnp.ndarray]]) -> List[List[jnp.ndarray]]:
    """B = R^-1 (upper triangular) by back substitution on columns."""
    n = len(R)
    B: List[List[jnp.ndarray]] = [[None] * n for _ in range(n)]
    for k in range(n):
        for i in range(k, -1, -1):
            if i == k:
                B[i][k] = 1.0 / R[i][i]
            else:
                s = None
                for m in range(i + 1, k + 1):
                    t = R[i][m] * B[m][k]
                    s = t if s is None else s + t
                B[i][k] = -s / R[i][i]
    return B


def _mixture_rows(v, A_conv, ranks, J):
    """Scaled mixing rows sqrt(v_j) a_jr as (source, rank)-tagged I-vectors."""
    rows = []
    for j in range(J):
        sv = jnp.sqrt(v[j])                       # (F, N) real
        for r in range(ranks[j]):
            rows.append((j, [sv * A_conv[j][:, i, r][:, None]
                             for i in range(A_conv[j].shape[1])]))
    return rows


def suff_stats_general(
    X: jnp.ndarray,            # (F, N, I) complex mixture transform
    v: jnp.ndarray,            # (J, F, N) source PSDs
    A_conv: Tuple,             # per j: complex (F, I, R_j) mixing
    sigma: jnp.ndarray,        # (F,) annealed noise PSD
    ranks: Tuple[int, ...],
    eps: float = 1e-30,
    noise_inject: bool = False,
) -> SuffStats:
    """One E-step over the (f, n) plane for arbitrary channel count I.

    Same sufficient statistics as ops/estep.compute_suff_stats (module
    docstring there), with T4_j returned as complex (F, R, R) for R >= 2
    (the packed-Hermitian T4 encoding is 2x2-only) and (F,) for rank 1.
    """
    del eps  # pivots are bounded by sqrt(sigma) structurally
    F, N, I = X.shape
    J = v.shape[0]
    sq_sigma = jnp.sqrt(sigma)[:, None]           # (F, 1) real
    rows = _mixture_rows(v, A_conv, ranks, J)

    Rm = _sqrt_factor(sq_sigma, [u for _, u in rows], I)
    logdet = _logdet(Rm)

    xs = [X[..., i] for i in range(I)]
    y = _solve(Rm, xs)                            # Sigma_x^-1 x
    trSxiRxx = jnp.maximum(
        sum(jnp.real(jnp.conj(xs[i]) * y[i]) for i in range(I)), 0.0)

    # U[k][r][i] = (Sigma_x^-1 A_k)[i, r]: needed for T7 (J >= 2) and for
    # every noise-injection correction.
    need_U = noise_inject or J >= 2
    U = [_solve_cols(Rm, A_conv[k], N) for k in range(J)] if need_U else None
    if noise_inject:
        # tr(Sigma_x^-1) = ||Rm^-1||_F^2: a sum of squares
        B = _tri_inv(Rm)
        tr_inv = sum(_abs2(B[i][k]) for i in range(I) for k in range(i, I))
        trSxiRxx = trSxiRxx + sigma[:, None] * tr_inv

    def AH_dot(A, yv):
        Ic, Rk = A.shape[1], A.shape[2]
        return [sum(jnp.conj(A[:, i, r])[:, None] * yv[i] for i in range(Ic))
                for r in range(Rk)]

    w = [AH_dot(A_conv[j], y) for j in range(J)]  # w_j = A_j^H y

    xi_list, T4_list, Txs_list = [], [], []
    for j in range(J):
        R = ranks[j]
        Aj = A_conv[j]
        trCR = sum(_abs2(w[j][r]) for r in range(R))
        if noise_inject:
            trCR = trCR + sigma[:, None] * sum(
                _abs2(U[j][r][i]) for r in range(R) for i in range(I))

        # leave-one-out Woodbury posterior G = I_R + v_j A_j^H S_j^-1 A_j,
        # itself in square-root form: W = R_loo^-H A_j, then absorb the
        # rows sqrt(v_j) conj(W_i) into R_G starting from the exact I_R.
        Rloo = _sqrt_factor(sq_sigma,
                            [u for (k, u) in rows if k != j], I)
        W = _forward_cols(Rloo, Aj, N)            # W[r][i]
        svj = jnp.sqrt(v[j])
        ones = jnp.ones((F, N), jnp.real(X).dtype)
        RG = _sqrt_identity(ones, R)
        for i in range(I):
            _absorb_row(RG, [svj * jnp.conj(W[r][i]) for r in range(R)], R)
        for p in range(R):
            for q in range(p + 1, R):
                if RG[p][q] is None:
                    RG[p][q] = jnp.zeros_like(ones) * 1j
        BG = _tri_inv(RG)                         # R_G^-1
        trGinv = sum(_abs2(BG[p][k]) for p in range(R)
                     for k in range(p, R))        # ||R_G^-1||_F^2 >= 0
        if R == 1:
            T4_list.append(jnp.sum(v[j] * trGinv, axis=-1))      # (F,)
        else:
            # G^-1 = B B^H
            def ginv(p, q):
                lo = max(p, q)
                return sum(BG[p][k] * jnp.conj(BG[q][k])
                           for k in range(lo, R))
            T4 = jnp.stack(
                [jnp.stack([jnp.sum(v[j] * ginv(p, q), axis=-1)
                            for q in range(R)], axis=-1)
                 for p in range(R)], axis=-2)                    # (F, R, R)
            T4_list.append(T4)
        xi_list.append((v[j] * v[j] * trCR + v[j] * trGinv) / R)

        # Txs_j(f) = sum_n v_j x w_j^H, (F, I, R)
        Txs = jnp.stack(
            [jnp.stack([jnp.sum(v[j] * xs[i] * jnp.conj(w[j][r]), axis=-1)
                        for r in range(R)], axis=-1)
             for i in range(I)], axis=-2)
        if noise_inject:
            Txs = Txs + sigma[:, None, None] * jnp.stack(
                [jnp.stack([jnp.sum(v[j] * U[j][r][i], axis=-1)
                            for r in range(R)], axis=-1)
                 for i in range(I)], axis=-2)
        Txs_list.append(Txs)
    xi = jnp.maximum(jnp.stack(xi_list), 1e-30)

    Tss, T7 = [], []
    for j in range(J):
        row_ss, row_7 = [], []
        for k in range(J):
            vv = v[j] * v[k]
            ss = jnp.stack(
                [jnp.stack([jnp.sum(vv * w[j][p] * jnp.conj(w[k][q]),
                                    axis=-1)
                            for q in range(ranks[k])], axis=-1)
                 for p in range(ranks[j])], axis=-2)         # (F, Rj, Rk)
            if noise_inject:
                ss = ss + jnp.stack(
                    [jnp.stack([jnp.sum(
                        sigma[:, None] * vv * sum(
                            jnp.conj(U[j][p][i]) * U[k][q][i]
                            for i in range(I)), axis=-1)
                        for q in range(ranks[k])], axis=-1)
                     for p in range(ranks[j])], axis=-2)
            row_ss.append(ss)
            if k == j:
                row_7.append(None)
            else:
                # T7_jk = sum_n v_j v_k A_j^H Sigma_x^-1 A_k
                row_7.append(jnp.stack(
                    [jnp.stack([jnp.sum(vv * sum(
                        jnp.conj(A_conv[j][:, i, p])[:, None] * U[k][q][i]
                        for i in range(I)), axis=-1)
                        for q in range(ranks[k])], axis=-1)
                     for p in range(ranks[j])], axis=-2))
        Tss.append(tuple(row_ss))
        T7.append(tuple(row_7))

    loglik = -jnp.sum(logdet + trSxiRxx)
    return SuffStats(xi=xi, Txs=tuple(Txs_list), Tss=tuple(Tss),
                     T4=tuple(T4_list), T7=tuple(T7), loglik=loglik)


# -- separation ---------------------------------------------------------------

def separate_sources_general(params, X: jnp.ndarray, sigma: jnp.ndarray,
                             eps: float = 1e-30) -> jnp.ndarray:
    """Wiener posterior means y^_j = v_j A_j A_j^H Sigma_x^-1 x for any I.

    X: (F, N, I) complex. Returns (J, F, N, I) complex. The square-root
    solve replaces the 2x2 path's adjugate-linearity expansion: the
    triangular factor carries cond(R) = sqrt(cond(Sigma_x)), so the masks
    stay accurate at the annealed noise floor where a plain float32
    Cholesky/determinant solve was measured to inflate the separated
    images' energy by ~10x.
    """
    from pyfasst_jax.ops.mstep import _as_conv_A

    del eps
    F, N, I = X.shape
    J = params.n_spat
    v = params.all_source_powers()
    A_conv = [_as_conv_A(c, F) for c in params.spat]
    ranks = tuple(c.rank for c in params.spat)
    rows = _mixture_rows(v, A_conv, ranks, J)
    Rm = _sqrt_factor(jnp.sqrt(sigma)[:, None], [u for _, u in rows], I)
    y = _solve(Rm, [X[..., i] for i in range(I)])
    outs = []
    for j in range(J):
        wj = [sum(jnp.conj(A_conv[j][:, i, r])[:, None] * y[i]
                  for i in range(I)) for r in range(ranks[j])]
        img = [v[j] * sum(A_conv[j][:, i, r][:, None] * wj[r]
                          for r in range(ranks[j]))
               for i in range(I)]
        outs.append(jnp.stack(img, axis=-1))
    return jnp.stack(outs)


def separate_spatial_filter_general(params, X: jnp.ndarray,
                                    sigma: jnp.ndarray,
                                    eps: float = 1e-30) -> jnp.ndarray:
    """PSD-independent spatial filter G_j = R_j (sum_k R_k + sigma I)^-1
    applied per frequency, any I. Returns (J, F, N, I)."""
    from pyfasst_jax.ops.mstep import _as_conv_A

    del eps
    F, N, I = X.shape
    J = params.n_spat
    A_conv = [_as_conv_A(c, F) for c in params.spat]
    ranks = tuple(c.rank for c in params.spat)
    # per-frequency factor: planes are (F, 1) so they broadcast over frames
    rows = []
    for j in range(J):
        for r in range(ranks[j]):
            rows.append([A_conv[j][:, i, r][:, None] for i in range(I)])
    Rt = _sqrt_factor(jnp.sqrt(sigma)[:, None], rows, I)
    y = _solve(Rt, [X[..., i] for i in range(I)])
    outs = []
    for j in range(J):
        wj = [sum(jnp.conj(A_conv[j][:, i, r])[:, None] * y[i]
                  for i in range(I)) for r in range(ranks[j])]
        img = [sum(A_conv[j][:, i, r][:, None] * wj[r]
                   for r in range(ranks[j])) for i in range(I)]
        outs.append(jnp.stack(img, axis=-1))
    return jnp.stack(outs)
