"""Fused E-step kernel for the GPU (Pallas through Triton; I = 2 channels,
rank-1 and rank-2 sources).

The kernel performs the ENTIRE E-step of estep.compute_suff_stats in one
pass over the (f, n) plane -- mixture covariance assembly,
cancellation-free determinant, y = Sigma_x^-1 x, per-source Wiener images
w_j = A_j^H y, posterior PSDs xi_j, and every frame-reduced statistic
(Txs/Tss/T4/T7/loglik) -- so each (f, n) input element is read from device
memory once and only xi is written back at (f, n) size. The XLA version
materializes ~10 intermediate (F, N) arrays between fusions and launches
one kernel per fusion inside the GEM loop.

The kernel is GENERATED per static rank tuple: complex scalars are (re, im)
pairs of (BF, BN) tiles and the per-source loops unroll over sub-source
columns, so rank-1 (instantaneous/anechoic) and rank-2 (full-rank spatial
covariance) sources share one code path, and the 'ann_ns_inj' noise
injection is a static kernel variant. Numerics are those of estep.py (same
subtract-free determinant and sub-source-coordinate statistics); parity is
tested element-wise on the CPU in interpret mode.

Grid: (ceil(F/BF), ceil(N/BN)), every program independent. Each program
writes the frame sums of its own tile as one column slot of a partial
statistics array (NB, C, Fp); XLA sums the NB frame blocks afterwards, so
no program depends on another's result. Ragged edges are masked loads
(other=0): zero v and x make every reduced statistic (all are v- or
x-weighted) and the padded xi columns self-masking; the log-det term keeps
an explicit frame mask, and padded frequency rows land in the Fp > F tail,
which is sliced off.
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# Tile: BF frequency rows x BN frames, 4 warps -> 4 elements per thread per
# live tile. The generated rank-2 bodies keep dozens of tiles live, so the
# tile is sized for registers (255 per thread), not for shared memory.
BF = 4
BN = 128
NUM_WARPS = 4
# Largest total sub-source count sum(ranks) the generated kernel covers;
# larger models unroll O((sum ranks)^2) live tiles and take the XLA E-step.
MAX_SUBSOURCES = 4


def _cdiv(a, b):
    return -(-a // b)


# -- tiny complex algebra on (re, im) tile pairs --------------------------------
#
# A component may be None, meaning EXACTLY ZERO at trace time: instantaneous
# models have real mixing, so b = sum v_j Re(b_j), the mixing columns, and
# everything derived from them (Sigma_x^-1 A, A^H S^-1 A, ...) carry no
# imaginary part. Propagating the None through the algebra deletes those
# multiplies/adds from the generated kernel (the compiler cannot do it:
# folding x * 0 -> 0 is invalid under IEEE NaN/Inf semantics).

def _m(a, b):
    """a * b with symbolic zero."""
    return None if a is None or b is None else a * b


def _na(a, b):
    """a + b with symbolic zero."""
    if a is None:
        return b
    if b is None:
        return a
    return a + b


def _ns(a, b):
    """a - b with symbolic zero."""
    if b is None:
        return a
    if a is None:
        return -b
    return a - b


def _cmul(x, y):
    return (_ns(_m(x[0], y[0]), _m(x[1], y[1])),
            _na(_m(x[0], y[1]), _m(x[1], y[0])))


def _cconj(x):
    return (x[0], None if x[1] is None else -x[1])


def _cadd(x, y):
    return (_na(x[0], y[0]), _na(x[1], y[1]))


def _csub(x, y):
    return (_ns(x[0], y[0]), _ns(x[1], y[1]))


def _cscale(s, x):
    return (_m(s, x[0]), _m(s, x[1]))


def _cabs2(x):
    return _na(_m(x[0], x[0]), _m(x[1], x[1]))


def _cdot_conj(x, y):
    """conj(x) * y."""
    return (_na(_m(x[0], y[0]), _m(x[1], y[1])),
            _ns(_m(x[0], y[1]), _m(x[1], y[0])))


def stat_layout(ranks: Tuple[int, ...]):
    """Column layout of the kernel's partial-statistics array.

    Returns (n_cols, offsets): offsets maps 'll', ('t4', j), ('txs', j),
    ('tss', j, k) and ('t7', j, k) (j != k) to their first column.
    T4 takes 1 column (rank 1) or 4 (packed Hermitian), Txs 4 per
    sub-source [Re x0 w*, Im x0 w*, Re x1 w*, Im x1 w*], Tss/T7 2 per
    sub-source pair (re, im), row-major over (r, s).
    """
    J = len(ranks)
    off, c = {"ll": 0}, 1
    for j in range(J):
        off[("t4", j)] = c
        c += 1 if ranks[j] == 1 else 4
    for j in range(J):
        off[("txs", j)] = c
        c += 4 * ranks[j]
    for j in range(J):
        for k in range(J):
            off[("tss", j, k)] = c
            c += 2 * ranks[j] * ranks[k]
    for j in range(J):
        for k in range(J):
            if j != k:
                off[("t7", j, k)] = c
                c += 2 * ranks[j] * ranks[k]
    return c, off


def _make_kernel(ranks: Tuple[int, ...], F: int, N: int, bf: int, bn: int,
                 ns_inj: bool = False, real_cov: bool = False):
    J = len(ranks)
    _, off = stat_layout(ranks)

    def kernel(x4_ref, v_ref, A_ref, sig_ref, xi_ref, st_ref):
        i_f, i_n = pl.program_id(0), pl.program_id(1)
        f0, n0 = i_f * bf, i_n * bn
        rvalid = f0 + jnp.arange(bf) < F                  # (bf,)
        cvalid = n0 + jnp.arange(bn) < N                  # (bn,)
        tmask = rvalid[:, None] & cvalid[None, :]
        rows, cols = pl.ds(f0, bf), pl.ds(n0, bn)

        def tile(ref, *lead):
            return plgpu.load(ref.at[(*lead, rows, cols)], mask=tmask,
                              other=0.0)

        def rowvec(ref, *lead, other=0.0):
            """Per-frequency operand as a (bf, 1) column."""
            return plgpu.load(ref.at[(*lead, rows)], mask=rvalid,
                              other=other)[:, None]

        def put(c, t):
            """Frame sum of tile t into statistic column c (None -> 0)."""
            s = (jnp.zeros((bf,), jnp.float32) if t is None
                 else jnp.sum(t, axis=1))
            st_ref[i_n, c, rows] = s

        x0 = (tile(x4_ref, 0), tile(x4_ref, 1))
        x1 = (tile(x4_ref, 2), tile(x4_ref, 3))
        v = [tile(v_ref, j) for j in range(J)]
        # padded rows: sigma 1 keeps every determinant positive there
        sig = rowvec(sig_ref, other=1.0)

        # per-source mixing columns, A_ref layout (J, 4*Rmax, F):
        # sub-source r -> rows [Re a0r, Im a0r, Re a1r, Im a1r]
        Acol = []
        for j in range(J):
            cs = []
            for r in range(ranks[j]):
                o = 4 * r
                cs.append((
                    (rowvec(A_ref, j, o),
                     None if real_cov else rowvec(A_ref, j, o + 1)),
                    (rowvec(A_ref, j, o + 2),
                     None if real_cov else rowvec(A_ref, j, o + 3))))
            Acol.append(cs)

        # Spatial invariants derived in-tile from the mixing columns
        # ((bf, 1) math): packed R_j = A_j A_j^H entries, tr(R_j), and the
        # Lagrange cross terms X_jk = sum_rs |A_j[0,r] A_k[1,s] -
        # A_j[1,r] A_k[0,s]|^2 of the cancellation-free determinant
        # (estep.cross_terms).
        Ra = [sum(_cabs2(Acol[j][r][0]) for r in range(ranks[j]))
              for j in range(J)]
        Rd = [sum(_cabs2(Acol[j][r][1]) for r in range(ranks[j]))
              for j in range(J)]
        Rbr, Rbi = [], []
        for j in range(J):
            prods = [_cmul(Acol[j][r][0], _cconj(Acol[j][r][1]))
                     for r in range(ranks[j])]
            Rbr.append(sum(pr[0] for pr in prods))
            Rbi.append(None if real_cov else sum(pr[1] for pr in prods))
        trR = [Ra[j] + Rd[j] for j in range(J)]
        Xc = {}
        for j in range(J):
            for k in range(J):
                acc = None
                for r in range(ranks[j]):
                    for s_ in range(ranks[k]):
                        c = _csub(_cmul(Acol[j][r][0], Acol[k][s_][1]),
                                  _cmul(Acol[j][r][1], Acol[k][s_][0]))
                        acc = _na(acc, _cabs2(c))
                Xc[(j, k)] = acc

        a = sig + sum(v[j] * Ra[j] for j in range(J))
        d = sig + sum(v[j] * Rd[j] for j in range(J))
        b = (sum(v[j] * Rbr[j] for j in range(J)),
             None if real_cov else sum(v[j] * Rbi[j] for j in range(J)))
        lin = sum(v[j] * trR[j] for j in range(J))
        quad = 0.5 * sum(v[j] * v[k] * Xc[(j, k)]
                         for j in range(J) for k in range(J))
        det = sig * sig + sig * lin + quad
        rinv = 1.0 / det

        def sxi_apply(u0, u1):
            """Sigma_x^-1 @ (u0, u1) via the adjugate [d, -b; -conj(b), a]."""
            y0 = _cscale(rinv, _csub(_cscale(d, u0), _cmul(b, u1)))
            y1 = _cscale(rinv, _csub(_cscale(a, u1), _cmul(_cconj(b), u0)))
            return y0, y1

        y0, y1 = sxi_apply(x0, x1)

        tr_sxi_rxx = jnp.maximum(
            _cdot_conj(x0, y0)[0] + _cdot_conj(x1, y1)[0], 0.0)
        if ns_inj:
            # 'ann_ns_inj': observed covariance becomes x x^H + sigma I
            tr_sxi_rxx = tr_sxi_rxx + sig * (a + d) * rinv
        put(off["ll"], jnp.where(tmask, jnp.log(det) + tr_sxi_rxx, 0.0))

        # w_j,r = A_j[:, r]^H y  and  u_j,r = Sigma_x^-1 A_j[:, r]
        w = [[_cadd(_cmul(_cconj(Acol[j][r][0]), y0),
                    _cmul(_cconj(Acol[j][r][1]), y1))
              for r in range(ranks[j])] for j in range(J)]
        sxiA = [[sxi_apply(Acol[j][r][0], Acol[j][r][1])
                 for r in range(ranks[j])] for j in range(J)]

        for j in range(J):
            trCR = sum(_cabs2(w[j][r]) for r in range(ranks[j]))
            if ns_inj:
                trCR = trCR + sig * sum(
                    _cabs2(sxiA[j][r][0]) + _cabs2(sxiA[j][r][1])
                    for r in range(ranks[j]))

            # leave-one-out S_j entries + cancellation-free determinant
            others = [k for k in range(J) if k != j]
            aS = sig + sum(v[k] * Ra[k] for k in others)
            dS = sig + sum(v[k] * Rd[k] for k in others)
            bS = (sum(v[k] * Rbr[k] for k in others),
                  None if real_cov else sum(v[k] * Rbi[k] for k in others))
            linS = sum(v[k] * trR[k] for k in others)
            quadS = 0.5 * sum(v[k] * v[l] * Xc[(k, l)]
                              for k in others for l in others)
            rinvS = 1.0 / (sig * sig + sig * linS + quadS)

            def sji_apply(u0, u1):
                z0 = _cscale(rinvS, _csub(_cscale(dS, u0), _cmul(bS, u1)))
                z1 = _cscale(rinvS, _csub(_cscale(aS, u1),
                                          _cmul(_cconj(bS), u0)))
                return z0, z1

            # M_rs = A_j[:, r]^H S_j^-1 A_j[:, s]  (R x R Hermitian)
            sjA = [sji_apply(Acol[j][s][0], Acol[j][s][1])
                   for s in range(ranks[j])]
            M = [[_cadd(_cmul(_cconj(Acol[j][r][0]), sjA[s][0]),
                        _cmul(_cconj(Acol[j][r][1]), sjA[s][1]))
                  for s in range(ranks[j])] for r in range(ranks[j])]

            c4 = off[("t4", j)]
            if ranks[j] == 1:
                den = 1.0 + v[j] * M[0][0][0]
                coef = 1.0 / den
                put(c4, v[j] * coef)
            else:
                # G = I_2 + v M (Hermitian PD, det >= 1): closed-form inverse
                g00 = 1.0 + v[j] * M[0][0][0]
                g11 = 1.0 + v[j] * M[1][1][0]
                g01 = _cscale(v[j], M[0][1])
                rG = 1.0 / jnp.maximum(g00 * g11 - _cabs2(g01), 1.0)
                coef = (g00 + g11) * rG
                put(c4, v[j] * g11 * rG)
                put(c4 + 1, v[j] * g00 * rG)
                put(c4 + 2, _m(_m(-v[j], g01[0]), rG))
                put(c4 + 3, _m(_m(-v[j], g01[1]), rG))

            plgpu.store(xi_ref.at[j, rows, cols],
                        (v[j] * v[j] * trCR + v[j] * coef) / ranks[j],
                        mask=tmask)

            # Txs_j = sum_n v_j x w_j^H : per column r -> [x0 w*, x1 w*]
            c = off[("txs", j)]
            for r in range(ranks[j]):
                cw = _cconj(w[j][r])
                p0 = _cmul(x0, cw)
                p1 = _cmul(x1, cw)
                if ns_inj:
                    p0 = _cadd(p0, _cscale(sig, sxiA[j][r][0]))
                    p1 = _cadd(p1, _cscale(sig, sxiA[j][r][1]))
                for comp_ in (p0[0], p0[1], p1[0], p1[1]):
                    put(c, _m(v[j], comp_))
                    c += 1

        for j in range(J):
            for k in range(J):
                vv = v[j] * v[k]
                c = off[("tss", j, k)]
                for r in range(ranks[j]):
                    for s in range(ranks[k]):
                        # Tss: v_j v_k w_j,r conj(w_k,s)
                        pr = _cmul(w[j][r], _cconj(w[k][s]))
                        if ns_inj:
                            # + sigma v_j v_k z_j,r^H z_k,s
                            zc = _cadd(
                                _cdot_conj(sxiA[j][r][0], sxiA[k][s][0]),
                                _cdot_conj(sxiA[j][r][1], sxiA[k][s][1]))
                            pr = _cadd(pr, _cscale(sig, zc))
                        put(c, _m(vv, pr[0]))
                        put(c + 1, _m(vv, pr[1]))
                        c += 2
                if j == k:
                    continue
                c = off[("t7", j, k)]
                for r in range(ranks[j]):
                    for s in range(ranks[k]):
                        # T7: v_j v_k A_j,r^H Sigma_x^-1 A_k,s
                        m = _cadd(
                            _cmul(_cconj(Acol[j][r][0]), sxiA[k][s][0]),
                            _cmul(_cconj(Acol[j][r][1]), sxiA[k][s][1]))
                        put(c, _m(vv, m[0]))
                        put(c + 1, _m(vv, m[1]))
                        c += 2

    return kernel


def pack_x4(X: jnp.ndarray) -> jnp.ndarray:
    """(F, N, 2) complex STFT -> the kernel's (4, F, N) real plane layout.

    X is constant across GEM iterations: callers running a loop pack it
    ONCE outside the loop (run_gem does).
    """
    return jnp.stack([jnp.real(X[..., 0]), jnp.imag(X[..., 0]),
                      jnp.real(X[..., 1]), jnp.imag(X[..., 1])])


@functools.partial(jax.jit, static_argnames=("ranks", "ns_inj", "interpret",
                                             "real_cov", "bf", "bn",
                                             "num_warps"))
def pallas_estep(x4: jnp.ndarray, v: jnp.ndarray, A4: jnp.ndarray,
                 sigma: jnp.ndarray, ranks: Tuple[int, ...],
                 ns_inj: bool = False, interpret: bool = False,
                 real_cov: bool = False, bf: int = BF, bn: int = BN,
                 num_warps: int = NUM_WARPS):
    """Run the fused kernel.

    x4 (4, F, N) packed mixture (pack_x4); v (J, F, N); A4 (J, 4*Rmax, F)
    real mixing rows [Re A0r, Im A0r, Re A1r, Im A1r] per sub-source r;
    sigma (F,). Returns (xi (J, F, N), stats (C, F)) with the columns of
    stat_layout(ranks); the loglik column holds per-frequency sums of
    log det + tr, not yet negated.
    """
    J, F, N = v.shape
    n_cols, _ = stat_layout(ranks)
    nf, nb = _cdiv(F, bf), _cdiv(N, bn)
    xi, st = pl.pallas_call(
        _make_kernel(ranks, F, N, bf, bn, ns_inj=ns_inj, real_cov=real_cov),
        grid=(nf, nb),
        out_shape=[jax.ShapeDtypeStruct((J, F, N), jnp.float32),
                   jax.ShapeDtypeStruct((nb, n_cols, nf * bf), jnp.float32)],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret,
        name="fasst_estep",
    )(x4, v, A4, sigma)
    return xi, jnp.sum(st, axis=0)[:, :F]


def kernel_covers(n_channels: int, ranks: Tuple[int, ...],
                  dtype=jnp.complex64) -> bool:
    """Models the generated kernel covers: a float32 stereo plane (X of
    `dtype`), every source of rank 1 or 2, at most MAX_SUBSOURCES
    sub-sources in all. Everything else takes the XLA E-step."""
    return (n_channels == 2 and jnp.dtype(dtype) == jnp.complex64
            and all(r in (1, 2) for r in ranks)
            and sum(ranks) <= MAX_SUBSOURCES)


def pallas_suff_stats(X, v, Rj, sigma, ranks, A_conv, eps: float = 1e-30,
                      noise_inject: bool = False, interpret: bool = False,
                      x4=None, real_cov: bool = False):
    """Drop-in replacement for estep.compute_suff_stats (ranks in {1, 2}).
    Returns an estep.SuffStats. Pass x4=pack_x4(X) (precomputed once) when
    calling inside a loop; X is then ignored. real_cov=True asserts every
    mixing column is REAL (instantaneous models): the kernel then drops all
    arithmetic on the identically-zero imaginary parts. Rj is implied by
    A_conv (the kernel derives it in-tile) and is accepted for signature
    parity with the XLA E-step."""
    from pyfasst_jax.ops.estep import SuffStats

    assert all(r in (1, 2) for r in ranks)
    ranks = tuple(ranks)
    if x4 is None:
        x4 = pack_x4(X)
    J, F = v.shape[0], v.shape[1]
    Rmax = max(ranks)
    A4 = jnp.stack([
        jnp.concatenate(
            [jnp.stack([jnp.real(A_conv[j][:, 0, r]),
                        jnp.imag(A_conv[j][:, 0, r]),
                        jnp.real(A_conv[j][:, 1, r]),
                        jnp.imag(A_conv[j][:, 1, r])])
             for r in range(ranks[j])]
            + ([jnp.zeros((4 * (Rmax - ranks[j]), F), jnp.float32)]
               if ranks[j] < Rmax else []), axis=0)
        for j in range(J)]).astype(jnp.float32)         # (J, 4*Rmax, F)
    xi, st = pallas_estep(x4, v, A4, sigma, ranks=ranks,
                          ns_inj=noise_inject, interpret=interpret,
                          real_cov=real_cov)
    _, off = stat_layout(ranks)

    def cplx(c, n):
        """n complex (re, im) column pairs from column c -> (F, n)."""
        blk = st[c:c + 2 * n].reshape(n, 2, F)
        return (blk[:, 0] + 1j * blk[:, 1]).T

    Txs = []
    for j in range(J):
        cols = st[off[("txs", j)]:off[("txs", j)] + 4 * ranks[j]]
        cols = cols.reshape(ranks[j], 4, F)               # (R, 4, F)
        Txs.append(jnp.stack([(cols[:, 0] + 1j * cols[:, 1]).T,
                              (cols[:, 2] + 1j * cols[:, 3]).T], axis=1))
    Tss, T7 = [], []
    for j in range(J):
        row_ss, row_7 = [], []
        for k in range(J):
            shape = (F, ranks[j], ranks[k])
            n = ranks[j] * ranks[k]
            row_ss.append(cplx(off[("tss", j, k)], n).reshape(shape))
            row_7.append(None if j == k
                         else cplx(off[("t7", j, k)], n).reshape(shape))
        Tss.append(tuple(row_ss))
        T7.append(tuple(row_7))
    T4 = tuple(st[off[("t4", j)]] if ranks[j] == 1
               else st[off[("t4", j)]:off[("t4", j)] + 4].T
               for j in range(J))
    return SuffStats(xi=jnp.maximum(xi, eps), Txs=tuple(Txs),
                     Tss=tuple(Tss), T4=T4, T7=tuple(T7),
                     loglik=-jnp.sum(st[off["ll"]]))
