"""Online / streaming GEM (block-wise with exponential forgetting).

Capability parity with the FASST lineage's online variant (PAPERS.md,
"A general framework for online audio source separation", arXiv:1112.6178;
SURVEY.md §5 long-context row): process the mixture in frame blocks,
maintain exponentially-weighted sufficient statistics, update the
frequency-side parameters (mixing A_j, spectral patterns FB) from the
accumulated statistics while the time activations TW are estimated per
block. Enables long recordings whose full (F, N) plane does not fit in HBM
and latency-bounded streaming separation.

Device shape: one jitted `lax.scan` over blocks (run_gem_online, whole
mixture in memory) OR a host-driven loop over `online_block` fed by
`tf.stft.STFT.stream_blocks` -- the bounded-memory path for recordings
whose (F, N) plane exceeds HBM. Both run the same block body. Any channel
count (I == 2 rides the packed 2x2 fast path, others the square-root
general engine) and any uniform spatial rank:

  - A0 (J, F, I): rank-1 sources (the low-latency streaming use case) --
    the EW spatial statistics collapse to scalars per (j, k, f).
  - A0 (J, F, I, I): FULL-RANK sources (reverberant/diffuse streaming).
    Here the spatial update is the direct Duong-style covariance M-step
    (PAPERS.md "Under-determined reverberant audio source separation
    using a full-rank spatial covariance model", Duong/Vincent/Gribonval
    2010): R_j(f) <- EW-mean_n[ posterior image covariance / v_j(f,n) ],
    re-estimated every block from exponentially-forgotten accumulators.
    The batch engine's sub-source A-form M-step was measured to move
    R_j by only ~0.1%/iteration at the streaming noise floor (EM step
    size vanishes with sigma for covariance shape), far too slow for a
    one-update-per-block regime; the direct covariance update converges
    in O(1) blocks at the same floor. state.A carries a Hermitian square
    root of R_j (closed form for I == 2, eigh otherwise) so downstream
    consumers (E-step, Wiener separation) are unchanged.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from pyfasst_jax.ops.estep import compute_suff_stats


class OnlineState(NamedTuple):
    """Carried across blocks: frequency-side params + EW statistics.

    Rank-1 (A ndim 3) carries the scalar sub-source statistic layout.
    Full-rank (A ndim 4, R == I) reuses the same field names for the
    Duong accumulators: txs holds the EW sum of per-frame posterior image
    covariances / v_j, t4 the EW frame count; tss/t7 are unused (kept as
    zeros so one NamedTuple serves both and the streaming checkpoint
    format stays shape-agnostic)."""
    A: jnp.ndarray          # (J, F, I) rank-1 columns | (J, F, I, I) sqrt R_j
    FB: jnp.ndarray         # (J, F, K) spectral patterns
    txs: jnp.ndarray        # (J, F, I) EW v x w^H | (J, F, I, I) EW Duong Z_j
    tss: jnp.ndarray        # (J, J, F) complex EW v_j v_k w_j w_k^H | zeros
    t4: jnp.ndarray         # (J, F) real: EW v/(1 + v t) | EW frame count
    t7: jnp.ndarray         # (J, J, F) complex EW cross posterior cov | zeros
    fb_num: jnp.ndarray     # (J, F, K) EW numerator of the FB update
    fb_den: jnp.ndarray     # (J, F, K) EW denominator


def _block_estep(Xb, A, FB, TWb, sigma, eps):
    """Rank-1 stats of one block under current params. Returns (stats, v).

    Dispatches on the channel count at trace time like the batch engine:
    I == 2 takes the packed 2x2 fast path, anything else the square-root
    general engine (identical SuffStats structure)."""
    J, F, K = FB.shape
    v = jnp.einsum("jfk,jkn->jfn", FB, TWb)
    A_conv = tuple(A[j][..., None] for j in range(J))    # (F, I, 1)
    if Xb.shape[-1] != 2:
        from pyfasst_jax.ops.engine_general import suff_stats_general
        return suff_stats_general(Xb, v, A_conv, sigma, (1,) * J), v
    from pyfasst_jax.ops import herm
    Rj = jnp.stack([herm.herm_from_mixing(A_conv[j]) for j in range(J)])
    stats = compute_suff_stats(Xb, v, Rj, sigma, (1,) * J, eps=eps,
                               A_conv=A_conv)
    return stats, v


def _fullrank_estep(Xb, R, v, sigma):
    """Duong-style posterior statistics of one block, full-rank sources.

    Xb (F, N, I) complex mixture block; R (J, F, I, I) complex source
    spatial covariances; v (J, F, N) source PSDs; sigma (F,) noise PSD.

    Returns (Z_blk, xi, loglik):
      Z_blk (J, F, I, I): sum_n \\hat{R}_{c_j}(f, n) / v_j(f, n), the Duong
        covariance M-step numerator, computed WITHOUT dividing by v_j --
        the posterior mean image y_j = v_j R_j Sigma_x^-1 x carries a v_j
        factor, so y y^H / v_j = v_j (R_j w)(R_j w)^H with w = Sigma_x^-1 x
        (exact, no 0/0 at silent frames), and the posterior covariance
        term is (I - G_j) v_j R_j / v_j = R_j - v_j R_j Sigma_x^-1 R_j.
      xi (J, F, N): posterior PSD tr(R_j^-1 \\hat{R}_{c_j}) / I for the
        IS-NMF spectral updates. R_j^-1 y_j = v_j w (no explicit inverse)
        and tr(R_j^-1 (I - G_j) v_j R_j) = v_j (I - v_j tr(Sigma_x^-1 R_j))
        by trace similarity-invariance.
      loglik: sum_{f,n} of the Gaussian log-density of the block.

    Dense complex formulation with batched small solves: full-rank R_j has
    no structural zeros (the rank-1 `R_j adj(Sigma_x)` float32 catastrophe
    does not apply) and the sigma floor bounds cond(Sigma_x) <= tr/sigma,
    well inside float32 for the streaming noise_rel floor.
    """
    F, N, I = Xb.shape
    eyeI = jnp.eye(I, dtype=R.dtype)
    Sx = (jnp.einsum("jfn,jfab->fnab", v.astype(R.real.dtype), R)
          + sigma[:, None, None, None] * eyeI)
    w = jnp.linalg.solve(Sx, Xb[..., None])[..., 0]           # (F, N, I)
    # Sigma_x^-1 R_j, batched over (j, f, n): (J, F, N, I, I)
    SinvR = jnp.linalg.solve(
        jnp.broadcast_to(Sx[None], (R.shape[0],) + Sx.shape),
        jnp.broadcast_to(R[:, :, None], (R.shape[0], F, N, I, I)))
    Rw = jnp.einsum("jfab,fnb->jfna", R, w)                   # R_j w
    Z1 = jnp.einsum("jfn,jfna,jfnb->jfab", v, Rw, jnp.conj(Rw))
    Z2 = N * R - jnp.einsum("jfn,jfab,jfnbc->jfac", v, R, SinvR)
    Z_blk = Z1 + Z2
    Z_blk = 0.5 * (Z_blk + jnp.conj(jnp.swapaxes(Z_blk, -1, -2)))
    trSinvR = jnp.einsum("jfnaa->jfn", SinvR).real
    quad = jnp.einsum("fna,jfna->jfn", jnp.conj(w), Rw).real  # w^H R_j w
    xi = (v * v * quad + v * jnp.maximum(I - v * trSinvR, 0.0))
    xi = jnp.maximum(xi / I, 0.0)
    _, ld = jnp.linalg.slogdet(Sx)
    loglik = -(jnp.sum(ld)
               + jnp.sum(jnp.einsum("fna,fna->fn", jnp.conj(Xb), w).real)
               + F * N * I * jnp.log(jnp.pi))
    return Z_blk, xi, loglik


def online_init(A0: jnp.ndarray, FB0: jnp.ndarray) -> OnlineState:
    """Fresh streaming state around initial mixing/pattern guesses.

    A0 complex mixing, either (J, F, I) rank-1 or (J, F, I, I) full-rank
    (square root of the initial spatial covariance R_j = A_j A_j^H,
    re-estimated every block by the Duong covariance M-step); any channel
    count (rank-1 I == 2 takes the packed fast path, others the
    square-root general engine; full-rank runs the dense Duong E-step).
    FB0 (J, F, K) spectral patterns.
    """
    J, F, K = FB0.shape
    if A0.ndim == 4:
        I, R = A0.shape[-2], A0.shape[-1]
        if R != I:
            raise ValueError(
                f"online full-rank path needs square A0 (R == I), got "
                f"rank {R} with {I} channels; use rank-1 (J, F, I) or "
                f"full-rank (J, F, I, I)")
        return OnlineState(
            A=A0, FB=FB0,
            txs=jnp.zeros((J, F, I, I), jnp.complex64),
            tss=jnp.zeros((J, J, F), jnp.complex64),
            t4=jnp.zeros((J, F), jnp.float32),
            t7=jnp.zeros((J, J, F), jnp.complex64),
            fb_num=jnp.zeros((J, F, K), jnp.float32),
            fb_den=jnp.zeros((J, F, K), jnp.float32),
        )
    return OnlineState(
        A=A0, FB=FB0,
        txs=jnp.zeros((J, F, A0.shape[-1]), jnp.complex64),
        tss=jnp.zeros((J, J, F), jnp.complex64),
        t4=jnp.zeros((J, F), jnp.float32),
        t7=jnp.zeros((J, J, F), jnp.complex64),
        fb_num=jnp.zeros((J, F, K), jnp.float32),
        fb_den=jnp.zeros((J, F, K), jnp.float32),
    )


def _herm_sqrt(R):
    """Hermitian PSD square root, batched over leading dims.

    I == 2: closed form sqrtm(R) = (R + sqrt(det R) I) / sqrt(tr R +
    2 sqrt(det R)) (Cayley-Hamilton); general I via eigh."""
    I = R.shape[-1]
    if I == 2:
        det = (R[..., 0, 0].real * R[..., 1, 1].real
               - (R[..., 0, 1] * jnp.conj(R[..., 0, 1])).real)
        s = jnp.sqrt(jnp.maximum(det, 0.0))
        t = jnp.sqrt(jnp.maximum(
            R[..., 0, 0].real + R[..., 1, 1].real + 2.0 * s, 1e-38))
        return ((R + (s[..., None, None]).astype(R.dtype)
                 * jnp.eye(2, dtype=R.dtype))
                / t[..., None, None].astype(R.dtype))
    w, U = jnp.linalg.eigh(R)
    w = jnp.sqrt(jnp.maximum(w, 0.0))
    return jnp.einsum("...ab,...b,...cb->...ac", U, w.astype(U.dtype),
                      jnp.conj(U))


def _fullrank_block_step(state, Xb, TW0, sigma, lam, inner_iters, eps):
    """One full-rank streaming block: Duong covariance EM on EW stats."""
    A, FB = state.A, state.FB
    J, F, K = FB.shape
    I = A.shape[-1]
    Nb = Xb.shape[1]
    R = jnp.einsum("jfar,jfbr->jfab", A, jnp.conj(A))     # (J, F, I, I)

    def inner(i, TWb):
        v = jnp.einsum("jfk,jkn->jfn", FB, TWb)
        _, xi, _ = _fullrank_estep(Xb, R, v, sigma)
        Vc = jnp.maximum(v, 1e-12 * jnp.mean(xi) + eps)
        num = xi / (Vc * Vc)
        den = 1.0 / Vc
        upd = jnp.clip(
            jnp.einsum("jfk,jfn->jkn", FB, num)
            / jnp.maximum(jnp.einsum("jfk,jfn->jkn", FB, den), eps),
            1e-5, 1e5)
        return jnp.maximum(TWb * upd, eps)

    TWb = jax.lax.fori_loop(0, inner_iters, inner, TW0)
    v = jnp.einsum("jfk,jkn->jfn", FB, TWb)
    Z_blk, xi, loglik = _fullrank_estep(Xb, R, v, sigma)

    # Duong covariance M-step on the EW accumulators
    Z = lam * state.txs + Z_blk
    cnt = lam * state.t4 + jnp.float32(Nb)
    R_new = Z / cnt[..., None, None].astype(Z.dtype)
    tr = jnp.einsum("jfaa->jf", R_new).real
    ridge = (1e-6 * jnp.mean(tr) + 1e-30).astype(tr.dtype)
    R_new = R_new + ridge * jnp.eye(I, dtype=R_new.dtype)
    A_new = _herm_sqrt(R_new)

    # online FB update: EW-accumulated IS-NMF numerator/denominator on xi
    Vc = jnp.maximum(v, 1e-12 * jnp.mean(xi) + eps)
    num = xi / (Vc * Vc)
    den = 1.0 / Vc
    fb_num = lam * state.fb_num + jnp.einsum("jfn,jkn->jfk", num, TWb)
    fb_den = lam * state.fb_den + jnp.einsum("jfn,jkn->jfk", den, TWb)
    FB = jnp.maximum(FB * jnp.clip(fb_num / jnp.maximum(fb_den, eps),
                                   1e-2, 1e2), eps)
    s = jnp.maximum(jnp.sum(FB, axis=1, keepdims=True), eps)
    FB = FB / s

    new_state = OnlineState(A=A_new, FB=FB, txs=Z, tss=state.tss,
                            t4=cnt, t7=state.t7,
                            fb_num=fb_num, fb_den=fb_den)
    return new_state, (TWb, loglik)


def _make_block_step(TW0, sigma, lam, inner_iters: int, eps: float):
    """The per-block body shared by the scanned and host-driven paths."""
    J = TW0.shape[0]

    def block_step(state: OnlineState, Xb):
        A, FB = state.A, state.FB
        if A.ndim == 4:       # full-rank path (trace-time dispatch)
            return _fullrank_block_step(state, Xb, TW0, sigma, lam,
                                        inner_iters, eps)
        # Data-scale warm start: TW0 is a fixed random init, so the
        # multiplicative inner updates would have to climb the whole gap
        # between init scale and data scale through their per-iteration
        # clips every block. Power balance sum_i E|x_i|^2 =
        # sum_j v_j tr(R_j) with tr(R_j) = |A_j|^2 ~ 1 (columns are
        # renormalized below) gives the closed-form global gain.
        px = jnp.mean(jnp.sum(jnp.abs(Xb) ** 2, axis=-1))
        v0 = jnp.einsum("jfk,jkn->jfn", FB, TW0)
        pv = jnp.mean(jnp.sum(v0, axis=0))
        TWb = TW0 * (px / jnp.maximum(pv, eps))

        def inner(i, carry):
            TWb, A, FB = carry
            stats, v = _block_estep(Xb, A, FB, TWb, sigma, eps)
            # local TW update (IS-NMF multiplicative, FB fixed)
            Vc = jnp.maximum(v, 1e-12 * jnp.mean(stats.xi) + eps)
            num = stats.xi / (Vc * Vc)
            den = 1.0 / Vc
            upd = jnp.clip(
                jnp.einsum("jfk,jfn->jkn", FB, num)
                / jnp.maximum(jnp.einsum("jfk,jfn->jkn", FB, den), eps),
                1e-5, 1e5)
            TWb = jnp.maximum(TWb * upd, eps)
            return TWb, A, FB

        TWb, _, _ = jax.lax.fori_loop(0, inner_iters, inner, (TWb, A, FB))
        stats, v = _block_estep(Xb, A, FB, TWb, sigma, eps)

        # exponential-forgetting accumulation of the spatial statistics
        txs = lam * state.txs + jnp.stack(
            [stats.Txs[j][:, :, 0] for j in range(J)])
        tss = lam * state.tss + jnp.stack(
            [jnp.stack([stats.Tss[j][k][:, 0, 0] for k in range(J)])
             for j in range(J)])
        t4 = lam * state.t4 + jnp.stack([stats.T4[j] for j in range(J)])
        t7 = lam * state.t7 + jnp.stack(
            [jnp.stack([jnp.zeros_like(tss[0, 0]) if j == k
                        else stats.T7[j][k][:, 0, 0] for k in range(J)])
             for j in range(J)])

        # rank-1 mixing update from EW stats (Gauss-Seidel, per frequency)
        A_new = []
        for j in range(J):
            target = txs[j]                              # (F, 2)
            for k in range(J):
                if k == j:
                    continue
                blk = tss[k, j] - t7[k, j]               # (F,)
                Ak = A_new[k] if k < j else A[k]         # Gauss-Seidel
                target = target - Ak * blk[:, None]
            rss = jnp.real(tss[j, j]) + t4[j]            # (F,)
            ridge = 1e-4 * jnp.mean(rss) + 1e-30
            A_new.append(target / (rss + ridge)[:, None])
        A = jnp.stack(A_new)

        # online FB update: EW-accumulated IS-NMF numerator/denominator
        # (V floored RELATIVE to the observed scale -- an absolute eps floor
        # overflows float32 under V**-2 for dead components, see mstep.py)
        Vc = jnp.maximum(v, 1e-12 * jnp.mean(stats.xi) + eps)
        num = stats.xi / (Vc * Vc)
        den = 1.0 / Vc
        fb_num = lam * state.fb_num + jnp.einsum("jfn,jkn->jfk", num, TWb)
        fb_den = lam * state.fb_den + jnp.einsum("jfn,jkn->jfk", den, TWb)
        # keep the accumulator pair at O(1) magnitude: only the elementwise
        # RATIO feeds the FB update, so a common per-source scale is free --
        # without it num ~ xi/V^2 contributions from near-dead bins compound
        # to float32 inf within ~20 blocks (measured on a gated narrowband
        # fixture; inf/inf then NaNs the whole state).
        c = 1.0 / jnp.maximum(jnp.mean(fb_den, axis=(1, 2), keepdims=True),
                              eps)
        fb_num = fb_num * c
        fb_den = fb_den * c
        FB = jnp.maximum(FB * jnp.clip(fb_num / jnp.maximum(fb_den, eps),
                                       1e-2, 1e2), eps)

        # Inter-factor renormalization (the batch engine rescales between
        # spatial and spectral factors every iteration; without it the
        # gain degeneracy |A_j(f)|^2 v_j(f,n) drifts unboundedly across
        # blocks -- measured: on a gated narrowband fixture A reaches 7e13
        # by block 22 and the EW statistics overflow float32). Normalize
        # each mixing column to unit norm, push the gain g^2 into FB
        # (model-invariant: R_j v_j unchanged), and rescale the EW
        # accumulators by their exact homogeneity degrees in g_j(f) so
        # past statistics stay expressed in the NEW convention:
        # Txs ~ v x w^H -> g; Tss/T7 ~ v_j v_k w_j w_k^H -> g_j g_k;
        # T4 ~ v/(1+vt) -> g^2; fb_num/fb_den ~ xi/V^2, 1/V -> g^-2.
        g = jnp.sqrt(jnp.maximum(
            jnp.sum(jnp.real(A) ** 2 + jnp.imag(A) ** 2, axis=-1), 1e-20))
        A = A / g[..., None].astype(A.dtype)               # (J, F, I)
        gc = g.astype(txs.dtype)
        txs = txs * gc[..., None]
        gjk = (g[:, None, :] * g[None, :, :]).astype(tss.dtype)
        tss = tss * gjk
        t7 = t7 * gjk
        t4 = t4 * g * g
        fb_num = fb_num / (g * g)[..., None]
        fb_den = fb_den / (g * g)[..., None]
        FB = FB * (g * g)[..., None]

        # normalize FB columns, push scale into nothing (TW is per-block)
        s = jnp.maximum(jnp.sum(FB, axis=1, keepdims=True), eps)
        FB = FB / s
        # relative floor (batch mstep's recipe): a column entry that rides
        # the 1e-2 update clip every block otherwise decays geometrically
        # to 0, which parks v at the absolute xi floor and blows up the
        # xi/V^2 numerator. 1e-8 of the column max keeps dead bins
        # revivable and v away from denormals.
        FB = jnp.maximum(FB, 1e-8 * jnp.max(FB, axis=1, keepdims=True))

        new_state = OnlineState(A=A, FB=FB, txs=txs, tss=tss, t4=t4, t7=t7,
                                fb_num=fb_num, fb_den=fb_den)
        return new_state, (TWb, stats.loglik)

    return block_step


@functools.partial(jax.jit, static_argnames=("inner_iters", "eps"))
@jax.default_matmul_precision("highest")
def online_block(state: OnlineState, Xb: jnp.ndarray, TW0: jnp.ndarray,
                 sigma: jnp.ndarray, forgetting: float = 0.9,
                 inner_iters: int = 4, eps: float = 1e-30):
    """Process ONE mixture block host-side: (state, (TWb, loglik)).

    The bounded-memory streaming entry: feed blocks from
    STFT.stream_blocks (same Nb per call => one compiled executable) and
    carry the returned state. Semantics identical to run_gem_online's
    scanned body (shared implementation).
    """
    return _make_block_step(TW0, sigma, forgetting, inner_iters,
                            eps)(state, Xb)


@functools.partial(jax.jit,
                   static_argnames=("n_blocks", "inner_iters", "eps"))
@jax.default_matmul_precision("highest")
def run_gem_online(A0: jnp.ndarray, FB0: jnp.ndarray, TW0: jnp.ndarray,
                   X: jnp.ndarray, sigma: jnp.ndarray,
                   n_blocks: int, forgetting: float = 0.9,
                   inner_iters: int = 4, eps: float = 1e-30):
    """Stream the mixture through `n_blocks` equal blocks (whole X given).

    A0 (J, F, I) complex rank-1 or (J, F, I, I) full-rank (Duong path);
    FB0 (J, F, K); TW0 (J, K, Nb) per-block init;
    X (F, N, I) with N = n_blocks * Nb; sigma (F,) noise PSD (held fixed --
    streaming has no global annealing schedule; pass a moderately small
    floor). Returns (A, FB, TW_all (J, K, N), logliks (n_blocks,)).
    """
    J, F, K = FB0.shape
    Nb = X.shape[1] // n_blocks

    Xblocks = jnp.moveaxis(
        X[:, :n_blocks * Nb].reshape(F, n_blocks, Nb, X.shape[-1]), 1, 0)
    block_step = _make_block_step(TW0, sigma, forgetting, inner_iters, eps)
    state, (TW_all, logliks) = jax.lax.scan(
        block_step, online_init(A0, FB0), Xblocks)
    # (n_blocks, J, K, Nb) -> (J, K, n_blocks * Nb), blocks in time order
    TW_all = jnp.moveaxis(TW_all, 0, 2).reshape(J, TW0.shape[1], -1)
    return state.A, state.FB, TW_all, logliks
