"""Blind full-rank spatial initialization for reverberant mixtures.

The reference pyfasst has no counterpart for this: its DEMIX
(pyfasst/demixTF.py, UNVERIFIED -- mount empty, SURVEY.md §3.4) estimates
ANECHOIC directions, which under late reverb mis-seed the full-rank model.
Round-1 diagnosis on the configs[2] fixture: blind DEMIX-seeded EM reached
0.3/1.6 dB (min/mean SDR) while the SAME model from oracle spatial init
reached 13.5/16.3 dB -- the EM is fine, the init is the whole gap, and the
fixture is genuinely hard (4 sources, 2 distinct directions, one source
6 dB down). This module closes most of that gap blind (≈1.3/8.2 dB).

Recipe (Duong/Sawada lineage: full-rank spatial covariance models with
per-frequency clustering + permutation alignment):

1. Per-(f, n) normalized covariance features [p0, p1, Re x0 x1*, Im x0 x1*]
   / (p0 + p1): invariant to source scale, they encode the local spatial
   signature including the reverberant part (not just a direction).
2. Per-frequency weighted k-means over frames (warm-started from a global
   clustering of a confident subsample) -> labels per (f, n).
3. Permutation alignment ACROSS frequency: within one frequency the cluster
   order is arbitrary; align by correlating per-cluster temporal activity
   envelopes with the global mean envelope, iterated a few sweeps. This is
   solved as an assignment problem per frequency, vectorized over F.
4. CONSENSUS over several k-means seeds: each seed's aligned labels vote;
   two alignment-and-revote rounds make the votes seed-consistent. Single
   seeds are brittle (one bad clustering flips a whole band); the vote
   average is what makes the init robust.
4b. STRUCTURAL REPAIR BY VETOED MODEL EVIDENCE (default): when sources
   share a mixing direction the J-way spatial clustering cannot isolate
   them. Two candidate families fix this -- merge+split hypotheses over
   envelope-correlated cluster pairs (candidate_votes) and
   direction-first hypotheses (cluster into D < J direction groups, then
   split each group's power by KL-NMF over all source allocations --
   direction_split_candidates). Each candidate is probed by a short
   batched GEM run; candidates whose probe separation contains a
   duplicated source (stem-envelope correlation > 0.6) are vetoed, and
   the best remaining log-likelihood wins (select_init_by_likelihood).
   Measured on the configs[2] fixture family over draws 102-104: min SDR
   {3.8, 2.0, 5.6} vs {4.7, -0.8, 0.1} for the single-shot heuristic
   (repair_votes, kept as repair=True).
5. Full-rank R_j(f) = vote-and-power-weighted average of the rank-1 bin
   covariances; its eigendecomposition gives rank-R mixing columns for
   `MultiChanNMFConv(spatial_rank=2, init_mixing=...)`.
6. Optional spectral-envelope profiles (per-source time activity and band
   energy from the votes) to modulate the random TW/FB init -- measured to
   tighten the spread across EM seeds on the hard fixture.

Everything runs on host NumPy at init time (one pass over an (F, N) plane;
the EM itself stays the jitted device program).
"""
from __future__ import annotations

from itertools import permutations
from typing import NamedTuple, Optional, Tuple

import numpy as np

__all__ = [
    "tf_covariance_features", "consensus_votes", "mixing_from_votes",
    "activity_profiles", "full_rank_init", "apply_profiles",
    "repair_votes", "candidate_votes", "select_init_by_likelihood",
    "band_em_votes", "glue_band_perms",
]


def tf_covariance_features(X: np.ndarray):
    """(F, N, I) complex STFT -> (feat, w, pw, xx).

    feat (F, N, I*I): power-normalized covariance entries (scale-invariant
    spatial signature; I diagonal powers then Re/Im of each upper
    off-diagonal); w (F, N): per-frame-normalized power weights;
    pw (F, N): bin power; xx (F, N, I, I): rank-1 bin covariances.
    The I == 2 path is kept verbatim (bit-identical features to the
    measured stereo pipeline); I != 2 takes the general construction.
    """
    I = X.shape[-1]
    if I == 2:
        p0 = np.abs(X[..., 0]) ** 2
        p1 = np.abs(X[..., 1]) ** 2
        cr = X[..., 0] * np.conj(X[..., 1])
        pw = p0 + p1
        feat = np.stack([p0, p1, cr.real, cr.imag], -1) \
            / np.maximum(pw, 1e-20)[..., None]
        w = pw / np.maximum(pw.mean(axis=1, keepdims=True), 1e-20)
        xx = np.stack([np.stack([p0, cr], -1),
                       np.stack([np.conj(cr), p1], -1)], -2)
        return feat, w, pw, xx
    xx = X[..., :, None] * np.conj(X[..., None, :])       # (F, N, I, I)
    pw = np.einsum('...ii->...', xx).real
    cols = [xx[..., i, i].real for i in range(I)]
    for i in range(I):
        for k in range(i + 1, I):
            cols.append(xx[..., i, k].real)
            cols.append(xx[..., i, k].imag)
    feat = np.stack(cols, -1) / np.maximum(pw, 1e-20)[..., None]
    w = pw / np.maximum(pw.mean(axis=1, keepdims=True), 1e-20)
    return feat, w, pw, xx


def _perm_tables(J: int):
    """All J! permutations (P, J) and their inverses (argsort rows)."""
    P = np.array(list(permutations(range(J))), dtype=np.int64)
    return P, np.argsort(P, axis=1)


def _best_assignment(S: np.ndarray) -> np.ndarray:
    """Per-frequency assignment maximizing sum_j S[f, sel[f, j], j].

    S (F, J, J). Enumerates the J! permutations for J <= 6 (vectorized);
    falls back to the Hungarian algorithm per frequency above that.
    Returns sel (F, J) with row f a permutation of range(J).
    """
    F, J, _ = S.shape
    if J <= 6:
        P, _ = _perm_tables(J)
        scores = S[:, P, np.arange(J)].sum(-1)          # (F, J!)
        return P[np.argmax(scores, axis=1)]
    from scipy.optimize import linear_sum_assignment
    sel = np.empty((F, J), np.int64)
    for f in range(F):
        rows, cols = linear_sum_assignment(-S[f])
        sel[f, cols] = rows
    return sel


def _normrows(a: np.ndarray) -> np.ndarray:
    a = a - a.mean(-1, keepdims=True)
    return a / np.maximum(np.linalg.norm(a, axis=-1, keepdims=True), 1e-12)


def _cluster_per_frequency(feat, w, J: int, seed: int,
                           kiter: int = 30, n_warm: int = 8000):
    """Warm-started per-frequency weighted k-means -> labels (F, N)."""
    F, N = feat.shape[:2]
    rng = np.random.default_rng(seed)
    zs = feat.reshape(-1, feat.shape[-1])
    ws = w.reshape(-1)
    sel = rng.choice(len(zs), min(n_warm, len(zs)), replace=False)
    zc, wc = zs[sel], ws[sel]
    C = zc[rng.choice(len(zc), J, replace=False)]
    for _ in range(25):                         # global warm-start k-means
        d2 = ((zc[:, None, :] - C[None]) ** 2).sum(-1)
        lab = d2.argmin(1)
        for j in range(J):
            m = lab == j
            if m.any():
                C[j] = np.average(zc[m], axis=0, weights=wc[m])
    Cf = np.tile(C[None], (F, 1, 1))            # per-frequency refinement
    lab = np.zeros((F, N), np.int64)
    for _ in range(kiter):
        d2 = ((feat[:, :, None, :] - Cf[:, None, :, :]) ** 2).sum(-1)
        lab = d2.argmin(-1)
        onehot = np.eye(J)[lab]
        wm = onehot * w[..., None]
        denom = wm.sum(1)                                        # (F, J)
        num = np.einsum('fnj,fnd->fjd', wm, feat)
        Cf = np.where(denom[..., None] > 1e-8,
                      num / np.maximum(denom, 1e-8)[..., None], Cf)
    return lab


_EMBED_DEVICE_MIN_NODES = 2052

# Node-envelope transform entering the alignment affinity graph.
#   log1p  log of mean-normalized activity (centered cosine ~= log-envelope
#          correlation) -- the transform every configs[2]-gated number used.
#   rank   per-node rank transform (Spearman correlation of envelopes),
#          invariant to each node's unknown compressive scale and immune
#          to the magnitude outliers that dominate a log-envelope dot
#          product on sparse switching material.
# Measured (tools/env_transform_lab.py, real-cluster alignment accuracy):
#   speech s120/121/122:  log1p 0.638/0.464/0.505  rank 0.683/0.549/0.613
#   music3 s100/101/102:  log1p 0.585/0.521/0.555  rank 0.643/0.630/0.511
#   configs[2] 102..106:  log1p mean 0.754         rank mean 0.750 (wash)
# i.e. rank wins on sparse/switching envelopes (speech syllables,
# beat-locked stems), log1p stays default for the smooth sustained
# configs[2] regime (and keeps every gated number bit-identical).
# Module state (like _EMBED_DEVICE_MIN_NODES) so labs can switch it
# globally; `env_transform=` threads it through the public entry points.
_ENV_TRANSFORM = "log1p"


def _env_envelope(a, transform: Optional[str] = None):
    """Apply the configured envelope transform to mean-normalized
    activity `a` (host path). See _ENV_TRANSFORM."""
    tr = _ENV_TRANSFORM if transform is None else transform
    if tr == "log1p":
        return np.log1p(a)
    if tr == "rank":
        return np.argsort(np.argsort(a, axis=-1),
                          axis=-1).astype(np.float64)
    raise ValueError(f"unknown env transform: {tr!r}")


def _embed_nodes(act, pw, pweight: bool = True,
                 env_transform: Optional[str] = None):
    """(F, J, N) per-(frequency, cluster) activity -> eigen-embedding.

    Builds the envelope-correlation affinity graph over the F*J nodes
    (within-frequency edges removed -- those J nodes are distinct sources
    by construction; power-scaled so loud nodes anchor the partition) and
    returns (U (F*J, J): row-normalized top-J normalized-Laplacian
    eigenvectors, npow (F*J,): node powers).

    FJ <= 4096 runs the host NumPy path bit-identical to the measured
    configs[2] pipeline (dense eigh). Above that the whole graph build +
    Lanczos runs ON DEVICE (`_embed_nodes_device`): at music shapes
    (F=4097, J=3 -> 12291 nodes) the host path spends MINUTES per seed in
    the (FJ, FJ) affinity matmul and Laplacian scaling on one CPU core --
    measured 211 s + 70 s -- while the same work is a handful of device
    matmuls."""
    F, J, N = act.shape
    npow = act.sum(-1).reshape(F * J)
    # cutoff = the largest quality-gated scale (configs[2]: F=513, J=4
    # -> 2052 nodes) so every gated robustness number stays bit-identical
    # to the measured host path; anything larger (music grids: 3075 at
    # wlen 2048, 12291 at 8192) takes the device path, where the host
    # spends seconds-to-minutes per seed in dense one-core linear algebra.
    # _EMBED_DEVICE_MIN_NODES is module state so labs can force either
    # path to measure embedding fidelity (tools/speech_align_lab.py).
    if F * J > _EMBED_DEVICE_MIN_NODES:
        U = _embed_nodes_device(act, pweight, env_transform)
        return U, npow
    E = _normrows(_env_envelope(
        act / np.maximum(act.mean(-1, keepdims=True), 1e-20),
        env_transform))
    nodes = E.reshape(F * J, N)
    W = np.maximum(nodes @ nodes.T, 0.0)
    idx = np.arange(F * J).reshape(F, J)
    for f in range(F):
        W[np.ix_(idx[f], idx[f])] = 0.0
    if pweight:
        sw = np.sqrt(npow / max(npow.mean(), 1e-20))
        W = W * np.minimum(sw[:, None], 3) * np.minimum(sw[None, :], 3)
    d = W.sum(1) + 1e-9
    Dm = 1.0 / np.sqrt(d)
    L = Dm[:, None] * W * Dm[None, :]
    _, vecs = np.linalg.eigh(L)
    U = vecs[:, -J:]
    return (U / np.maximum(np.linalg.norm(U, axis=1, keepdims=True),
                           1e-12), npow)


def _lanczos_top(L, k: int, m: int = 64):
    """Top-k eigenvectors of a symmetric device matrix by m-step Lanczos
    with full reorthogonalization (jitted; the tridiagonal eigh is (m, m),
    negligible). Deterministic start vector. Columns ordered ASCENDING by
    eigenvalue, matching np.linalg.eigh's vecs[:, -k:] convention."""
    import jax
    import jax.numpy as jnp

    n = L.shape[0]
    m = min(m, n)

    @jax.jit
    def run(L):
        with jax.default_matmul_precision("highest"):
            # deterministic, dense start: cheap pseudo-random signs keep
            # it non-orthogonal to any particular eigenvector
            i = jnp.arange(n, dtype=jnp.float32)
            q0 = jnp.sin(0.7 * i + 0.31) + 0.01
            q0 = q0 / jnp.linalg.norm(q0)
            Q = jnp.zeros((m, n), L.dtype).at[0].set(q0)
            alphas = jnp.zeros((m,), L.dtype)
            betas = jnp.zeros((m,), L.dtype)

            def body(j, carry):
                Q, alphas, betas = carry
                q = Q[j]
                z = L @ q
                a = jnp.dot(q, z)
                z = z - a * q
                # full reorthogonalization against ALL previous vectors
                # (rows >= j+1 are zero, so the mask is implicit), twice
                # for float32 stability
                z = z - Q.T @ (Q @ z)
                z = z - Q.T @ (Q @ z)
                b = jnp.linalg.norm(z)
                qn = z / jnp.maximum(b, 1e-20)
                Q = jax.lax.cond(j + 1 < m,
                                 lambda Q: Q.at[j + 1].set(qn),
                                 lambda Q: Q, Q)
                return Q, alphas.at[j].set(a), betas.at[j].set(b)

            Q, alphas, betas = jax.lax.fori_loop(
                0, m, body, (Q, alphas, betas))
            T = jnp.diag(alphas) + jnp.diag(betas[:m - 1], 1) \
                + jnp.diag(betas[:m - 1], -1)
            evals, S = jnp.linalg.eigh(T)          # ascending
            U = Q.T @ S[:, -k:]                    # Ritz vectors (n, k)
            return U

    return run(L)


def _embed_nodes_device(act, pweight: bool = True,
                        env_transform: Optional[str] = None):
    """Device (XLA) graph build + Lanczos for `_embed_nodes` at
    large F*J. Matmul precision is pinned to 'highest': the embedding
    feeds clustering/assignment DECISIONS, which reduced-precision
    matmuls flip (CLAUDE.md, "Precision")."""
    import jax
    import jax.numpy as jnp

    F, J, N = act.shape
    n = F * J
    tr = _ENV_TRANSFORM if env_transform is None else env_transform

    @jax.jit
    def build(act):
        with jax.default_matmul_precision("highest"):
            a = act / jnp.maximum(act.mean(-1, keepdims=True), 1e-20)
            if tr == "log1p":
                E = jnp.log1p(a)
            elif tr == "rank":
                E = jnp.argsort(jnp.argsort(a, axis=-1),
                                axis=-1).astype(jnp.float32)
            else:
                raise ValueError(f"unknown env transform: {tr!r}")
            E = E - E.mean(-1, keepdims=True)
            E = E / jnp.maximum(
                jnp.linalg.norm(E, axis=-1, keepdims=True), 1e-12)
            nodes = E.reshape(n, N)
            W = jnp.maximum(nodes @ nodes.T, 0.0)
            same_f = (jnp.arange(n)[:, None] // J) \
                == (jnp.arange(n)[None, :] // J)
            W = jnp.where(same_f, 0.0, W)
            if pweight:
                npow = act.sum(-1).reshape(n)
                sw = jnp.sqrt(npow / jnp.maximum(npow.mean(), 1e-20))
                sw = jnp.minimum(sw, 3)
                W = W * sw[:, None] * sw[None, :]
            d = W.sum(1) + 1e-9
            Dm = 1.0 / jnp.sqrt(d)
            return Dm[:, None] * W * Dm[None, :]

    L = build(jnp.asarray(act, jnp.float32))
    U = np.asarray(_lanczos_top(L, J))
    return U / np.maximum(np.linalg.norm(U, axis=1, keepdims=True), 1e-12)


def _spherical_kmeans(U, npow, J: int, seed: int = 0, iters: int = 25):
    """Power-weighted spherical k-means on embedding rows -> (J, dim)."""
    rng = np.random.default_rng(seed)
    wts = npow / max(npow.sum(), 1e-20)
    cent = U[rng.choice(len(U), J, replace=False, p=wts)]
    for _ in range(iters):
        a = np.argmax(U @ cent.T, 1)
        for k in range(J):
            m = a == k
            if m.any():
                c = np.average(U[m], axis=0, weights=npow[m] + 1e-12)
                cent[k] = c / max(np.linalg.norm(c), 1e-12)
    return cent


def _assignment_from_embedding(U, cent, F: int, J: int):
    """Per-frequency best assignment of that frequency's J nodes to the J
    communities -> sel (F, J)."""
    S = (U @ cent.T).reshape(F, J, J)
    return _best_assignment(S)


def _align_spectral(lab, pw, J: int, pweight: bool = True, seed: int = 0,
                    env_transform: Optional[str] = None):
    """Per-frequency permutation alignment by SPECTRAL CLUSTERING of the
    (frequency, cluster) activity-envelope correlation graph.

    `_align_by_activity` is a mean-field method: every frequency's clusters
    are matched to ONE global envelope template per source. That
    systematically buries narrowband sources -- a source occupying a few
    bins never resembles a global mean envelope dominated by the broadband
    sources, so its bins get permuted into whichever loud source is nearby.
    Measured on the configs[2] fixture family (draws 102-106): activity
    alignment leaves 53-81% of frequencies off the reference permutation
    and blind EM at -2..+1.3 dB min SDR, while this method reaches
    +3.5..+5.9 dB blind (oracle per-frequency alignment: ~8-11 dB).

    Method: each (f, j) cluster is a node with a normalized log activity
    envelope (over frames); affinity = thresholded envelope correlation.
    Normalized-Laplacian eigenvectors (top J) + power-weighted spherical
    k-means give a soft community score per node; the per-frequency
    permutation is the best assignment of that frequency's J nodes to the
    J communities. Transitive envelope-correlation chains connect
    narrowband regions to their source without requiring any single
    global template -- the structural fix over the mean-field anchor.
    """
    F, N = lab.shape
    oh = np.eye(J)[lab]
    act = np.einsum('fnj,fn->fjn', oh, pw)
    U, npow = _embed_nodes(act, pw, pweight, env_transform)
    cent = _spherical_kmeans(U, npow, J, seed=seed)
    sel = _assignment_from_embedding(U, cent, F, J)
    inv = np.argsort(sel, axis=1)
    return np.take_along_axis(inv, lab, axis=1)


def realign_votes(votes: np.ndarray, pw: np.ndarray, J: int,
                  seed: int = 0,
                  env_transform: Optional[str] = None) -> np.ndarray:
    """One more spectral-alignment pass over SOFT consensus votes.

    Re-embeds the per-(frequency, source) soft vote activity (instead of a
    hard label plane) and re-permutes the votes per frequency. This is a
    DIFFERENT estimate, not a refinement: on the configs[2] family it
    rescues draws where the per-seed alignment buried a narrowband source
    (draw 102: min SDR -0.1 -> +3.8..4.1 dB) but can hurt others (draw
    104: 5.0 -> 1.8), so it enters the candidate pool for model-evidence
    selection rather than replacing the per-seed path.
    """
    act = np.einsum('fnj,fn->fjn', votes, pw)
    F = pw.shape[0]
    U, npow = _embed_nodes(act, pw, env_transform=env_transform)
    cent = _spherical_kmeans(U, npow, J, seed=seed)
    sel = _assignment_from_embedding(U, cent, F, J)
    return np.take_along_axis(votes, sel[:, None, :], axis=2)


def _align_by_activity(lab, pw, J: int, sweeps: int = 6):
    """Resolve the per-frequency cluster-order ambiguity.

    Correlates each frequency's per-cluster log-activity envelope (over
    frames) with the global mean envelope and permutes clusters to the
    best assignment; the global envelope re-forms after each sweep.
    """
    F, N = lab.shape
    oh = np.eye(J)[lab]
    act = np.einsum('fnj,fn->fjn', oh, pw)
    A_n = _normrows(np.log1p(
        act / np.maximum(act.mean(-1, keepdims=True), 1e-20)))
    g = A_n.mean(0)
    for _ in range(sweeps):
        g_n = _normrows(g)
        S = np.einsum('fjn,kn->fjk', A_n, g_n)           # (F, J, J)
        sel = _best_assignment(S)                        # (F, J)
        A_n = np.take_along_axis(A_n, sel[:, :, None], axis=1)
        inv = np.argsort(sel, axis=1)
        lab = np.take_along_axis(inv, lab, axis=1)
        g = A_n.mean(0)
    return lab


def _vote_consensus(labs, pw, J: int, rounds: int = 2) -> np.ndarray:
    """Permutation-match each seed's labels to a power-weighted consensus
    and average; `rounds` re-vote passes de-bias the seed-0 start."""
    cons = np.eye(J)[labs[0]] * pw[..., None]
    votes = np.zeros(pw.shape + (J,))
    for _ in range(rounds):
        votes = np.zeros(pw.shape + (J,))
        for L in labs:
            oh = np.eye(J)[L]
            T = np.einsum('fna,fnb->fab', oh, cons)
            sel = _best_assignment(T)
            votes += np.take_along_axis(oh, sel[:, None, :], axis=2)
        cons = votes * pw[..., None]
    return votes / len(labs)


def consensus_votes(X: np.ndarray, J: int, n_seeds: int = 8,
                    kiter: int = 30, rounds: int = 2,
                    backend: str = "jax",
                    align: str = "spectral",
                    env_transform: Optional[str] = None) -> np.ndarray:
    """Soft source-dominance votes (F, N, J) from n_seeds clusterings.

    Each seed clusters and permutation-aligns independently; votes are then
    permutation-matched to a power-weighted consensus and averaged, with
    `rounds` re-vote passes (the first pass's consensus is seed-0 biased).

    align='spectral' (default) resolves each seed's per-frequency cluster
    order by spectral clustering of the envelope-correlation graph
    (`_align_spectral` -- measured +4..+6 dB min SDR over 'activity' on
    the configs[2] family); 'activity' is the older mean-field anchor;
    'none' trusts the warm-started k-means' own cross-frequency
    consistency (centroids come from a GLOBAL subsample, so raw labels
    are already largely globally consistent) -- measured BETTER than
    'spectral' on the image-method omni/ORTF family, where the
    envelope graph is so noisy the alignment destroys consistent labels
    (tools/feat_dereverb_lab.py plain-noalign rows, design.md §6f).

    backend='jax' runs the clustering (all seeds vmapped together) as one
    jitted device program -- on the accelerator this turns a ~40 s host
    init into ~1 s for 'activity'; for 'spectral' the alignment itself stays on host
    (one (F*J)^2 eigendecomposition per seed, ~1 s total) with the
    k-means on device. backend='numpy' is the loop-free host reference
    (and the only path for J > 6, where the device permutation
    enumeration would not fit).
    """
    feat, w, pw, _ = tf_covariance_features(X)
    F, N = pw.shape
    if align in ("spectral", "none"):
        if backend == "jax" and J <= 6:
            labs_all = _cluster_labels_jax(feat, w, J, n_seeds, kiter)
            labs = [np.asarray(labs_all[s]) for s in range(n_seeds)]
        else:
            labs = [_cluster_per_frequency(feat, w, J, seed=s, kiter=kiter)
                    for s in range(n_seeds)]
        if align == "spectral":
            labs = [_align_spectral(L, pw, J, env_transform=env_transform)
                    for L in labs]
        return _vote_consensus(labs, pw, J, rounds)
    if backend == "jax" and J <= 6:
        return _consensus_votes_jax(feat, w, pw, J, n_seeds, kiter, rounds)
    labs = [_align_by_activity(
        _cluster_per_frequency(feat, w, J, seed=s, kiter=kiter), pw, J)
        for s in range(n_seeds)]
    return _vote_consensus(labs, pw, J, rounds)


def _prep_seeds(feat, w, n_seeds: int, J: int, M: int = 8000):
    """Per-seed warm-start subsamples and initial centroids (host RNG)."""
    import jax.numpy as jnp

    zs = feat.reshape(-1, feat.shape[-1]).astype(np.float32)
    ws = w.reshape(-1).astype(np.float32)
    zc, wc, C0 = [], [], []
    for s in range(n_seeds):
        rng = np.random.default_rng(s)
        sel = rng.choice(len(zs), min(M, len(zs)), replace=False)
        zc.append(zs[sel])
        wc.append(ws[sel])
        C0.append(zc[-1][rng.choice(len(sel), J, replace=False)])
    return (jnp.asarray(np.stack(zc)),                # (S, M, 4)
            jnp.asarray(np.stack(wc)),                # (S, M)
            jnp.asarray(np.stack(C0)))                # (S, J, 4)


def _consensus_votes_jax(feat, w, pw, J: int, n_seeds: int,
                         kiter: int, rounds: int) -> np.ndarray:
    """Device implementation: all n_seeds pipelines in one jitted program.

    Same algorithm as the NumPy path (warm-started per-frequency k-means,
    activity alignment, consensus voting); only the random warm-start
    subsampling stays on host. Distances go through the d2 = |z|^2 + |C|^2
    - 2 z.C expansion so the inner product is a matmul instead of a
    (S, F, N, J, 4) broadcast temp. Results can differ from the NumPy
    path only at argmin/argmax ties (measure: identical votes on the
    configs[2] fixture).
    """
    import jax.numpy as jnp

    zc, wc, C0 = _prep_seeds(feat, w, n_seeds, J)
    votes = _consensus_kernel_jax(
        jnp.asarray(feat, jnp.float32), jnp.asarray(w, jnp.float32),
        jnp.asarray(pw, jnp.float32), zc, wc, C0,
        J=J, kiter=kiter, rounds=rounds)
    return np.asarray(votes, np.float64)


_JITTED_LABELS = None


def _cluster_labels_jax(feat, w, J: int, n_seeds: int,
                        kiter: int) -> np.ndarray:
    """All n_seeds warm-started per-frequency k-means label planes as one
    jitted device program -> (S, F, N) int labels on host. The alignment
    stage (host, `_align_spectral`) consumes these; clustering is the
    expensive part and stays on device."""
    global _JITTED_LABELS
    import jax
    import jax.numpy as jnp

    if _JITTED_LABELS is None:
        def impl(feat, w, zc, wc, C0, *, J, kiter):
            with jax.default_matmul_precision("highest"):  # see consensus
                return _kmeans_labels(feat, w, zc, wc, C0, J, kiter)
        _JITTED_LABELS = jax.jit(impl, static_argnames=("J", "kiter"))
    zc, wc, C0 = _prep_seeds(feat, w, n_seeds, J)
    lab = _JITTED_LABELS(jnp.asarray(feat, jnp.float32),
                         jnp.asarray(w, jnp.float32), zc, wc, C0,
                         J=J, kiter=kiter)
    return np.asarray(lab)


def _labels_from_centroids(feat2, C):
    """argmin_j |feat - C_j|^2; feat2 (..., N, 4), C (..., J, 4)."""
    import jax.numpy as jnp
    d = (jnp.sum(C * C, -1)[..., None, :]
         - 2.0 * jnp.einsum('...nd,...jd->...nj', feat2, C))
    return jnp.argmin(d, axis=-1)


_JITTED_CONSENSUS = None


def _consensus_kernel_jax(*args, **kw):
    """Lazily-jitted singleton wrapper (a fresh jax.jit per call would
    retrace every time; jax itself caches by the static args)."""
    global _JITTED_CONSENSUS
    if _JITTED_CONSENSUS is None:
        import jax
        _JITTED_CONSENSUS = jax.jit(
            _consensus_kernel_impl, static_argnames=("J", "kiter", "rounds"))
    return _JITTED_CONSENSUS(*args, **kw)


def _consensus_kernel_impl(feat, w, pw, zc, wc, C0, *, J, kiter, rounds):
    import jax
    import jax.numpy as jnp

    # The k-means distance expansion d2 = |z|^2 + |C|^2 - 2 z.C is
    # cancellation-sensitive: reduced-precision matmul products (TF32 on
    # a GPU) flip argmin labels between near centroids, and unpinned
    # votes were measured to produce a materially worse candidate
    # landscape on the configs[2] fixtures (13/16 hypotheses degenerate
    # vs 8/16). Pin the whole kernel.
    with jax.default_matmul_precision("highest"):
        return _consensus_kernel_pinned(feat, w, pw, zc, wc, C0, J=J,
                                        kiter=kiter, rounds=rounds)


def _kmeans_labels(feat, w, zc, wc, C0, J, kiter):
    """Traced body: warm-started per-frequency weighted k-means over all
    seeds -> labels (S, F, N). Shared by the consensus kernel and the
    labels-only kernel (spectral alignment path)."""
    import jax
    import jax.numpy as jnp

    S = zc.shape[0]
    F, N = feat.shape[:2]
    eye = jnp.eye(J, dtype=jnp.float32)

    def warm_body(_, C):
        lab = _labels_from_centroids(zc, C)            # (S, M)
        oh = eye[lab] * wc[..., None]                  # (S, M, J)
        den = oh.sum(1)                                # (S, J)
        num = jnp.einsum('smj,smd->sjd', oh, zc)
        return jnp.where(den[..., None] > 1e-8,
                         num / jnp.maximum(den, 1e-8)[..., None], C)

    C = jax.lax.fori_loop(0, 25, warm_body, C0)        # (S, J, 4)

    Cf0 = jnp.broadcast_to(C[:, None], (S, F, J, C.shape[-1]))
    wf = w[None, ..., None]                            # (1, F, N, 1)

    def freq_body(_, Cf):
        lab = _labels_from_centroids(feat[None], Cf)   # (S, F, N)
        oh = eye[lab] * wf                             # (S, F, N, J)
        den = oh.sum(2)                                # (S, F, J)
        num = jnp.einsum('sfnj,fnd->sfjd', oh, feat)
        return jnp.where(den[..., None] > 1e-8,
                         num / jnp.maximum(den, 1e-8)[..., None], Cf)

    Cf = jax.lax.fori_loop(0, kiter, freq_body, Cf0)
    return _labels_from_centroids(feat[None], Cf)      # (S, F, N)


def _consensus_kernel_pinned(feat, w, pw, zc, wc, C0, *, J, kiter, rounds):
    import jax
    import jax.numpy as jnp

    S = zc.shape[0]
    F, N = pw.shape
    eye = jnp.eye(J, dtype=jnp.float32)
    P, _ = _perm_tables(J)
    P = jnp.asarray(P)                                 # (J!, J)

    lab = _kmeans_labels(feat, w, zc, wc, C0, J, kiter)

    def normrows(a):
        a = a - a.mean(-1, keepdims=True)
        return a / jnp.maximum(
            jnp.linalg.norm(a, axis=-1, keepdims=True), 1e-12)

    act = jnp.einsum('sfnj,fn->sfjn', eye[lab], pw)
    A_n = normrows(jnp.log1p(
        act / jnp.maximum(act.mean(-1, keepdims=True), 1e-20)))
    g = A_n.mean(1)                                    # (S, J, N)

    def sweep_body(_, carry):
        A_n, lab, g = carry
        g_n = normrows(g)
        Sm = jnp.einsum('sfjn,skn->sfjk', A_n, g_n)    # (S, F, J, J)
        scores = Sm[:, :, P, jnp.arange(J)].sum(-1)    # (S, F, J!)
        sel = P[jnp.argmax(scores, axis=-1)]           # (S, F, J)
        A_n = jnp.take_along_axis(A_n, sel[..., None], axis=2)
        inv = jnp.argsort(sel, axis=-1)
        lab = jnp.take_along_axis(inv, lab, axis=-1)
        return A_n, lab, A_n.mean(1)

    A_n, lab, g = jax.lax.fori_loop(0, 6, sweep_body, (A_n, lab, g))

    oh = eye[lab]                                      # (S, F, N, J)
    cons = oh[0] * pw[..., None]                       # (F, N, J)
    votes = jnp.zeros((F, N, J), jnp.float32)
    for _ in range(rounds):                            # static, tiny
        T = jnp.einsum('sfna,fnb->sfab', oh, cons)
        scores = T[:, :, P, jnp.arange(J)].sum(-1)
        sel = P[jnp.argmax(scores, axis=-1)]           # (S, F, J)
        oh_p = jnp.take_along_axis(oh, sel[:, :, None, :], axis=-1)
        votes = oh_p.sum(0)
        cons = votes * pw[..., None]
    return votes / S


def mixing_from_votes(votes: np.ndarray, xx: np.ndarray, pw: np.ndarray,
                      rank: int = 2) -> np.ndarray:
    """Vote-weighted full-rank covariances -> (J, F, I, rank) mixing columns.

    R_j(f) = sum_n votes * pw * x x^H / sum_n votes * pw, trace-normalized
    to I; the mixing columns are eigenvectors scaled by sqrt(eigenvalues)
    (descending), i.e. R_j = A_j A_j^H exactly at rank = I.
    """
    wv = votes * pw[..., None]
    Rj = np.einsum('fnj,fnab->jfab', wv, xx) / np.maximum(
        wv.sum(1).T[:, :, None, None], 1e-6)
    tr = np.trace(Rj, axis1=2, axis2=3).real
    Rj = Rj / np.maximum(tr[..., None, None], 1e-12) * float(xx.shape[-1])
    lam, V = np.linalg.eigh(Rj)                      # ascending
    lam = np.maximum(lam[..., ::-1], 1e-10)          # descending
    V = V[..., ::-1]
    return (V * np.sqrt(lam)[..., None, :])[..., :rank]


def _nmf_shares(M: np.ndarray, r: int, iters: int = 80, seed: int = 0,
                eps: float = 1e-12, inner_rank: int = 1):
    """Rank-r KL-NMF split of a masked power plane M (F, N).

    inner_rank atoms per component; measured on the configs[2] fixture
    family: inner_rank=1 splits CLEANEST (oracle-direction groups +
    rank-2 split: min SDR 4.7 at inner_rank=1 vs -0.5 at 2 -- extra
    atoms let one component leak onto both sources). Returns (shares
    (F, N, r): soft per-bin fraction of each component, H (r, N):
    per-component temporal activations, summed over inner atoms)."""
    rng = np.random.default_rng(seed)
    F, N = M.shape
    K = r * inner_rank
    W = 0.5 + rng.random((F, K))
    H = 0.5 + rng.random((K, N))
    for _ in range(iters):
        V = W @ H + eps
        W *= ((M / V) @ H.T) / np.maximum(H.sum(1)[None], eps)
        V = W @ H + eps
        H *= (W.T @ (M / V)) / np.maximum(W.sum(0)[:, None], eps)
    P = np.stack([W[:, i::r] @ H[i::r] for i in range(r)], -1) \
        if inner_rank > 1 else np.stack(
            [W[:, i:i + 1] * H[i:i + 1] for i in range(r)], -1)
    # interleaved atom grouping (i::r) keeps init symmetry across comps
    shares = P / np.maximum(P.sum(-1, keepdims=True), eps)
    Hc = np.stack([H[i::r].sum(0) for i in range(r)])
    return shares, Hc


def _nmf_split(M: np.ndarray, iters: int = 80, seed: int = 0,
               eps: float = 1e-12):
    """Rank-2 KL-NMF of a masked power plane M (F, N).

    Returns (share (F, N): soft fraction of component 0 per bin,
    H (2, N): the two temporal activations)."""
    shares, H = _nmf_shares(M, 2, iters=iters, seed=seed, eps=eps,
                            inner_rank=1)
    return shares[..., 0], H


def _merge_split(votes: np.ndarray, pw: np.ndarray, i: int, k: int, c: int,
                 min_balance: float = 0.05, max_hcorr: float = 0.9):
    """One structural repair hypothesis: merge clusters (i, k), then split
    cluster c (c != k; c == i splits the merged cluster) by rank-2 KL-NMF
    of its masked power plane. Returns (votes', hcorr, balance) or None if
    the split is unacceptable (too unbalanced, or the two NMF activations
    are near-copies -- halves of one source, not two sources)."""
    J = votes.shape[-1]
    assert i != k and c != k and 0 <= min(i, k, c) < max(i, k, c) < J
    merged = votes[..., i] + votes[..., k]
    Mc = (merged if c == i else votes[..., c]) * pw
    share, H = _nmf_split(Mc)
    # CENTERED correlation of the two activations: nonnegative activations
    # share a large DC component, so the raw cosine is ~0.9 even for
    # unrelated envelopes and would invert the ranking.
    h = H - H.mean(axis=1, keepdims=True)
    h /= np.maximum(np.linalg.norm(h, axis=1, keepdims=True), 1e-12)
    hcorr = abs(float((h[0] * h[1]).sum()))
    p0 = float((share * Mc).sum())
    p1 = float(((1.0 - share) * Mc).sum())
    bal = min(p0, p1) / max(p0 + p1, 1e-12)
    if bal < min_balance or hcorr > max_hcorr:
        return None
    out = votes.copy()
    out[..., i] = merged
    src = merged if c == i else votes[..., c]
    out[..., k] = src * (1.0 - share)
    out[..., c] = src * share
    return out, hcorr, bal


def _compositions(J: int, D: int):
    """All ways to allocate J sources over D direction groups, each >= 1."""
    if D == 1:
        yield (J,)
        return
    for first in range(1, J - D + 2):
        for rest in _compositions(J - first, D - 1):
            yield (first,) + rest


def direction_split_candidates(X: np.ndarray, J: int, pw: np.ndarray,
                               n_seeds: int = 8, kiter: int = 30,
                               backend: str = "jax", max_alloc: int = 8,
                               n_nmf_seeds: int = 3):
    """Direction-first repair hypotheses for same-direction mixtures.

    When several sources share a mixing direction (the systematic hard
    case: J sources over D < J distinct positions), J-way spatial
    clustering CANNOT produce per-source clusters -- no amount of vote
    repair fixes that, because the information separating the pair is
    spectro-temporal, not spatial. This generates candidates the other
    way around: cluster the spatial features into D < J DIRECTION groups
    (reliable -- the directions are genuinely distinct), then split each
    group's masked power plane into its allocated number of sources by
    rank-k KL-NMF. Every allocation of J over D groups (each >= 1)
    yields one candidate vote array, e.g. J=4, D=2 -> (1,3), (2,2),
    (3,1). The caller disambiguates D and the allocation by model
    evidence (select_init_by_likelihood).
    """
    cands = []
    for D in range(2, J):
        dvotes = consensus_votes(X, D, n_seeds=n_seeds, kiter=kiter,
                                 backend=backend)
        allocs = list(_compositions(J, D))[:max_alloc]
        for alloc in allocs:
            # KL-NMF splits have strong init-dependent local optima; the
            # probing stage is batched (one device program for the whole
            # pool), so emit each allocation under several split seeds --
            # measured necessary on a 3-source 2-direction fixture where
            # the seed-0 split left the pair merged (every candidate
            # vetoed) while other seeds isolate it.
            seeds = range(n_nmf_seeds) if any(k > 1 for k in alloc) \
                else range(1)
            for s in seeds:
                v = np.empty(pw.shape + (J,))
                j0 = 0
                for d, k in enumerate(alloc):
                    if k == 1:
                        v[..., j0] = dvotes[..., d]
                    else:
                        shares, _ = _nmf_shares(dvotes[..., d] * pw, k,
                                                seed=s)
                        v[..., j0:j0 + k] = dvotes[..., d, None] * shares
                    j0 += k
                name = f"dirs{D}+alloc{alloc}" + \
                    (f"#s{s}" if len(list(seeds)) > 1 else "")
                cands.append((name, v))
    return cands


def candidate_votes(votes: np.ndarray, pw: np.ndarray,
                    corr_floor: float = 0.25, max_pairs: int = 3):
    """Enumerate structural repair hypotheses of the blind clustering.

    The single-shot `repair_votes` heuristic picks ONE merge pair (highest
    envelope correlation) and ONE split target (best NMF score) -- on hard
    draws (a weak source sharing its mixing direction with the loudest
    one) the top correlation often flags the WRONG pair, and the weak
    source stays buried. This enumerates instead: for each of the
    `max_pairs` most-envelope-correlated cluster pairs (above
    `corr_floor`) and every acceptable split target, emit the repaired
    vote array. Always includes the unrepaired votes first. The caller
    disambiguates by model evidence (select_init_by_likelihood) rather
    than by heuristic -- measured to recover the weak-source draws that
    single-shot repair misses.
    """
    J = votes.shape[-1]
    cands = [("raw", votes)]
    wv = votes * pw[..., None]
    a = np.einsum('fnj->jn', wv)
    an = a - a.mean(-1, keepdims=True)
    an /= np.maximum(np.linalg.norm(an, axis=-1, keepdims=True), 1e-12)
    corr = an @ an.T
    iu = np.triu_indices(J, 1)
    order = np.argsort(-corr[iu])
    # At small J the pool is cheap and the envelope-correlation ranking of
    # WHICH pair is merged can be wrong (a weak source's envelope hides
    # inside a loud cluster) -- enumerate every pair; at larger J keep the
    # top `max_pairs` above the floor.
    if J <= 4:
        max_pairs, corr_floor = len(iu[0]), -1.0
    for r in order[:max_pairs]:
        i, k = int(iu[0][r]), int(iu[1][r])
        if corr[i, k] < corr_floor:
            break
        for c in range(J):
            if c == k:
                continue
            res = _merge_split(votes, pw, i, k, c)
            if res is not None:
                cands.append((f"merge({i},{k})+split({c})", res[0]))
    return cands


def _max_env_corr(Y):
    """Max pairwise centered correlation of per-source log power envelopes.

    Y (J, F, N, 2) complex separated spectra. Two estimated sources that
    are really HALVES OF ONE source switch on and off together -> their
    envelopes correlate near 1; genuinely distinct sources do not. This
    is the blind degeneracy signal used to veto repair hypotheses (the
    likelihood alone cannot: a fit that models the loud sources finely
    while burying a weak one can out-score a correct 4-source fit).
    """
    import jax
    import jax.numpy as jnp

    with jax.default_matmul_precision("highest"):   # TF32 shifts the corr
        e = jnp.sum(jnp.abs(Y) ** 2, axis=(1, 3))        # (J, N)
        e = jnp.log1p(e / jnp.maximum(e.mean(-1, keepdims=True), 1e-20))
        e = e - e.mean(-1, keepdims=True)
        e = e / jnp.maximum(jnp.linalg.norm(e, axis=-1, keepdims=True),
                            1e-12)
        C = e @ e.T - 2.0 * jnp.eye(e.shape[0], dtype=e.dtype)
        return jnp.max(C)


def _min_band_coherence(Y, n_bands: int = 8, min_bands: float = 1.5):
    """Min over SCOREABLE stems of the power-weighted mean cross-band
    envelope correlation -- a blind FREQUENCY-INTERLEAVING detector.

    Y (J, F, N, I) complex separated spectra. A real source's bands
    co-modulate (one physical excitation drives every band it occupies);
    a stem assembled from per-frequency permutation errors interleaves
    DIFFERENT sources across bands, whose band envelopes do not correlate.
    Complements `_max_env_corr`: duplication raises cross-stem envelope
    correlation, interleaving lowers WITHIN-stem band coherence -- and
    interleaved stems can have beautifully decorrelated time envelopes
    (measured: direction-split candidates on the configs[2] family EM to
    min SDR ~2.5 dB with the LOWEST pool envcorr; their band coherence
    exposes them). Bands are n_bands equal-F slices; correlations are of
    centered log band envelopes; each stem's pairwise correlations are
    weighted by the geometric mean of the two bands' powers.

    NARROWBAND EXEMPTION: an honest stem concentrated in ~one band has no
    cross-band pairs to co-modulate and would score ~0 exactly like an
    interleaved stem (measured on the configs[2] family: the 5-harmonic
    tone's stem scores 0.07-0.14 in GOOD separations). Stems whose band
    power participation ratio (sum w)^2 / sum w^2 is below `min_bands`
    are exempt from the min -- an interleaved stem spans >= 2 effective
    bands by construction, so it always stays scoreable.
    """
    import jax.numpy as jnp

    coh, pr = _band_coherence_stats(Y, n_bands)
    scoreable = pr >= min_bands
    # if every stem is narrowband there is nothing to flag: return 1
    return jnp.min(jnp.where(scoreable, coh, 1.0))


def _band_coherence_stats(Y, n_bands: int = 8):
    """Per-stem (coherence (J,), band participation ratio (J,)); see
    `_min_band_coherence`."""
    import jax
    import jax.numpy as jnp

    with jax.default_matmul_precision("highest"):   # decision-feeding stat
        J, F, N, I = Y.shape
        Fb = F - F % n_bands
        p = jnp.sum(jnp.abs(Y[:, :Fb]) ** 2, axis=3)       # (J, Fb, N)
        pb = p.reshape(J, n_bands, Fb // n_bands, N).sum(2)  # (J, B, N)
        w = pb.sum(-1)                                      # (J, B)
        e = jnp.log1p(pb / jnp.maximum(pb.mean(-1, keepdims=True), 1e-20))
        e = e - e.mean(-1, keepdims=True)
        e = e / jnp.maximum(jnp.linalg.norm(e, axis=-1, keepdims=True),
                            1e-12)
        C = jnp.einsum('jbn,jcn->jbc', e, e)                # (J, B, B)
        wgm = jnp.sqrt(w[:, :, None] * w[:, None, :])
        off = 1.0 - jnp.eye(n_bands, dtype=e.dtype)
        num = jnp.sum(C * wgm * off, axis=(1, 2))
        den = jnp.maximum(jnp.sum(wgm * off, axis=(1, 2)), 1e-20)
        pr = (w.sum(-1) ** 2) / jnp.maximum((w ** 2).sum(-1), 1e-20)
        return num / den, pr


def select_init_by_likelihood(X: np.ndarray, cands, xx, pw,
                              rank: int = 2, probe_iters: int = 60,
                              nmf_comps: int = 6, fs: int = 16000,
                              env_thr: float = 0.6,
                              verbose: bool = False, n_devices: int = 1):
    """Pick the repair hypothesis by vetoed model evidence.

    Each candidate vote array seeds a full-rank model (mixing + activity
    profiles); a short `probe_iters` GEM run scores it. Selection is
    two-stage, both stages blind:

    1. VETO candidates whose probe separation contains a duplicated
       source (max pairwise stem-envelope correlation > `env_thr`) --
       measured on the configs[2] fixture family, every candidate with a
       failed source had envelope corr >= 0.63 and every healthy one
       <= 0.58 while the probe LOG-LIKELIHOOD ranked several degenerate
       fits on top (a weak source is cheap to bury).
    2. Among survivors, pick the max final probe log-likelihood (same
       data, identical parameter counts -- directly comparable). If
       nothing survives, fall back to the lowest-correlation candidate.

    Returns (A_init, tw_prof, fb_prof, best_name). All probes and their
    separations run as ONE batched device program each (identical
    shapes; the batched-GEM executable is the configs[4] path).
    """
    import jax
    import jax.numpy as jnp

    from pyfasst_jax.models.components import (
        CONV, FasstParams, SpatialComp, init_nmf_comp,
    )
    from pyfasst_jax.parallel.sharding import (
        batch_params, batched_run_gem, make_mesh,
    )
    from pyfasst_jax.utils.config import GEMConfig
    import jax.numpy as jnp

    J = cands[0][1].shape[-1]
    Xd = jnp.asarray(np.ascontiguousarray(X))
    scale = float(np.sqrt(np.mean(np.abs(X) ** 2)))
    Xd = Xd / scale
    cfg = GEMConfig(niter=probe_iters, spatial_hold_frac=0.3)
    key = jax.random.PRNGKey(0)
    keys = list(jax.random.split(key, J))
    F, N = X.shape[:2]

    inits, plist = [], []
    for name, v in cands:
        A = mixing_from_votes(v, xx, pw, rank=rank)
        twp, fbp = activity_profiles(v, pw)
        spat = tuple(SpatialComp(A=jnp.asarray(A[j]), mix_type=CONV)
                     for j in range(J))
        spec = tuple(init_nmf_comp(keys[j], F, N, nmf_comps, spat_ind=j)
                     for j in range(J))
        plist.append(apply_profiles(FasstParams(spat=spat, spec=spec),
                                    twp, fbp))
        inits.append((name, A, twp, fbp))
    # all probes run as ONE batched device program (identical shapes; the
    # batched-GEM executable is the configs[4] path, cached per cfg)
    from pyfasst_jax.ops.gem import annealing_endpoints
    from pyfasst_jax.parallel.sharding import sharded_batch_separate

    C = len(plist)
    mesh = make_mesh(n_devices)
    # pad the probe batch to a multiple of the mesh's dp axis (padded
    # slots repeat the first probe; their scores are sliced off below)
    dp = mesh.shape.get("dp", 1)
    Cp = ((C + dp - 1) // dp) * dp
    params_b = batch_params(plist + [plist[0]] * (Cp - C))
    X_b = jnp.broadcast_to(Xd, (Cp,) + Xd.shape)
    params_out, lls = batched_run_gem(params_b, X_b, cfg, mesh)
    lls = np.asarray(lls[:C, -1], np.float64)
    _, sigma1 = annealing_endpoints(Xd, cfg)
    Y_b = sharded_batch_separate(params_out, X_b,
                                 jnp.broadcast_to(sigma1, (Cp,)
                                                  + sigma1.shape), mesh)
    ec = np.asarray(jax.jit(jax.vmap(_max_env_corr))(Y_b),
                    np.float64)[:C]
    ok = ec <= env_thr
    if verbose:
        for (name, *_), ll, e in zip(inits, lls, ec):
            print(f"select_init: {name}: probe ll {ll:.1f} envcorr {e:.3f}"
                  f"{'' if e <= env_thr else '  [vetoed]'}")
    if not ok.any():
        # No hypothesis isolates all J sources. Measured meaning (J=3
        # fixture, a 9.7%-energy source sharing its direction with the
        # loudest): even 93%-accurate dominance votes cannot seed an EM
        # that keeps the weak source -- the data genuinely does not
        # support J distinguishable sources at this SNR. Say so.
        import warnings
        warnings.warn(
            "spatial_init: every repair hypothesis left a duplicated "
            f"source (min stem-envelope corr {ec.min():.2f} > "
            f"{env_thr}); the mixture may not support "
            f"{cands[0][1].shape[-1]} separable sources -- expect one "
            "duplicated/empty stem, or retry with fewer sources.",
            stacklevel=2)
        pick = int(np.argmin(ec))        # least-degenerate fallback
    else:
        lls_m = np.where(ok, lls, -np.inf)
        pick = int(np.argmax(lls_m))
    name, A, twp, fbp = inits[pick]
    return A, twp, fbp, name


class BandProbes(NamedTuple):
    """Converged band-local EM probe products (see _band_em_probes)."""
    starts: tuple          # band start bins (last band may overlap)
    Fb: int                # band width in bins
    pick: np.ndarray       # (B,) winning run index per band (by loglik)
    lab: np.ndarray        # (C, Fb, N) converged Wiener dominance labels
    env: np.ndarray        # (C, J, N) converged per-stem envelopes
    ll: np.ndarray         # (C,) final log-likelihoods
    names: tuple           # (band, em_seed) per run
    votes_init: np.ndarray  # (F, N, J) the init vote plane used
    feat: np.ndarray       # tf_covariance_features of the full plane
    w: np.ndarray
    pw: np.ndarray
    xx: np.ndarray


def _band_em_probes(X: np.ndarray, J: int, *, band_width: int = 32,
                    iters: int = 150, nmf_comps: int = 3, rank: int = 2,
                    votes_init: Optional[np.ndarray] = None,
                    n_seeds: int = 8, em_seeds: int = 2,
                    env_transform: Optional[str] = None,
                    n_devices: int = 1, seed: int = 0,
                    verbose: bool = False) -> BandProbes:
    """Steps 1-3 of band_em_votes: run a full GEM per frequency band
    (all (band, spectral-seed) runs in one batched device program),
    pick each band's seed by final log-likelihood, and return the
    converged dominance labels / envelopes for the alignment emitters
    (band_em_votes) and the gluing scorer (glue_band_perms)."""
    import jax
    import jax.numpy as jnp

    from pyfasst_jax.models.components import (
        CONV, FasstParams, SpatialComp, init_nmf_comp,
    )
    from pyfasst_jax.ops.gem import annealing_endpoints
    from pyfasst_jax.parallel.sharding import (
        batch_params, batched_run_gem, make_mesh, sharded_batch_separate,
    )
    from pyfasst_jax.utils.config import GEMConfig
    import jax.numpy as jnp

    F, N, I = X.shape
    feat, w, pw, xx = tf_covariance_features(X)
    if votes_init is None:
        votes_init = consensus_votes(X, J, n_seeds=n_seeds,
                                     env_transform=env_transform)

    Fb = min(band_width, F)
    starts = list(range(0, F - Fb + 1, Fb))
    if starts[-1] + Fb < F:
        starts.append(F - Fb)
    B = len(starts)

    # per-(band, seed) params + per-band normalized spectra
    names, plist, xlist = [], [], []
    for bi, s0 in enumerate(starts):
        sl = slice(s0, s0 + Fb)
        vb, pwb, xxb = votes_init[sl], pw[sl], xx[sl]
        A = mixing_from_votes(vb, xxb, pwb, rank=rank)
        twp, fbp = activity_profiles(vb, pwb)
        scale = float(np.sqrt(np.mean(np.abs(X[sl]) ** 2))) or 1.0
        Xb = np.ascontiguousarray(X[sl]) / scale
        for es in range(em_seeds):
            keys = list(jax.random.split(
                jax.random.PRNGKey(seed + 1000 * es + bi), J))
            spat = tuple(SpatialComp(A=jnp.asarray(A[j]),
                                     mix_type=CONV) for j in range(J))
            spec = tuple(init_nmf_comp(keys[j], Fb, N, nmf_comps,
                                       spat_ind=j) for j in range(J))
            plist.append(apply_profiles(
                FasstParams(spat=spat, spec=spec), twp, fbp))
            xlist.append(Xb)
            names.append((bi, es))

    mesh = make_mesh(n_devices)
    dp = mesh.shape.get("dp", 1)
    C = len(plist)
    Cp = ((C + dp - 1) // dp) * dp
    plist = plist + [plist[0]] * (Cp - C)
    xlist = xlist + [xlist[0]] * (Cp - C)
    params_b = batch_params(plist)
    X_b = jnp.asarray(np.stack(xlist))
    cfg = GEMConfig(niter=iters, spatial_hold_frac=0.3)

    se_fn = jax.jit(jax.vmap(lambda Xi: annealing_endpoints(Xi, cfg)))
    s0_b, s1_b = se_fn(X_b)
    params_b, lls = batched_run_gem(params_b, X_b, cfg, mesh,
                                    sigma_endpoints_b=(s0_b, s1_b))
    Y_b = sharded_batch_separate(params_b, X_b, s1_b, mesh)

    @jax.jit
    def stats(Y):
        p = jnp.sum(jnp.abs(Y) ** 2, axis=4)           # (C, J, Fb, N)
        lab = jnp.argmax(p, axis=1)                    # (C, Fb, N)
        env = jnp.sum(p, axis=2)                       # (C, J, N)
        return lab.astype(jnp.int32), env

    lab_b, env_b = stats(Y_b)
    lab_b = np.asarray(lab_b)[:C]
    env_b = np.asarray(env_b, np.float64)[:C]
    ll = np.asarray(lls[:C, -1], np.float64)

    # per-band best spectral seed by final loglik
    pick = np.full(B, -1, np.int64)
    best = np.full(B, -np.inf)
    for i, (bi, es) in enumerate(names):
        if ll[i] > best[bi]:
            best[bi], pick[bi] = ll[i], i
    if verbose:
        print(f"band_em_votes: {B} bands x {em_seeds} seeds, "
              f"ll range {ll.min():.1f}..{ll.max():.1f}")
    return BandProbes(starts=tuple(starts), Fb=Fb, pick=pick, lab=lab_b,
                      env=env_b, ll=ll, names=tuple(names),
                      votes_init=votes_init, feat=feat, w=w, pw=pw, xx=xx)


def glue_band_perms(X: np.ndarray, J: int, probes: BandProbes, *,
                    glue_iters: int = 20, nmf_comps: int = 2,
                    rank: int = 2, fixed_spatial: bool = True,
                    n_devices: int = 1, seed: int = 0,
                    chunk: int = 128, verbose: bool = False):
    """MODEL-EVIDENCE pairwise band gluing (docs/design.md §6i).

    MEASURED AND REJECTED as a quality lever (round 4, kept for the
    catalogue): with fixed_spatial=True + 20 iters (the honest form,
    below) the glue reaches pair_acc 1.0/0.75 on the mini configs[2]
    draws but NEVER strictly beats the best existing aligner on any
    hard draw (image 0.06-0.31 vs init's 0.25-0.50; music3 ties init;
    reverb ties), chaining amplifies its single-link errors into
    global misalignment, and the loglik margins carry no confidence
    signal (median margin on WRONG links exceeds right links on 6 of
    8 hard draws). Full table in design.md §6i; this closed the last
    untried cross-band alignment family.

    For each ADJACENT band pair (b, b+1) and each relative permutation
    rho of band b+1's converged stems against band b's, run a SHORT
    joint EM over the two-band slab, seeded from the GLUED dominance
    votes (band b's labels below, rho-permuted band b+1's labels
    above), and pick rho by final log-likelihood. All (pair, rho) runs
    share the batched configs[4] executable in chunked device programs.

    Why this can see what the rejected aligners cannot: within a pair
    every rho fits the SAME slab data with the SAME spectral seeds, so
    the final logliks are directly comparable, and the only cross-band
    tying in the FASST model is the spectral factors (conv mixing is
    per-frequency) -- a correct glue lets nmf_comps shared time
    activations explain both bands' dominance patterns, a wrong glue
    forces them to cover two different sources' time structure.
    Per-bin spatial signatures (saturated, §6f) and pooled envelopes
    (noisy, §6f) never enter the decision.

    Known risk (measured, tools/glue_lab.py): converged likelihoods can
    be blind to permutations when the model has enough freedom to
    specialize per band -- free-spatial glue EMs measured WORSE the
    longer they run (mini draws: pair_acc 0.375 at 40 iters, 0.0-0.125
    at 80; wrong glues won confidently) because per-frequency conv
    mixing lets the spatial side absorb any glue. fixed_spatial=True
    freezes the spatial comps at the vote-derived mixing so the
    likelihood can only move through the SHARED spectral factors --
    the coupling the glue hypothesis is about. SHORT EMs (glue_iters)
    and small nmf_comps keep the expressivity penalty of a wrong glue
    alive either way. The overlap bins of a ragged last band are
    double-counted in its pair's slab (evidence only; harmless).

    Returns (perms, margins): perms (B-1, J) with perms[p][a] = stem of
    band p+1 glued to stem a of band p; margins (B-1,) the loglik gap
    between the winning rho and the runner-up (small margin = weak
    link; diagnostic).
    """
    import jax

    from pyfasst_jax.models.components import (
        CONV, FasstParams, SpatialComp, init_nmf_comp,
    )
    from pyfasst_jax.ops.gem import annealing_endpoints
    from pyfasst_jax.parallel.sharding import (
        batch_params, batched_run_gem, make_mesh,
    )
    from pyfasst_jax.utils.config import GEMConfig
    import jax.numpy as jnp

    starts, Fb, pick = probes.starts, probes.Fb, probes.pick
    B = len(starts)
    pw, xx = probes.pw, probes.xx
    P, Pinv = _perm_tables(J)
    nP = len(P)

    plist, xlist = [], []
    for pi in range(B - 1):
        sl0 = slice(starts[pi], starts[pi] + Fb)
        sl1 = slice(starts[pi + 1], starts[pi + 1] + Fb)
        lab0 = probes.lab[pick[pi]]
        lab1 = probes.lab[pick[pi + 1]]
        Xs = np.concatenate([X[sl0], X[sl1]], axis=0)
        xxs = np.concatenate([xx[sl0], xx[sl1]], axis=0)
        pws = np.concatenate([pw[sl0], pw[sl1]], axis=0)
        scale = float(np.sqrt(np.mean(np.abs(Xs) ** 2))) or 1.0
        Xs = np.ascontiguousarray(Xs) / scale
        v0 = np.eye(J)[lab0]
        # same spectral seeds for every rho within a pair: logliks
        # differ only through the glue hypothesis
        keys = list(jax.random.split(jax.random.PRNGKey(seed + pi), J))
        for ri in range(nP):
            v1 = np.eye(J)[Pinv[ri][lab1]]
            votes = np.concatenate([v0, v1], axis=0)       # (2Fb, N, J)
            A = mixing_from_votes(votes, xxs, pws, rank=rank)
            twp, fbp = activity_profiles(votes, pws)
            spat = tuple(SpatialComp(A=jnp.asarray(A[j]),
                                     mix_type=CONV,
                                     free=not fixed_spatial)
                         for j in range(J))
            spec = tuple(init_nmf_comp(keys[j], 2 * Fb, votes.shape[1],
                                       nmf_comps, spat_ind=j)
                         for j in range(J))
            plist.append(apply_profiles(
                FasstParams(spat=spat, spec=spec), twp, fbp))
            xlist.append(Xs)

    mesh = make_mesh(n_devices)
    dp = mesh.shape.get("dp", 1)
    cfg = GEMConfig(niter=glue_iters, spatial_hold_frac=0.3)
    nruns = len(plist)
    lls = np.full(nruns, -np.inf)
    se_fn = None
    for c0 in range(0, nruns, chunk):
        pc = plist[c0:c0 + chunk]
        xc = xlist[c0:c0 + chunk]
        Cc = len(pc)
        Cp = ((Cc + dp - 1) // dp) * dp
        pc = pc + [pc[0]] * (Cp - Cc)
        xc = xc + [xc[0]] * (Cp - Cc)
        params_b = batch_params(pc)
        X_b = jnp.asarray(np.stack(xc))
        if se_fn is None:
            se_fn = jax.jit(jax.vmap(
                lambda Xi: annealing_endpoints(Xi, cfg)))
        s0_b, s1_b = se_fn(X_b)
        _, ll_b = batched_run_gem(params_b, X_b, cfg, mesh,
                                  sigma_endpoints_b=(s0_b, s1_b))
        lls[c0:c0 + Cc] = np.asarray(ll_b[:Cc, -1], np.float64)
    llm = lls.reshape(B - 1, nP)
    order = np.argsort(llm, axis=1)[:, ::-1]
    perms = P[order[:, 0]]
    margins = llm[np.arange(B - 1), order[:, 0]] \
        - llm[np.arange(B - 1), order[:, 1]]
    if verbose:
        print(f"glue_band_perms: {B - 1} pairs x {nP} perms, "
              f"margins {margins.min():.2f}..{margins.max():.2f}")
    return perms, margins


def _chain_glue(perms: np.ndarray, J: int) -> np.ndarray:
    """Compose pairwise gluings into a global band alignment.

    inv[b][a] = output channel of band b's stem a; band 0 anchors the
    channels, then inv[b+1][a'] = inv[b][rho^-1[a']] for each glued
    pair (one wrong link misaligns everything above it -- the margins
    say which links are weak)."""
    B = perms.shape[0] + 1
    inv = np.zeros((B, J), np.int64)
    inv[0] = np.arange(J)
    for b in range(B - 1):
        inv[b + 1] = inv[b][np.argsort(perms[b])]
    return inv


def band_em_votes(X: np.ndarray, J: int, *, band_width: int = 32,
                  iters: int = 150, nmf_comps: int = 3, rank: int = 2,
                  votes_init: Optional[np.ndarray] = None,
                  n_seeds: int = 8, em_seeds: int = 2,
                  env_transform: Optional[str] = None,
                  band_align: str = "envelope",
                  glue_iters: int = 20,
                  n_devices: int = 1, seed: int = 0,
                  probes: Optional[BandProbes] = None,
                  return_detail: bool = False,
                  verbose: bool = False):
    """Per-bin votes from BAND-LOCAL EM probes (model-evidence pooling).

    The fine-grid blind vote quality is capped by per-bin covariance
    features that saturate at ~0 dB direct-to-reverb (docs/design.md
    §6e); the one measured signal that beats any initial blind alignment
    is a converged run's OWN dominance votes (0.64 vs 0.56 accuracy,
    pool-consensus finding). This pools that evidence at band scale:

    1. Split F into `band_width`-bin bands (last band overlaps to fit).
    2. Run a FULL GEM per band -- all (band, spectral-seed) runs in one
       batched device program (the configs[4] executable) -- seeded from
       the production consensus votes restricted to the band. Within a
       band there is no cross-frequency permutation problem for the EM
       to inherit beyond the init's local errors, which the EM is
       measured to clean.
    3. Per band pick the spectral seed by final log-likelihood (same
       data within a band -- directly comparable).
    4. Align BANDS (B nodes instead of F) by spectral clustering of
       their at-convergence source envelopes -- far fewer, far cleaner
       nodes than the per-frequency activity graph.
    5. Per-bin votes = the aligned bands' Wiener dominance one-hots
       (overlapped bins average).

    Returns votes (F, N, J) for the candidate pool (the tiered
    selection arbitrates against the clustering candidates).

    band_align picks step 4's cross-band matching:
    - 'envelope' (the measured default): re-cluster the B band nodes by
      their at-convergence envelopes -- can FIX global permutation
      errors the init carried, but inherits the envelope-alignment
      failure regime (image family, §6f).
    - 'init': permute each band's converged stems to agree with the
      band's own INIT votes (power-weighted label agreement). The init
      votes are already globally aligned, so this preserves the init's
      global structure and uses the EM only to clean local errors --
      immune to envelope noise, blind to global init errors.
    - 'spatial': align bands on their converged stems' SPATIAL feature
      centroids -- each (band, stem) node is the dominance-weighted
      mean of the normalized covariance features (the same space the
      global clustering runs in) over the whole band, then J-community
      spherical k-means with the per-band all-different assignment
      (the envelope alignment's machinery, envelope-free node
      features). MEASURED AND REJECTED as a quality lever (round 4,
      kept for the catalogue): with ORACLE dominance labels the band
      feature centroids align only 30/72 adjacent-band pairs on the
      mini configs[2] draw and 134-164/272 on image seeds 202-203 --
      the cross-frequency spatial signal saturates even after
      band-level power pooling, so no assignment machinery on top can
      work (a greedy edge-covariance chain variant measured 0.66 vs
      the envelope alignment's 0.92 before this). Do not re-try
      without a feature that is actually comparable across bands.
    - 'glue': MODEL-EVIDENCE pairwise gluing (glue_band_perms): a short
      joint EM per adjacent band pair and relative permutation, link
      picked by final likelihood, links chained from band 0. The one
      alignment family whose decision statistic is neither a per-bin
      spatial signature nor a pooled envelope — MEASURED AND REJECTED
      round 4 (never strictly beats init/envelope on any hard draw,
      margins uninformative; docs/design.md §6i has the full table).
      Kept for the catalogue; never enters the production pool.
    - 'both': envelope + init vote planes from the SAME EM probes (the
      probes dominate the cost) -> dict {mode: votes}; the caller
      enters each as its own pool candidate and selection arbitrates.
    - 'all': envelope + init + spatial planes -> dict.
    - 'all+glue': all four planes -> dict.

    return_detail=True additionally returns {"probes": BandProbes,
    "inv": {mode: (B, J) band alignment}} for diagnostics/labs; pass a
    precomputed `probes` to reuse one probe set across calls (the
    probes dominate the cost).
    """
    if probes is None:
        probes = _band_em_probes(
            X, J, band_width=band_width, iters=iters,
            nmf_comps=nmf_comps, rank=rank, votes_init=votes_init,
            n_seeds=n_seeds, em_seeds=em_seeds,
            env_transform=env_transform, n_devices=n_devices,
            seed=seed, verbose=verbose)
    F, N = X.shape[:2]
    starts, Fb, pick = probes.starts, probes.Fb, probes.pick
    lab_b, env_b = probes.lab, probes.env
    feat, pw, votes_init = probes.feat, probes.pw, probes.votes_init
    B = len(starts)

    def _emit(inv):
        votes = np.zeros((F, N, J))
        counts = np.zeros((F, 1, 1))
        for b, s0 in enumerate(starts):
            lab = inv[b][lab_b[pick[b]]]                 # (Fb, N)
            votes[s0:s0 + Fb] += np.eye(J)[lab]
            counts[s0:s0 + Fb] += 1.0
        return votes / counts

    out, invs = {}, {}
    if band_align in ("envelope", "both", "all", "all+glue"):
        # cross-band alignment on the at-convergence envelopes
        act = np.stack([env_b[pick[b]] for b in range(B)])   # (B, J, N)
        pwb = np.stack([pw[s0:s0 + Fb].sum(0) for s0 in starts])
        U, npow = _embed_nodes(act, pwb, env_transform=env_transform)
        cent = _spherical_kmeans(U, npow, J, seed=seed)
        sel = _assignment_from_embedding(U, cent, B, J)
        invs["envelope"] = np.argsort(sel, axis=1)           # (B, J)
        out["envelope"] = _emit(invs["envelope"])
    if band_align in ("init", "both", "all", "all+glue"):
        # anchor each band to its own (globally aligned) init votes:
        # permutation maximizing power-weighted agreement between the
        # converged dominance labels and the band's init vote mass
        inv = np.zeros((B, J), np.int64)
        for b, s0 in enumerate(starts):
            oh = np.eye(J)[lab_b[pick[b]]]               # (Fb, N, J)
            wv = votes_init[s0:s0 + Fb] * pw[s0:s0 + Fb, :, None]
            T = np.einsum('fna,fnb->ab', oh, wv)[None]   # (1, J, J)
            # sel[j] = converged label assigned to init channel j;
            # invert so inv[converged label] = init channel
            inv[b] = np.argsort(_best_assignment(T)[0])
        invs["init"] = inv
        out["init"] = _emit(inv)
    if band_align in ("spatial", "all", "all+glue"):
        # (band, stem) nodes = dominance-weighted covariance-feature
        # centroids over the WHOLE band; J-community spherical k-means
        # + per-band all-different assignment. Decision path: host
        # float64 (the decision never sees a reduced-precision matmul).
        D = feat.shape[-1]
        nodes = np.zeros((B, J, D))
        npow_s = np.zeros((B, J))
        for b, s0 in enumerate(starts):
            sl = slice(s0, s0 + Fb)
            lab = lab_b[pick[b]]                           # (Fb, N)
            wts = np.asarray(pw[sl], np.float64)
            fb = np.asarray(feat[sl], np.float64)
            for k in range(J):
                m = (lab == k) * wts
                tot = float(m.sum())
                if tot > 0:
                    nodes[b, k] = np.einsum('fn,fnd->d', m, fb) / tot
                npow_s[b, k] = tot
        U = nodes.reshape(B * J, D)
        U = U / np.maximum(
            np.linalg.norm(U, axis=1, keepdims=True), 1e-12)
        cent = _spherical_kmeans(U, npow_s.reshape(-1), J, seed=seed)
        sel = _assignment_from_embedding(U, cent, B, J)
        invs["spatial"] = np.argsort(sel, axis=1)
        out["spatial"] = _emit(invs["spatial"])
    if band_align in ("glue", "all+glue"):
        # glue EMs keep their own measured operating point (fixed
        # spatial, short, small K) -- NOT the probe stage's knobs
        perms, margins = glue_band_perms(
            X, J, probes, glue_iters=glue_iters, rank=rank,
            n_devices=n_devices, seed=seed, verbose=verbose)
        invs["glue"] = _chain_glue(perms, J)
        out["glue"] = _emit(invs["glue"])
    if not out:
        raise ValueError(f"band_align must be envelope|init|spatial|"
                         f"glue|both|all|all+glue, got {band_align!r}")
    multi = band_align in ("both", "all", "all+glue")
    res = out if multi else out[band_align]
    if return_detail:
        return res, {"probes": probes, "inv": invs}
    return res


def repair_votes(votes: np.ndarray, pw: np.ndarray,
                 corr_thr: float = 0.6, min_balance: float = 0.05,
                 max_hcorr: float = 0.9, verbose: bool = False
                 ) -> np.ndarray:
    """Fix the two systematic failure modes of blind spatial clustering.

    When sources share a mixing direction (common: two instruments at the
    same position, or a 4-source mixture over 2 distinct directions), the
    spatial features cannot tell them apart: the clustering then (a) MERGES
    the same-direction pair into one cluster and (b) SPLITS some loud
    source across two clusters to fill the count. Detected and repaired
    from the votes alone:

    - split-source pair: two clusters whose temporal activity envelopes
      correlate above `corr_thr` (halves of one source switch on and off
      together; distinct sources do not) -> merge them;
    - over-merged cluster: the remaining cluster whose masked power plane
      best factors into TWO spectro-temporally distinct components
      (rank-2 KL-NMF; score = activation decorrelation x power balance)
      -> split its votes by the per-bin component shares.

    Each pass performs one merge+split; passes repeat until no pair
    crosses `corr_thr` (at most J//2). If no candidate cluster splits
    acceptably (balance >= `min_balance`, activation correlation <=
    `max_hcorr`), the merge is NOT performed -- repair never reduces the
    effective source count. Measured on the configs[2] fixture family:
    min SDR -1.9 -> +3.7 on the draw where clustering merged the
    same-direction pair, +1.3 -> +6.7 on an easier draw (means 8.5/11.5),
    stable across EM seeds.
    """
    J = votes.shape[-1]
    votes = votes.copy()
    for _ in range(max(J // 2, 1)):
        wv = votes * pw[..., None]
        a = np.einsum('fnj->jn', wv)
        an = a - a.mean(-1, keepdims=True)
        an /= np.maximum(np.linalg.norm(an, axis=-1, keepdims=True), 1e-12)
        corr = an @ an.T
        np.fill_diagonal(corr, -2.0)
        i, k = np.unravel_index(np.argmax(corr), corr.shape)
        if corr[i, k] < corr_thr:
            break
        merged = votes[..., i] + votes[..., k]
        best = None
        for c in range(J):
            if c == k:
                continue
            Mc = (merged if c == i else votes[..., c]) * pw
            share, H = _nmf_split(Mc)
            # CENTERED correlation of the two activations: nonnegative
            # activations share a large DC component, so the raw cosine
            # is ~0.9 even for unrelated envelopes and would invert the
            # ranking (two halves of one source must score ~1, two real
            # sources ~0 -- only the centered correlation does that).
            h = H - H.mean(axis=1, keepdims=True)
            h /= np.maximum(np.linalg.norm(h, axis=1, keepdims=True), 1e-12)
            hcorr = abs(float((h[0] * h[1]).sum()))
            p0 = float((share * Mc).sum())
            p1 = float(((1.0 - share) * Mc).sum())
            bal = min(p0, p1) / max(p0 + p1, 1e-12)
            score = (1.0 - hcorr) * bal
            if best is None or score > best[0]:
                best = (score, c, share, hcorr, bal)
        score, c, share, hcorr, bal = best
        if bal < min_balance or hcorr > max_hcorr:
            break                        # no acceptable split: keep as-is
        if verbose:
            print(f"repair_votes: merge ({i},{k}) corr={corr[i, k]:.2f}; "
                  f"split {c} (hcorr={hcorr:.2f}, balance={bal:.2f})")
        votes[..., i] = merged
        src = merged if c == i else votes[..., c]
        votes[..., k] = src * (1.0 - share)
        votes[..., c] = src * share
    return votes


def activity_profiles(votes: np.ndarray, pw: np.ndarray,
                      floor: float = 0.3):
    """Per-source (time, band) energy profiles from the votes.

    Returns (tw_prof (J, N), fb_prof (J, F)), each normalized to peak 1
    and floored (floor + (1-floor) * profile): used to MODULATE the random
    TW/FB init, not replace it -- a hard spectral init from masked power
    fights the annealing schedule's scale assumptions (tested: it hurts),
    while a floored modulation only biases which components listen to
    which frames/bands.
    """
    tw = np.einsum('fnj,fn->jn', votes, pw)
    tw /= np.maximum(tw.mean(-1, keepdims=True), 1e-20)
    tw = floor + (1.0 - floor) * tw / np.maximum(
        tw.max(-1, keepdims=True), 1e-20)
    fb = np.einsum('fnj,fn->jf', votes, pw)
    fb /= np.maximum(fb.mean(-1, keepdims=True), 1e-20)
    fb = floor + (1.0 - floor) * fb / np.maximum(
        fb.max(-1, keepdims=True), 1e-20)
    return tw, fb


def full_rank_init(X: np.ndarray, J: int, n_seeds: int = 8,
                   rank: int = 2, kiter: int = 30, backend: str = "jax",
                   repair="select", probe_iters: int = 60,
                   verbose: bool = False, n_devices: int = 1
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One-shot blind full-rank initialization.

    X (F, N, I) complex mixture STFT; returns (A_init (J, F, I, rank),
    tw_prof (J, N), fb_prof (J, F)). Feed A_init to
    `MultiChanNMFConv(spatial_rank=rank, init_mixing=A_init)` and the
    profiles to `apply_profiles`. backend: see consensus_votes (the two
    paths produce identical votes on the configs[2] fixture; 'jax' is
    ~13x faster warm but pays a one-time per-shape compile).

    repair -- how to resolve same-direction cluster merge/split failures:
      'select' (default): enumerate merge+split hypotheses
        (candidate_votes) and pick by a `probe_iters`-iteration GEM
        probe's final log-likelihood -- model evidence instead of a
        heuristic; costs ~n_candidates probe runs on device.
      True: single-shot heuristic (repair_votes).
      False: no repair (sources known spatially distinct).
    """
    feat, w, pw, xx = tf_covariance_features(X)
    votes = consensus_votes(X, J, n_seeds=n_seeds, kiter=kiter,
                            backend=backend)
    if repair == "select":
        cands = candidate_votes(votes, pw)
        if J > 2:
            cands = cands + direction_split_candidates(
                X, J, pw, n_seeds=n_seeds, kiter=kiter, backend=backend)
        if len(cands) == 1:
            v = cands[0][1]
            A = mixing_from_votes(v, xx, pw, rank=rank)
            twp, fbp = activity_profiles(v, pw)
            return A, twp, fbp
        A, twp, fbp, name = select_init_by_likelihood(
            X, cands, xx, pw, rank=rank, probe_iters=probe_iters,
            verbose=verbose, n_devices=n_devices)
        if verbose:
            print(f"full_rank_init: selected {name} of {len(cands)}")
        return A, twp, fbp
    if repair:
        votes = repair_votes(votes, pw, verbose=verbose)
    A = mixing_from_votes(votes, xx, pw, rank=rank)
    tw_prof, fb_prof = activity_profiles(votes, pw)
    return A, tw_prof, fb_prof


def apply_profiles(params, tw_prof: Optional[np.ndarray] = None,
                   fb_prof: Optional[np.ndarray] = None):
    """Modulate each source's TW/FB init by its activity profiles.

    params: FasstParams whose spec components map one-to-one to sources
    (spat_ind == source index). Returns the new FasstParams.
    """
    import dataclasses

    import jax.numpy as jnp

    spec = []
    for comp in params.spec:
        j = comp.spat_ind
        kw = {}
        if tw_prof is not None:
            kw["TW"] = comp.TW * jnp.asarray(tw_prof[j][None, :],
                                             comp.TW.dtype)
        if fb_prof is not None:
            kw["FB"] = comp.FB * jnp.asarray(fb_prof[j][:, None],
                                             comp.FB.dtype)
        spec.append(dataclasses.replace(comp, **kw))
    return dataclasses.replace(params, spec=tuple(spec))
