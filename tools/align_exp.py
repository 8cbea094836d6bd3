"""Alignment strategy experiments on the music fixture (no EM).

align_diag showed the per-frequency clusters carry the sources (oracle
per-frequency fix: 0.77-0.83 power-weighted accuracy) while BOTH
production alignments sit at ~0.5 -- the envelope-correlation signal is
blinded by beat-locked stems. This lab scores alternative cross-frequency
alignment signals directly against the oracle dominance plane:

  centglob   match each frequency's cluster CENTROIDS (power-weighted
             mean of the normalized-covariance features) to global
             k-means centroids over all (f, j) centroid nodes
  centspec   spectral clustering of the centroid-similarity graph
             (same Laplacian machinery, affinity = centroid cosine)
  chain      sequential Sawada-style: align f to the running average of
             the last B aligned frequencies (centroid space)
  combo      affinity = centroid similarity * (1 + envelope correlation)

Usage: python tools/align_exp.py --scenario music3 --wlen 8192
       python tools/align_exp.py --scenario reverb --seed 102
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from align_diag import _acc, _acc_perfreq


def _centroids(feat, pw, lab, J):
    """Power-weighted per-(f, j) centroids in feature space (F, J, D)."""
    oh = np.eye(J)[lab] * pw[..., None]                   # (F, N, J)
    num = np.einsum('fnj,fnd->fjd', oh, feat)
    den = oh.sum(1)[..., None]
    return num / np.maximum(den, 1e-12), oh.sum(1)        # (F,J,D), (F,J)


def _unitrows(a):
    return a / np.maximum(np.linalg.norm(a, axis=-1, keepdims=True), 1e-12)


def align_centglob(feat, pw, lab, J, iters=25, seed=0):
    """Per-f assignment of centroids to global k-means centroids."""
    C, npow = _centroids(feat, pw, lab, J)
    F = C.shape[0]
    nodes = C.reshape(F * J, -1)
    wts = npow.reshape(F * J)
    rng = np.random.default_rng(seed)
    G = nodes[rng.choice(len(nodes), J, replace=False,
                         p=wts / wts.sum())]
    for _ in range(iters):
        d2 = ((nodes[:, None] - G[None]) ** 2).sum(-1)
        a = d2.argmin(1)
        for k in range(J):
            m = a == k
            if m.any():
                G[k] = np.average(nodes[m], axis=0, weights=wts[m] + 1e-12)
    # per-frequency best assignment: maximize -dist
    from pyfasst_jax.models.spatial_init import _best_assignment
    S = -((C[:, :, None, :] - G[None, None]) ** 2).sum(-1)   # (F, J, J)
    sel = _best_assignment(S)
    inv = np.argsort(sel, axis=1)
    return np.take_along_axis(inv, lab, axis=1)


def align_centspec(feat, pw, lab, J, seed=0, env_mix=0.0):
    """Spectral clustering of the centroid-similarity graph; env_mix > 0
    multiplies in (1 + envelope correlation) (the 'combo' variant)."""
    from pyfasst_jax.models.spatial_init import (
        _assignment_from_embedding, _normrows, _spherical_kmeans,
    )
    C, npow = _centroids(feat, pw, lab, J)
    F = C.shape[0]
    nodes = C.reshape(F * J, -1)
    nw = npow.reshape(F * J)
    # gaussian kernel on feature distance, sigma = median pairwise dist
    # (gram expansion: the broadcast form allocates (FJ, FJ, D))
    sq = (nodes ** 2).sum(-1)
    d2 = np.maximum(sq[:, None] + sq[None, :] - 2.0 * (nodes @ nodes.T), 0.0)
    sig2 = np.median(d2[d2 > 0]) + 1e-12
    W = np.exp(-d2 / sig2)
    if env_mix > 0:
        oh = np.eye(J)[lab]
        act = np.einsum('fnj,fn->fjn', oh, pw)
        E = _normrows(np.log1p(
            act / np.maximum(act.mean(-1, keepdims=True), 1e-20)))
        ecorr = np.maximum(E.reshape(F * J, -1) @
                           E.reshape(F * J, -1).T, 0.0)
        W = W * (1.0 + env_mix * ecorr)
    idx = np.arange(F * J).reshape(F, J)
    for f in range(F):
        W[np.ix_(idx[f], idx[f])] = 0.0
    sw = np.sqrt(nw / max(nw.mean(), 1e-20))
    W = W * np.minimum(sw[:, None], 3) * np.minimum(sw[None, :], 3)
    d = W.sum(1) + 1e-9
    Dm = 1.0 / np.sqrt(d)
    L = Dm[:, None] * W * Dm[None, :]
    if F * J <= 4096:
        _, vecs = np.linalg.eigh(L)
        U = vecs[:, -J:]
    else:
        from scipy.sparse.linalg import eigsh
        vals, vecs = eigsh(L, k=J, which="LA")
        U = vecs[:, np.argsort(vals)]
    U = _unitrows(U)
    cent = _spherical_kmeans(U, nw, J, seed=seed)
    sel = _assignment_from_embedding(U, cent, F, J)
    inv = np.argsort(sel, axis=1)
    return np.take_along_axis(inv, lab, axis=1)


def align_chain(feat, pw, lab, J, bw=32):
    """Sequential: align frequency f's centroids to the power-weighted
    running mean of the last `bw` aligned frequencies."""
    from pyfasst_jax.models.spatial_init import _best_assignment
    C, npow = _centroids(feat, pw, lab, J)
    F = C.shape[0]
    # start from the loudest frequency, walk outward both ways
    f0 = int(np.argmax(npow.sum(1)))
    aligned = lab.copy()
    ref = C[f0] * npow[f0][:, None]
    refw = npow[f0][:, None].copy()
    order = list(range(f0 + 1, F)) + [-1] + list(range(f0 - 1, -1, -1))
    refs = {1: (ref.copy(), refw.copy()), -1: (ref.copy(), refw.copy())}
    direction = 1
    for f in order:
        if f == -1:
            direction = -1
            continue
        ref, refw = refs[direction]
        M = ref / np.maximum(refw, 1e-12)
        S = -((C[f][:, None, :] - M[None]) ** 2).sum(-1)[None]  # (1,J,J)
        sel = _best_assignment(S)[0]
        inv = np.argsort(sel)
        aligned[f] = np.take(inv, lab[f])
        Cp = C[f][sel]
        wp = npow[f][sel][:, None]
        decay = 1.0 - 1.0 / bw
        ref *= decay
        refw *= decay
        ref += Cp * wp
        refw += wp
    return aligned


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", default="music3",
                    choices=("music3", "music4", "reverb"))
    ap.add_argument("--wlen", type=int, default=8192)
    ap.add_argument("--seed", type=int, default=100)
    ap.add_argument("--n-seeds", type=int, default=4)
    args = ap.parse_args()

    from pyfasst_jax.tf.stft import STFT
    from pyfasst_jax.models.spatial_init import (
        _align_spectral, _cluster_labels_jax, tf_covariance_features,
    )

    if args.scenario.startswith("music"):
        from music_lab import _fixture, FS
        J = 3 if args.scenario == "music3" else 4
        t60 = 0.12 if J == 3 else 0.25
        mix, ys_true, n = _fixture(J, t60, args.seed)
        tft = STFT(wlen=args.wlen, fs=FS)
        X = np.asarray(tft.computeTransform(mix.astype(np.float32)))
    else:
        from reverb_lab import make_fixture
        X, Yt, ys_true, mix, tft, n = make_fixture(args.seed)
        J = 4

    P = []
    for j in range(J):
        Yj = np.asarray(tft.computeTransform(
            np.ascontiguousarray(ys_true[j]).astype(np.float32)))
        P.append((np.abs(Yj) ** 2).sum(-1))
    oracle_lab = np.argmax(np.stack(P), axis=0)

    feat, w, pw, xx = tf_covariance_features(X)
    print(f"align_exp: {args.scenario} F {pw.shape[0]} N {pw.shape[1]} "
          f"J {J}", file=sys.stderr, flush=True)
    labs_all = _cluster_labels_jax(feat, w, J, args.n_seeds, 30)

    for s in range(args.n_seeds):
        L = np.asarray(labs_all[s])
        row = {"seed": s,
               "raw": _acc(L, oracle_lab, pw, J),
               "ub": _acc_perfreq(L, oracle_lab, pw, J),
               "spectral": _acc(_align_spectral(L, pw, J),
                                oracle_lab, pw, J),
               "centglob": _acc(align_centglob(feat, pw, L, J),
                                oracle_lab, pw, J),
               "centspec": _acc(align_centspec(feat, pw, L, J),
                                oracle_lab, pw, J),
               "combo": _acc(align_centspec(feat, pw, L, J, env_mix=1.0),
                             oracle_lab, pw, J),
               "chain": _acc(align_chain(feat, pw, L, J),
                             oracle_lab, pw, J)}
        print(json.dumps({k: (round(v, 4) if isinstance(v, float) else v)
                          for k, v in row.items()}), flush=True)


if __name__ == "__main__":
    main()
