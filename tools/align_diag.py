"""Alignment diagnostic: where do the blind vote planes lose the oracle?

music_pool (round 3) showed the music 3-stem pool is a POOL failure --
oracle votes reach 10.9 dB min SDR while every blind candidate sits at
~0 dB. This lab isolates WHICH stage loses it, by scoring label/vote
planes directly against the oracle dominance plane (power-weighted bin
accuracy at the best global permutation -- no EM needed, so it runs in
minutes and mostly on device):

  raw        per-frequency k-means labels as they come out of the global
             warm start (global correspondence preserved by construction)
  spectral   after _align_spectral (envelope-correlation graph) -- the
             production path
  oracle-fix labels re-permuted per frequency to best match the oracle
             (upper bound of ANY alignment given these clusters)
  consensus  the production consensus vote plane (argmax)

If raw >> spectral on beat-locked material, the envelope alignment is
actively destroying a good spatial correspondence and a spatial/identity
alignment candidate belongs in the pool.

Usage: python tools/align_diag.py --scenario music3 [--wlen 8192]
       python tools/align_diag.py --scenario reverb --seed 102
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def _acc(lab, oracle_lab, pw, J):
    """Power-weighted accuracy at the best GLOBAL permutation."""
    from itertools import permutations
    best = 0.0
    for p in permutations(range(J)):
        m = np.take(np.array(p), lab) == oracle_lab
        best = max(best, float((m * pw).sum() / pw.sum()))
    return best


def _acc_perfreq(lab, oracle_lab, pw, J):
    """Power-weighted accuracy with a FREE permutation per frequency
    (upper bound for any alignment of these clusters)."""
    from itertools import permutations
    perms = list(permutations(range(J)))
    oh = np.eye(J)[lab] * pw[..., None]                    # (F, N, J)
    T = np.einsum('fnj,fnk->fjk', oh, np.eye(J)[oracle_lab])  # (F, J, J)
    scores = np.stack([T[:, list(p), np.arange(J)].sum(-1)
                       for p in perms], 1)                 # (F, P)
    return float(scores.max(1).sum() / pw.sum())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", default="music3",
                    choices=("music3", "music4", "reverb"))
    ap.add_argument("--wlen", type=int, default=8192)
    ap.add_argument("--seed", type=int, default=100)
    ap.add_argument("--n-seeds", type=int, default=8)
    args = ap.parse_args()

    from pyfasst_jax.tf.stft import STFT
    from pyfasst_jax.models.spatial_init import (
        _align_spectral, _cluster_labels_jax, _vote_consensus,
        consensus_votes, tf_covariance_features,
    )

    if args.scenario.startswith("music"):
        from music_lab import _fixture, FS
        J = 3 if args.scenario == "music3" else 4
        t60 = 0.12 if J == 3 else 0.25
        mix, ys_true, n = _fixture(J, t60, args.seed)
        tft = STFT(wlen=args.wlen, fs=FS)
    else:
        from reverb_lab import make_fixture
        X, Yt, ys_true, mix, tft, n = make_fixture(args.seed)
        J = 4
    if args.scenario.startswith("music"):
        X = np.asarray(tft.computeTransform(mix.astype(np.float32)))

    # oracle dominance plane
    P = []
    for j in range(J):
        Yj = np.asarray(tft.computeTransform(
            np.ascontiguousarray(ys_true[j]).astype(np.float32)))
        P.append((np.abs(Yj) ** 2).sum(-1))
    oracle_lab = np.argmax(np.stack(P), axis=0)

    feat, w, pw, xx = tf_covariance_features(X)
    F, N = pw.shape
    print(f"align_diag: {args.scenario} F {F} N {N} J {J}",
          file=sys.stderr, flush=True)

    labs_all = _cluster_labels_jax(feat, w, J, args.n_seeds, 30)
    labs = [np.asarray(labs_all[s]) for s in range(args.n_seeds)]

    rows = []
    for s, L in enumerate(labs):
        raw = _acc(L, oracle_lab, pw, J)
        ub = _acc_perfreq(L, oracle_lab, pw, J)
        Ls = _align_spectral(L, pw, J)
        spec = _acc(Ls, oracle_lab, pw, J)
        rows.append((raw, spec, ub))
        print(json.dumps({"seed": s, "raw": round(raw, 4),
                          "spectral": round(spec, 4),
                          "oracle_fix_ub": round(ub, 4)}), flush=True)

    # production consensus (spectral) + a raw-label consensus
    v_spec = _vote_consensus([_align_spectral(L, pw, J) for L in labs],
                             pw, J)
    v_raw = _vote_consensus(list(labs), pw, J)
    print(json.dumps({
        "consensus_spectral": round(_acc(np.argmax(v_spec, -1),
                                         oracle_lab, pw, J), 4),
        "consensus_raw": round(_acc(np.argmax(v_raw, -1),
                                    oracle_lab, pw, J), 4),
        "mean_raw": round(float(np.mean([r[0] for r in rows])), 4),
        "mean_spectral": round(float(np.mean([r[1] for r in rows])), 4),
        "mean_ub": round(float(np.mean([r[2] for r in rows])), 4),
    }), flush=True)


if __name__ == "__main__":
    main()
