"""Combine-instead-of-select: vote consensus ACROSS converged pool runs.

Every selector tried on the music pools fails (envcorr inverts on
beat-locked stems, loglik buries weak sources, cross-seed consistency
rewards stable-but-wrong basins). This lab tests the ensembling
alternative: take all unvetoed tier-0 runs at convergence, permutation-
match each run's per-bin dominance votes to the selection winner's
(global best permutation by power-weighted overlap), MAJORITY-average,
and run one more EM from the consensus votes. Degenerate runs disagree
with each other in different ways; shared structure may be the common
mode (the same consensus trick that makes the clustering init robust
across k-means seeds, lifted to across-candidates-at-convergence).

Reports: consensus-vote accuracy vs oracle dominance plane, accuracy of
each run's own votes, and the oracle-scored EM result from the consensus
vs the production selection pick and the pool oracle.

Usage: python tools/pool_consensus_lab.py --scenario music3 --wlen 2048
       python tools/pool_consensus_lab.py --scenario reverb --seed 102
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from itertools import permutations

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from align_diag import _acc
from reverb_lab import run_pool, summarize


def match_perm(lab, ref_lab, pw, J):
    """Global permutation p maximizing power-weighted overlap of p(lab)
    with ref_lab; returns relabeled lab."""
    best, bp = None, None
    for p in permutations(range(J)):
        m = ((np.take(np.array(p), lab) == ref_lab) * pw).sum()
        if best is None or m > best:
            best, bp = m, p
    return np.take(np.array(bp), lab)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", default="music3",
                    choices=("music3", "music4", "reverb"))
    ap.add_argument("--wlen", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=100)
    ap.add_argument("--iters", type=int, default=400)
    ap.add_argument("--em-seeds", type=int, default=2)
    ap.add_argument("--chunk", type=int, default=8)
    args = ap.parse_args()

    from pyfasst_jax.tf.stft import STFT
    from pyfasst_jax.models.reverb import selection_key
    from pyfasst_jax.models.spatial_init import (
        candidate_votes, consensus_votes, direction_split_candidates,
        realign_votes, tf_covariance_features,
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
        X, _, ys_true, mix, tft, n = make_fixture(args.seed)
        J = 4
    Yt = np.stack([np.asarray(tft.computeTransform(
        np.ascontiguousarray(ys_true[j]).astype(np.float32)))
        for j in range(J)])
    olab = np.argmax((np.abs(Yt) ** 2).sum(-1), axis=0)

    feat, w, pw, xx = tf_covariance_features(X)
    votes = consensus_votes(X, J)
    cands = candidate_votes(votes, pw)
    cands.append(("realign", realign_votes(votes, pw, J)))
    if J > 2:
        cands += direction_split_candidates(X, J, pw)
    print(f"pool_consensus: {len(cands)} candidates", file=sys.stderr,
          flush=True)

    recs, wall = run_pool(X, cands, pw, xx, Yt, args.iters, args.em_seeds,
                          chunk=args.chunk, return_votes=True)
    s = summarize(args.seed, recs)

    def veto(r):
        k = selection_key(r)
        return k[0] or k[1] > 0
    pick = min(recs, key=selection_key)
    members = [r for r in recs if not veto(r)]
    if not members:
        members = recs
    ref = pick["votes_lab"].astype(np.int64)
    acc_members = []
    soft = np.zeros(pw.shape + (J,))
    for r in members:
        lab = match_perm(r["votes_lab"].astype(np.int64), ref, pw, J)
        soft += np.eye(J)[lab]
        acc_members.append(_acc(lab, olab, pw, J))
    soft /= len(members)
    cons_lab = np.argmax(soft, -1)

    out = {
        "scenario": args.scenario, "wlen": args.wlen, "seed": args.seed,
        "members": len(members),
        "acc_members_min": round(float(np.min(acc_members)), 4),
        "acc_members_max": round(float(np.max(acc_members)), 4),
        "acc_pick": round(_acc(ref, olab, pw, J), 4),
        "acc_consensus": round(_acc(cons_lab, olab, pw, J), 4),
        "pick_min_sdr": pick["min_sdr_db"],
        "pool_oracle_min_sdr": s["oracle"]["min_sdr"],
    }
    print(json.dumps(out), flush=True)

    # one EM from the consensus votes (+ the selection pick's own reseed
    # as the baseline the production pipeline would run)
    recs2, _ = run_pool(X, [("poolcons", soft)], pw, xx, Yt, args.iters,
                        args.em_seeds, chunk=2)
    best2 = max(recs2, key=lambda r: r["min_sdr_db"])
    out["consensus_em_min_sdr"] = best2["min_sdr_db"]
    out["consensus_em_mean_sdr"] = best2["mean_sdr_db"]
    print(json.dumps({k: out[k] for k in (
        "acc_consensus", "consensus_em_min_sdr", "consensus_em_mean_sdr",
        "pick_min_sdr", "pool_oracle_min_sdr")}), flush=True)


if __name__ == "__main__":
    main()
