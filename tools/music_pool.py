"""Music-scenario pool diagnostic: every blind-init hypothesis on the
music fixtures run to full convergence, oracle-scored, blind stats logged.

music_lab's oracle sweep (round 3) showed the model ceiling on the 3-stem
T60=0.12s fixture is fine -- min SDR 7.1 dB at wlen 2048, 13.1 dB at
wlen 8192 -- while the blind pipeline scores ~0 dB. This lab reuses
reverb_lab's run-everything-and-score machinery on the music fixtures to
separate the two remaining suspects:

  (a) POOL quality: does any candidate in the blind pool converge well?
      (beat-locked envelopes may break the permutation ALIGNMENT itself)
  (b) SELECTION quality: do envcorr / band_coh / min_share still rank
      runs when the TRUE stems share onset envelopes? The oracle-votes
      candidate is included so we see what the stats look like for a
      known-good run.

Usage:
    python tools/music_pool.py --stems 3 --wlen 8192 [--iters 400]
One JSON summary line to stdout; per-run records to --dump (JSONL).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from reverb_lab import run_pool, summarize
from music_lab import _fixture, _oracle_votes, FS

from pyfasst_jax.tf.stft import STFT


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--stems", type=int, default=3, choices=(3, 4))
    ap.add_argument("--t60", type=float, default=None)
    ap.add_argument("--wlen", type=int, default=8192)
    ap.add_argument("--iters", type=int, default=400)
    ap.add_argument("--em-seeds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=100)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--no-oracle", action="store_true")
    ap.add_argument("--dump", default=None)
    args = ap.parse_args()
    t60 = args.t60 if args.t60 is not None else (
        0.12 if args.stems == 3 else 0.25)
    J = args.stems

    mix, ys_true, n = _fixture(args.stems, t60, args.seed)
    tft = STFT(wlen=args.wlen, fs=FS)
    X = np.asarray(tft.computeTransform(mix.astype(np.float32)))
    Yt = np.stack([np.asarray(tft.computeTransform(
        ys_true[j].astype(np.float32))) for j in range(J)])
    F, N = X.shape[:2]
    print(f"music_pool: stems {J} t60 {t60} wlen {args.wlen} "
          f"-> F {F} N {N}", file=sys.stderr, flush=True)

    from pyfasst_jax.models.spatial_init import (
        candidate_votes, consensus_votes, direction_split_candidates,
        realign_votes, tf_covariance_features,
    )
    t0 = time.perf_counter()
    feat, w, pw, xx = tf_covariance_features(X)
    votes = consensus_votes(X, J)
    cands = candidate_votes(votes, pw)
    cands.append(("realign", realign_votes(votes, pw, J)))
    if J > 2:
        cands += direction_split_candidates(X, J, pw)
    if not args.no_oracle:
        cands.append(("oraclevotes", _oracle_votes(tft, ys_true, J)))
    t_pool = time.perf_counter() - t0
    print(f"music_pool: {len(cands)} candidates in {t_pool:.1f}s: "
          f"{[c[0] for c in cands]}", file=sys.stderr, flush=True)

    recs, wall = run_pool(X, cands, pw, xx, Yt, args.iters,
                          args.em_seeds, chunk=args.chunk)
    if args.dump:
        with open(args.dump, "a") as fh:
            for r in recs:
                r["wlen"] = args.wlen
                r["stems"] = J
                fh.write(json.dumps(r) + "\n")
    for r in recs:
        print(json.dumps({k: r.get(k) for k in (
            "name", "min_sdr_db", "mean_sdr_db", "envcorr", "band_coh",
            "min_share", "final_ll", "consistency", "consistency_min")}),
            file=sys.stderr, flush=True)
    s = summarize(args.seed, recs)
    s["wlen"] = args.wlen
    s["stems"] = J
    s["pool_wall_s"] = round(t_pool, 1)
    s["em_wall_s"] = round(wall, 1)
    print(json.dumps(s), flush=True)


if __name__ == "__main__":
    main()
