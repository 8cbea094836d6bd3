"""Band-EM pool diagnostic: oracle-score EVERY candidate, with bandem.

The round-4 speech/music chain showed the selection never picking the
bandem candidates even where their vote accuracy beats the production
consensus by +0.1..+0.25 (docs/design.md §6g). Two hypotheses:
(a) the bandem-seeded EM converges to a WORSE separation than the picked
    candidate (votes don't transfer into the basin), or
(b) it converges BETTER but the blind selection cannot see it
    (the known fine-grid selection chaos).
This lab decides: build the exact production pool PLUS bandem (both
band alignments) and noalign, run every (candidate, seed) to full
convergence (reverb_lab.run_pool), and print every run's TRUE min SDR
next to its blind statistics, plus the oracle / selection_key picks.

Usage: python tools/bandem_pool_lab.py --scenario music3 --seeds 100 101
           [--iters 400] [--band-width 32] [--wlen 2048]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from reverb_lab import run_pool, summarize          # noqa: E402


def make_scenario(name: str, seed: int, wlen: int):
    from pyfasst_jax.tf.stft import STFT

    if name.startswith("music"):
        from music_lab import _fixture, FS
        J = 3 if name == "music3" else 4
        t60 = 0.12 if J == 3 else 0.25
        mix, ys_true, n = _fixture(J, t60, seed)
        fs = FS
    elif name == "speech":
        from speech_lab import _fixture, FS
        J = 3
        mix, ys_true, n = _fixture(J, 0.25, seed)
        fs = FS
    elif name == "image":
        from fixtures2 import make_image_fixture
        J = 4
        fs = 16000
        mix, ys_true, _meta = make_image_fixture(seed, fs=fs, dur=6.0, J=J)
    elif name == "reverb":
        # family-1 configs[2] fixture (the gate regime)
        from reverb_lab import make_fixture
        X, Yt, ys_true, mix, tft, n = make_fixture(seed)
        return X, Yt, 4
    else:
        raise SystemExit(f"unknown scenario {name}")
    tft = STFT(wlen=wlen, fs=fs)
    X = np.asarray(tft.computeTransform(mix.astype(np.float32)))
    Yt = np.stack([np.asarray(tft.computeTransform(
        np.ascontiguousarray(ys_true[j]).astype(np.float32)))
        for j in range(J)])
    return X, Yt, J


def build_pool(X, J, band_width: int):
    """The production candidate set of blind_reverb_separate(band_em=W,
    noalign=True) at the default transform."""
    from pyfasst_jax.models.spatial_init import (
        band_em_votes, candidate_votes, consensus_votes,
        direction_split_candidates, tf_covariance_features,
        realign_votes,
    )
    feat, w, pw, xx = tf_covariance_features(X)
    votes = consensus_votes(X, J)
    cands = list(candidate_votes(votes, pw))
    cands.append(("realign", realign_votes(votes, pw, J)))
    cands.append(("noalign", consensus_votes(X, J, align="none")))
    bv = band_em_votes(X, J, band_width=band_width, votes_init=votes,
                       band_align="both")
    cands.append(("bandem", bv["envelope"]))
    cands.append(("bandem-a", bv["init"]))
    if J > 2:
        cands += direction_split_candidates(X, J, pw)
    return cands, pw, xx


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", default="music3",
                    choices=("music3", "music4", "speech", "image",
                             "reverb"))
    ap.add_argument("--seeds", type=int, nargs="+", default=[100, 101])
    ap.add_argument("--iters", type=int, default=400)
    ap.add_argument("--em-seeds", type=int, default=2)
    ap.add_argument("--band-width", type=int, default=32)
    ap.add_argument("--wlen", type=int, default=None)
    ap.add_argument("--chunk", type=int, default=12)
    args = ap.parse_args()
    wlen = args.wlen or (1024 if args.scenario == "image" else 2048)

    for seed in args.seeds:
        X, Yt, J = make_scenario(args.scenario, seed, wlen)
        t0 = time.perf_counter()
        cands, pw, xx = build_pool(X, J, args.band_width)
        t_pool = time.perf_counter() - t0
        recs, wall = run_pool(X, cands, pw, xx, Yt, args.iters,
                              args.em_seeds, chunk=args.chunk)
        for r in recs:
            print(json.dumps({k: r[k] for k in
                              ("name", "min_sdr_db", "mean_sdr_db",
                               "final_ll", "envcorr", "min_share")
                              if k in r}), flush=True)
        s = summarize(seed, recs)
        s.update({"scenario": args.scenario, "seed": seed,
                  "cand_wall_s": round(t_pool, 1),
                  "em_wall_s": round(wall, 1)})
        print(json.dumps(s), flush=True)


if __name__ == "__main__":
    main()
