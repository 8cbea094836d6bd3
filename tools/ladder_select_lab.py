"""Cross-grid agreement as a ladder-candidate selector (round-4 lead).

Every envelope-domain selector fails on beat-locked music (design.md 6e).
This lab tests a structural one: for each fine-stage candidate laddered
to the coarse grid, measure AGREEMENT between its init votes (the fine
separation remapped) and its post-EM dominance votes. Hypothesis: a
candidate whose structure SURVIVES the grid transfer and coarse EM
unchanged captured real structure; degenerate candidates get reorganized
by the coarse EM (their init votes don't fit the coarse-grid likelihood
landscape).

Per draw it reports every ladder run's (true min SDR, agreement,
envcorr, min_share) and three picks: production (tier = fine rank),
max-agreement among unvetoed, and the candidate oracle.

Usage: python tools/ladder_select_lab.py --draws 100 101 102 103 104
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from music_lab import _fixture, FS
from reverb_lab import run_pool


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--draws", type=int, nargs="+",
                    default=[100, 101, 102, 103, 104])
    ap.add_argument("--stems", type=int, default=3)
    ap.add_argument("--t60", type=float, default=None)
    ap.add_argument("--iters", type=int, default=400)
    ap.add_argument("--wfine", type=int, default=2048)
    ap.add_argument("--wcoarse", type=int, default=8192)
    ap.add_argument("--topk", type=int, default=3)
    args = ap.parse_args()
    J = args.stems
    t60 = args.t60 if args.t60 is not None else (0.12 if J == 3 else 0.25)

    from pyfasst_jax.tf.stft import STFT
    from pyfasst_jax.models.reverb import blind_reverb_separate, \
        selection_key
    from pyfasst_jax.models.spatial_init import tf_covariance_features

    wins = {"prod": [], "agree": [], "oracle": []}
    for draw in args.draws:
        mix, ys_true, n = _fixture(J, t60, draw)
        tft_f = STFT(wlen=args.wfine, fs=FS)
        tft_c = STFT(wlen=args.wcoarse, fs=FS)
        XF = np.asarray(tft_f.computeTransform(mix.astype(np.float32)))
        XC = np.asarray(tft_c.computeTransform(mix.astype(np.float32)))
        YtC = np.stack([np.asarray(tft_c.computeTransform(
            np.ascontiguousarray(ys_true[j]).astype(np.float32)))
            for j in range(J)])

        _, info_f = blind_reverb_separate(XF, J, iters=args.iters,
                                          em_seeds=2, reseed_rounds=2,
                                          chunk=12, topk=args.topk)
        tops = info_f["tops"]
        cands, labs = [], {}
        for r_i, rec in enumerate(tops):
            Yf = np.asarray(rec["Y"])
            P = []
            for j in range(J):
                yj = np.asarray(tft_f.invertTransform(Yf[j], nsamples=n))
                Yj = np.asarray(tft_c.computeTransform(
                    np.ascontiguousarray(yj).astype(np.float32)))
                P.append((np.abs(Yj) ** 2).sum(-1))
            lab = np.argmax(np.stack(P), axis=0)
            name = f"ladder{r_i}[{rec['name'].split('|')[0]}]"
            cands.append((name, np.eye(J)[lab]))
            labs[name] = lab

        feat, w, pw, xx = tf_covariance_features(XC)
        recs, _ = run_pool(XC, cands, pw, xx, YtC, args.iters, 2,
                           chunk=args.topk * 2, return_votes=True)
        for r in recs:
            cname = r["name"].split("|")[0]
            lab0 = labs[cname]
            m = (lab0 == r["votes_lab"]).astype(np.float64)
            r["init_agree"] = round(float((m * pw).sum() / pw.sum()), 4)
            r["tier"] = int(cname[6])
            print(json.dumps({k: r[k] for k in (
                "name", "min_sdr_db", "mean_sdr_db", "init_agree",
                "envcorr", "min_share")}), flush=True)

        unvetoed = [r for r in recs if not selection_key(r)[0]]
        pool = unvetoed or recs
        prod = min(pool, key=selection_key)
        agree = max(pool, key=lambda r: r["init_agree"])
        oracle = max(recs, key=lambda r: r["min_sdr_db"])
        wins["prod"].append(prod["min_sdr_db"])
        wins["agree"].append(agree["min_sdr_db"])
        wins["oracle"].append(oracle["min_sdr_db"])
        print(json.dumps({
            "draw": draw,
            "prod_pick": {"name": prod["name"],
                          "min_sdr": prod["min_sdr_db"]},
            "agree_pick": {"name": agree["name"],
                           "min_sdr": agree["min_sdr_db"],
                           "agree": agree["init_agree"]},
            "oracle": {"name": oracle["name"],
                       "min_sdr": oracle["min_sdr_db"]}}), flush=True)

    print(json.dumps({
        "draws": args.draws,
        "prod_median": round(float(np.median(wins["prod"])), 2),
        "agree_median": round(float(np.median(wins["agree"])), 2),
        "oracle_median": round(float(np.median(wins["oracle"])), 2),
        "prod": wins["prod"], "agree": wins["agree"],
        "oracle": wins["oracle"]}), flush=True)


if __name__ == "__main__":
    main()
