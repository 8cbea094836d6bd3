"""Fine-grid self-ladder lab: re-run the spectral alignment on
AT-CONVERGENCE votes — does it close the fine-grid vote-quality gap?

Motivation (design.md §6e): the multiscale ladder's binding constraint is
fine-grid vote accuracy (blind 0.56 vs the clustering's own per-frequency
oracle-fix UB 0.74 on music draw 100). Two measured facts point at one
untried move:

  - scrambled-ORACLE labels realign to 0.75 — the spectral alignment
    recovers the full UB when the node envelopes are clean;
  - a run's at-convergence dominance votes are MORE accurate than any
    initial blind alignment (0.64 vs 0.56): EM cleans LOCAL partition
    errors (hence cleaner node envelopes) but cannot repair GLOBAL
    permutation structure.

So: EM@fine -> realign the at-convergence votes spectrally -> EM@fine
again ("self-ladder"), before the usual multiscale ladder up. This lab
measures each stage against the oracle:

  v0        blind consensus votes (production)            [~0.56]
  EM0       at-convergence votes of EM from v0            [~0.64]
  EM0_ub    per-frequency oracle-fix UB of EM0's votes — the HEADROOM:
            if ~= EM0's acc, no per-frequency permutation error is left
            and the whole idea is dead; if well above, realignment has
            something to recover.
  r1        _align_spectral applied to EM0's labels       [the experiment]
  EM1       EM from r1 (acc, min SDR, r2 = realign again)
  ladder    optionally: EM1's best images -> coarse votes -> EM@8192,
            vs the production ladder rungs (blind-up 1.99 dB, rs 2.26).

acc = power-weighted agreement with the oracle dominance plane at the
best GLOBAL permutation (align_diag._acc); ub = free permutation per
frequency (align_diag._acc_perfreq).

Usage: python tools/fine_realign_lab.py [--seed 100] [--iters 400]
           [--em-seeds 2] [--ladder] [--stems 3]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from align_diag import _acc, _acc_perfreq
from ladder_lab import _votes_from_images
from music_lab import _fixture, FS
from reverb_lab import run_pool


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--stems", type=int, default=3, choices=(3, 4))
    ap.add_argument("--t60", type=float, default=None)
    ap.add_argument("--iters", type=int, default=400)
    ap.add_argument("--seed", type=int, default=100)
    ap.add_argument("--em-seeds", type=int, default=2)
    ap.add_argument("--wfine", type=int, default=2048)
    ap.add_argument("--wcoarse", type=int, default=8192)
    ap.add_argument("--ladder", action="store_true",
                    help="run the coarse rung from EM1's best images")
    ap.add_argument("--rounds", type=int, default=1,
                    help="self-ladder rounds (realign+EM) to chain")
    args = ap.parse_args()
    J = args.stems
    t60 = args.t60 if args.t60 is not None else (0.12 if J == 3 else 0.25)

    from pyfasst_jax.tf.stft import STFT
    from pyfasst_jax.models.reverb import selection_key
    from pyfasst_jax.models.spatial_init import (
        _align_spectral, consensus_votes, tf_covariance_features,
    )

    mix, ys_true, n = _fixture(J, t60, args.seed)
    tftF = STFT(wlen=args.wfine, fs=FS)
    XF = np.asarray(tftF.computeTransform(mix.astype(np.float32)))
    YtF = np.stack([np.asarray(tftF.computeTransform(
        np.ascontiguousarray(ys_true[j]).astype(np.float32)))
        for j in range(J)])
    olabF = np.argmax((np.abs(YtF) ** 2).sum(-1), axis=0)
    _, _, pwF, xxF = tf_covariance_features(XF)
    out = {"stems": J, "t60": t60, "seed": args.seed}
    print(f"lab: fine {pwF.shape} J {J}", file=sys.stderr, flush=True)

    t0 = time.time()
    v = consensus_votes(XF, J)
    out["v0_acc"] = round(_acc(np.argmax(v, -1), olabF, pwF, J), 4)
    print(json.dumps({"v0_acc": out["v0_acc"],
                      "votes_s": round(time.time() - t0)}),
          file=sys.stderr, flush=True)

    best_rec = None
    for rnd in range(args.rounds + 1):
        tag = f"em{rnd}"
        recs, _ = run_pool(XF, [(tag, v)], pwF, xxF, YtF, args.iters,
                           args.em_seeds, chunk=4, return_Y=True,
                           return_votes=True)
        for r in recs:
            lab = np.asarray(r["votes_lab"], np.int64)
            r["acc_conv"] = round(_acc(lab, olabF, pwF, J), 4)
            r["ub_conv"] = round(_acc_perfreq(lab, olabF, pwF, J), 4)
            lab_r = _align_spectral(lab, pwF, J)
            r["acc_realign"] = round(_acc(lab_r, olabF, pwF, J), 4)
            r["lab_realign"] = lab_r
            print(json.dumps({
                "stage": tag, "name": r["name"],
                "min_sdr": r["min_sdr_db"], "mean_sdr": r["mean_sdr_db"],
                "acc_conv": r["acc_conv"], "ub_conv": r["ub_conv"],
                "acc_realign": r["acc_realign"],
                "envcorr": r["envcorr"], "min_share": r["min_share"],
            }), flush=True)
        pick = min(recs, key=selection_key)        # blind production pick
        orac = max(recs, key=lambda r: r["min_sdr_db"])
        out[f"{tag}_pick_min_sdr"] = pick["min_sdr_db"]
        out[f"{tag}_pick_acc"] = pick["acc_conv"]
        out[f"{tag}_pick_ub"] = pick["ub_conv"]
        out[f"{tag}_pick_realign_acc"] = pick["acc_realign"]
        out[f"{tag}_oracle_min_sdr"] = orac["min_sdr_db"]
        best_rec = pick
        # next round's votes: realigned at-convergence labels of the pick
        v = np.eye(J)[pick["lab_realign"]]

    if args.ladder and best_rec is not None:
        tftC = STFT(wlen=args.wcoarse, fs=FS)
        XC = np.asarray(tftC.computeTransform(mix.astype(np.float32)))
        YtC = np.stack([np.asarray(tftC.computeTransform(
            np.ascontiguousarray(ys_true[j]).astype(np.float32)))
            for j in range(J)])
        olabC = np.argmax((np.abs(YtC) ** 2).sum(-1), axis=0)
        _, _, pwC, xxC = tf_covariance_features(XC)
        Y = np.asarray(best_rec["Y"])
        ys = np.stack([np.asarray(tftF.invertTransform(Y[j], nsamples=n))
                       for j in range(J)])
        vC = _votes_from_images(tftC, ys, J, n)
        out["up_acc"] = round(_acc(np.argmax(vC, -1), olabC, pwC, J), 4)
        recs2, _ = run_pool(XC, [("up", vC)], pwC, xxC, YtC, args.iters,
                            args.em_seeds, chunk=4)
        pick2 = min(recs2, key=selection_key)
        orac2 = max(recs2, key=lambda r: r["min_sdr_db"])
        out["ladder_pick_min_sdr"] = pick2["min_sdr_db"]
        out["ladder_pick_mean_sdr"] = pick2["mean_sdr_db"]
        out["ladder_oracle_min_sdr"] = orac2["min_sdr_db"]

    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
