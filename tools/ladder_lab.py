"""Multi-scale ladder lab for the music scenario.

align_diag/align_exp established (music 3-stem, T60=0.12 s):
  - clusters at wlen 8192 are good (UB 0.83) but NO blind cross-frequency
    alignment signal survives the 186 ms window (envelope dead at >=93 ms
    windows, spatial dead at 0 dB direct-to-reverb with ~1.5-bin
    coherence);
  - at wlen 2048 the envelope alignment signal works (scrambled-oracle
    recovery 0.75 = its cluster UB) but clusters are spatially blurrier
    (UB 0.74) and the EM ceiling is lower (7.1 vs 13.1 dB min SDR).

The LADDER transports alignment information from the fine grid to the
coarse one through the model itself: votes at 2048 -> full EM at 2048 ->
separated images -> ISTFT -> re-STFT at 8192 -> dominance votes -> full
EM at 8192. This lab measures each rung against the oracle, under three
vote sources at 2048:
  oraclefix  real clusters, per-frequency permutation fixed by the oracle
             (= what a perfect 2048 alignment would give; LADDER CEILING)
  blind      production consensus votes (what we get today)
plus the no-ladder bound at 8192:
  fix8192    real 8192 clusters, oracle-fixed alignment -> EM@8192 only
             (= payoff of ever solving alignment at 8192 directly)

Usage: python tools/ladder_lab.py [--stems 3] [--iters 400] [--seed 100]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from align_diag import _acc
from music_lab import _fixture, FS
from reverb_lab import run_pool


def _oracle_fix_labels(lab, oracle_lab, pw, J):
    """Per-frequency permutation of `lab` best matching the oracle plane
    (the alignment upper bound made concrete)."""
    from pyfasst_jax.models.spatial_init import _best_assignment
    oh = np.eye(J)[lab] * pw[..., None]
    T = np.einsum('fnj,fnk->fjk', oh, np.eye(J)[oracle_lab])
    # _best_assignment(T) maximizes sum_o T[f, sel[f, o], o]: sel maps
    # oracle source o -> estimated cluster; labels need the inverse map
    sel = _best_assignment(T)
    inv = np.argsort(sel, axis=1)
    return np.take_along_axis(inv, lab, axis=1)


def _votes_from_images(tft_to, ys, J, n):
    """Time-domain per-source images -> dominance votes on tft_to's grid."""
    P = [(np.abs(np.asarray(tft_to.computeTransform(
        np.ascontiguousarray(ys[j]).astype(np.float32)))) ** 2).sum(-1)
        for j in range(J)]
    lab = np.argmax(np.stack(P), axis=0)
    return np.eye(J)[lab]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--stems", type=int, default=3, choices=(3, 4))
    ap.add_argument("--t60", type=float, default=None)
    ap.add_argument("--iters", type=int, default=400)
    ap.add_argument("--seed", type=int, default=100)
    ap.add_argument("--em-seeds", type=int, default=2)
    ap.add_argument("--wfine", type=int, default=2048)
    ap.add_argument("--wcoarse", type=int, default=8192)
    ap.add_argument("--coarse-reseeds", type=int, default=0)
    args = ap.parse_args()
    J = args.stems
    t60 = args.t60 if args.t60 is not None else (
        0.12 if J == 3 else 0.25)

    from pyfasst_jax.tf.stft import STFT
    from pyfasst_jax.models.spatial_init import (
        _cluster_labels_jax, consensus_votes, tf_covariance_features,
    )

    mix, ys_true, n = _fixture(J, t60, args.seed)
    tftF = STFT(wlen=args.wfine, fs=FS)
    tftC = STFT(wlen=args.wcoarse, fs=FS)
    XF = np.asarray(tftF.computeTransform(mix.astype(np.float32)))
    XC = np.asarray(tftC.computeTransform(mix.astype(np.float32)))
    YtF = np.stack([np.asarray(tftF.computeTransform(
        np.ascontiguousarray(ys_true[j]).astype(np.float32)))
        for j in range(J)])
    YtC = np.stack([np.asarray(tftC.computeTransform(
        np.ascontiguousarray(ys_true[j]).astype(np.float32)))
        for j in range(J)])

    featF, wF, pwF, xxF = tf_covariance_features(XF)
    featC, wC, pwC, xxC = tf_covariance_features(XC)
    olabF = np.argmax((np.abs(YtF) ** 2).sum(-1), axis=0)
    olabC = np.argmax((np.abs(YtC) ** 2).sum(-1), axis=0)
    print(f"ladder: fine ({pwF.shape}) coarse ({pwC.shape}) J {J}",
          file=sys.stderr, flush=True)

    out = {"stems": J, "t60": t60, "seed": args.seed}

    # ---- bound: oracle-fixed 8192 clusters, EM at 8192 only
    labC = np.asarray(_cluster_labels_jax(featC, wC, J, 1, 30)[0])
    vfixC = np.eye(J)[_oracle_fix_labels(labC, olabC, pwC, J)]
    recs, _ = run_pool(XC, [("fix8192", vfixC)], pwC, xxC, YtC,
                       args.iters, args.em_seeds, chunk=4)
    out["fix8192"] = max(r["min_sdr_db"] for r in recs)
    out["fix8192_acc"] = round(_acc(np.argmax(vfixC, -1), olabC, pwC, J), 4)
    print(json.dumps({k: out[k] for k in ("fix8192", "fix8192_acc")}),
          file=sys.stderr, flush=True)

    # ---- ladder rung 1 at fine grid, two vote sources
    labF = np.asarray(_cluster_labels_jax(featF, wF, J, 1, 30)[0])
    vfixF = np.eye(J)[_oracle_fix_labels(labF, olabF, pwF, J)]
    t0 = time.time()
    vblind = consensus_votes(XF, J)
    print(f"ladder: blind votes in {time.time() - t0:.0f}s",
          file=sys.stderr, flush=True)
    for tag, v in (("oraclefix", vfixF), ("blind", vblind)):
        acc = _acc(np.argmax(v, -1), olabF, pwF, J)
        recs, _ = run_pool(XF, [(tag, v)], pwF, xxF, YtF, args.iters,
                           args.em_seeds, chunk=4, return_Y=True)
        best = max(recs, key=lambda r: r["min_sdr_db"])
        out[f"{tag}_fine_acc"] = round(acc, 4)
        out[f"{tag}_fine_min_sdr"] = best["min_sdr_db"]
        # rung 2: images -> coarse votes -> EM at coarse (run_pool returns
        # Y already rescaled to input units)
        Y = np.asarray(best["Y"])
        ys = np.stack([np.asarray(tftF.invertTransform(Y[j], nsamples=n))
                       for j in range(J)])
        vC = _votes_from_images(tftC, ys, J, n)
        accC = _acc(np.argmax(vC, -1), olabC, pwC, J)
        recs2, _ = run_pool(XC, [(f"{tag}-up", vC)], pwC, xxC, YtC,
                            args.iters, args.em_seeds, chunk=4,
                            return_Y=True)
        best2 = max(recs2, key=lambda r: r["min_sdr_db"])
        out[f"{tag}_up_acc"] = round(accC, 4)
        out[f"{tag}_ladder_min_sdr"] = best2["min_sdr_db"]
        out[f"{tag}_ladder_mean_sdr"] = best2["mean_sdr_db"]
        print(json.dumps({k: v for k, v in out.items()
                          if k.startswith(tag)}), file=sys.stderr, flush=True)
        # rung 3+: reseed rounds AT the coarse grid (does the EM keep
        # climbing from its own posterior votes?)
        for r in range(args.coarse_reseeds):
            Yr = np.asarray(best2["Y"])
            labr = np.argmax((np.abs(Yr) ** 2).sum(-1), axis=0)
            vr = np.eye(J)[labr]
            accr = _acc(labr, olabC, pwC, J)
            recs3, _ = run_pool(XC, [(f"{tag}-rs{r + 1}", vr)], pwC, xxC,
                                YtC, args.iters, args.em_seeds, chunk=4,
                                return_Y=True)
            best2 = max(recs3, key=lambda r_: r_["min_sdr_db"])
            out[f"{tag}_rs{r + 1}_acc"] = round(accr, 4)
            out[f"{tag}_rs{r + 1}_min_sdr"] = best2["min_sdr_db"]
            out[f"{tag}_rs{r + 1}_envcorr"] = best2["envcorr"]
            out[f"{tag}_rs{r + 1}_min_share"] = best2["min_share"]
            print(json.dumps({k: v for k, v in out.items()
                              if k.startswith(f"{tag}_rs")}),
                  file=sys.stderr, flush=True)

    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
