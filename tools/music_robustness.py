"""Multiscale-ladder robustness over music fixture draws.

Mirrors tools/reverb_robustness.py for the music stretch scenario: the
full production multiscale pipeline (blind_reverb_separate_multiscale,
fine wlen 2048 -> coarse 8192) on several fixture seeds of the 3-stem
bass/lead/drums mixture (20 s, 44.1 kHz, T60 0.12 s), scored against the
exact synthetic images. One JSON line per draw + a summary line.

Usage: python tools/music_robustness.py --draws 100 101 102 103 104
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from music_lab import _fixture, FS
from validate_hw import _best_perm_sdr


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--draws", type=int, nargs="+",
                    default=[100, 101, 102, 103, 104])
    ap.add_argument("--stems", type=int, default=3, choices=(3, 4))
    ap.add_argument("--t60", type=float, default=None)
    ap.add_argument("--iters", type=int, default=400)
    ap.add_argument("--wfine", type=int, default=2048)
    ap.add_argument("--wcoarse", type=int, default=8192)
    ap.add_argument("--env-transform", default=None,
                    help="override spatial_init._ENV_TRANSFORM "
                         "(log1p | rank)")
    ap.add_argument("--realign-reseeds", action="store_true")
    ap.add_argument("--band-em", type=int, default=None,
                    help="add band-local-EM vote candidate (band width)")
    ap.add_argument("--noalign", action="store_true",
                    help="add alignment-free consensus candidate")
    ap.add_argument("--learned", action="store_true",
                    help="add the learned-vote candidate on the fine "
                         "grid (models/binfeat; needs trained weights)")
    ap.add_argument("--select", default=None,
                    choices=("envcorr", "consistency", "learned"),
                    help="fine-stage selection rule (None = ladder auto "
                         "= envcorr)")
    ap.add_argument("--flat", action="store_true",
                    help="run the FLAT pipeline directly on the COARSE "
                         "grid (--wcoarse) instead of the ladder. The "
                         "ladder exists to transport envelope-alignment "
                         "evidence from the fine grid; learned votes "
                         "(--learned) are globally aligned by "
                         "construction, so with them the fine stage may "
                         "be unnecessary and the coarse grid's higher EM "
                         "ceiling (13.1 vs 7.1 dB oracle-init, design.md "
                         "§6e) becomes directly reachable")
    args = ap.parse_args()
    if args.env_transform and args.env_transform != "both":
        import pyfasst_jax.models.spatial_init as si
        si._ENV_TRANSFORM = args.env_transform
    t60 = args.t60 if args.t60 is not None else (
        0.12 if args.stems == 3 else 0.25)

    from pyfasst_jax.models.reverb import (
        blind_reverb_separate, blind_reverb_separate_multiscale,
    )

    mins, means = [], []
    for draw in args.draws:
        mix, ys_true, n = _fixture(args.stems, t60, draw)
        t0 = time.perf_counter()
        if args.flat:
            from pyfasst_jax.tf.stft import STFT

            tft = STFT(wlen=args.wcoarse, fs=FS)
            X = np.asarray(tft.computeTransform(
                mix.astype(np.float32)))
            Y, info = blind_reverb_separate(
                X, J=args.stems, iters=args.iters, em_seeds=2, chunk=12,
                env_transform=args.env_transform,
                realign_reseeds=args.realign_reseeds,
                band_em=args.band_em, noalign=args.noalign,
                learned=args.learned, select=args.select)
            info["fine"] = {"picked": "(flat)"}
        else:
            Y, info = blind_reverb_separate_multiscale(
                mix.astype(np.float32), J=args.stems, fs=FS,
                wlen_fine=args.wfine, wlen_coarse=args.wcoarse,
                iters=args.iters, em_seeds=2, chunk=12,
                env_transform=args.env_transform,
                realign_reseeds=args.realign_reseeds,
                band_em=args.band_em, noalign=args.noalign,
                learned=args.learned, select=args.select)
            tft = info["transform"]
        ys = np.stack([np.asarray(tft.invertTransform(Y[j], nsamples=n))
                       for j in range(args.stems)])
        wall = time.perf_counter() - t0
        mn, mean = _best_perm_sdr(ys, ys_true)
        mins.append(mn)
        means.append(mean)
        print(json.dumps({
            "draw": draw, "min_sdr_db": round(float(mn), 2),
            "mean_sdr_db": round(float(mean), 2),
            "picked": info["picked"],
            "fine_picked": info["fine"]["picked"],
            "wall_s": round(wall, 1)}), flush=True)

    mins = np.array(mins)
    print(json.dumps({
        "stems": args.stems, "t60": t60, "draws": args.draws,
        "min_sdr_worst": round(float(mins.min()), 2),
        "min_sdr_median": round(float(np.median(mins)), 2),
        "min_sdr_best": round(float(mins.max()), 2),
        "mean_sdr_median": round(float(np.median(means)), 2)}), flush=True)


if __name__ == "__main__":
    main()
