"""Speech-like reverberant scenario lab (the SiSEC regime stand-in).

The reference's headline use-case is underdetermined reverberant SPEECH
(SURVEY.md §6); the repo's music rows deliberately break the blind
pipeline (beat-locked envelopes), while configs[2] is short-T60 abstract
sources. This lab measures the missing middle: 3 simultaneous
speech-like talkers (validate_hw._speech_sources — independent syllable
timing, so envelope statistics are in their design regime) under a
T60=0.25 s stereo image at 16 kHz.

Per window length it scores (a) the ORACLE-INIT EM ceiling and (b) the
BLIND pipeline, like music_lab — choosing the production wlen for the
validate_hw speech row and recording the capability honestly.

Usage: python tools/speech_lab.py [--wlens 1024,2048,4096] [--iters 400]
           [--seed 120] [--t60 0.25] [--spk 3]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from pyfasst_jax.tf.stft import STFT

from music_lab import _oracle_votes, _run_from_votes
from validate_hw import (_best_perm_sdr, _istft_images, _music_mix,
                         _speech_sources)

FS = 16000
DUR = 10.0


def _fixture(n_spk: int, t60: float, seed: int):
    rng = np.random.default_rng(seed)
    n = int(FS * DUR)
    srcs = _speech_sources(rng, n, FS, n_spk)
    pans = [(0.9, 1.0), (-0.9, 1.0), (0.0, 1.0), (0.45, 1.0)][:n_spk]
    ys_true = _music_mix(rng, srcs, n, FS, t60, pans)
    return ys_true.sum(0), ys_true, n


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--spk", type=int, default=3)
    ap.add_argument("--t60", type=float, default=0.25)
    ap.add_argument("--wlens", default="1024,2048")
    ap.add_argument("--iters", type=int, default=400)
    ap.add_argument("--seed", type=int, default=120)
    ap.add_argument("--modes", default="oracle,blind")
    ap.add_argument("--em-seeds", type=int, default=2)
    ap.add_argument("--coarse-mult", type=int, default=2,
                    help="ladder mode: wlen_coarse = coarse_mult * wlen")
    ap.add_argument("--env-transform", default=None,
                    help="override spatial_init._ENV_TRANSFORM "
                         "(log1p | rank) for the blind pipeline")
    ap.add_argument("--band-em", type=int, default=None)
    ap.add_argument("--noalign", action="store_true")
    ap.add_argument("--select", default="envcorr",
                    choices=("envcorr", "consistency", "learned"))
    ap.add_argument("--learned", action="store_true",
                    help="add the learned-vote candidate "
                         "(models/binfeat; needs trained weights)")
    ap.add_argument("--reseed-rounds", type=int, default=2)
    ap.add_argument("--reseed-select", default=None,
                    choices=("envcorr", "learned"),
                    help="guard reseed acceptance by the envcorr key "
                         "(immune to warm-restart consistency inflation)")
    ap.add_argument("--realign-reseeds", action="store_true",
                    help="add realigned-reseed hypotheses to the pool")
    args = ap.parse_args()
    if args.env_transform and args.env_transform != "both":
        import pyfasst_jax.models.spatial_init as si
        si._ENV_TRANSFORM = args.env_transform
    J = args.spk
    mix, ys_true, n = _fixture(J, args.t60, args.seed)
    modes = args.modes.split(",")

    for wlen in (int(x) for x in args.wlens.split(",")):
        tft = STFT(wlen=wlen, fs=FS)
        X = np.asarray(tft.computeTransform(mix.astype(np.float32)))
        F, N = X.shape[:2]
        print(f"speech_lab: wlen {wlen} -> F {F} N {N}", file=sys.stderr,
              flush=True)
        if "oracle" in modes:
            votes = _oracle_votes(tft, np.ascontiguousarray(ys_true), J)
            t0 = time.perf_counter()
            Y, ll = _run_from_votes(X, votes, J, args.iters)
            ys = _istft_images(tft, Y, n)
            mn, mean = _best_perm_sdr(ys, ys_true)
            print(json.dumps({
                "spk": J, "t60": args.t60, "wlen": wlen, "mode": "oracle",
                "min_sdr_db": round(mn, 2), "mean_sdr_db": round(mean, 2),
                "final_ll": round(ll, 1),
                "wall_s": round(time.perf_counter() - t0, 1)}), flush=True)
        if "blind" in modes:
            from pyfasst_jax.models.reverb import blind_reverb_separate
            t0 = time.perf_counter()
            Y, info = blind_reverb_separate(
                X, J=J, iters=args.iters, em_seeds=args.em_seeds,
                chunk=12 if F <= 2049 else 6,
                env_transform=args.env_transform,
                realign_reseeds=args.realign_reseeds,
                band_em=args.band_em, noalign=args.noalign,
                select=args.select, reseed_rounds=args.reseed_rounds,
                reseed_select=args.reseed_select, learned=args.learned,
                keep_pool_sep=args.reseed_rounds > 0)
            ys = _istft_images(tft, Y, n)
            mn, mean = _best_perm_sdr(ys, ys_true)
            row = {
                "spk": J, "t60": args.t60, "wlen": wlen, "mode": "blind",
                "select": args.select,
                "min_sdr_db": round(mn, 2), "mean_sdr_db": round(mean, 2),
                "picked": info["picked"],
                "wall_s": round(time.perf_counter() - t0, 1)}
            if args.reseed_select:
                row["reseed_select"] = args.reseed_select
            if "pool_Y" in info and info["pool_picked"] != info["picked"]:
                # score the POOL-stage winner too (what reseed-free
                # selection would have shipped)
                ysp = _istft_images(tft, info["pool_Y"], n)
                mnp, meanp = _best_perm_sdr(ysp, ys_true)
                row["pool_min_sdr_db"] = round(mnp, 2)
                row["pool_mean_sdr_db"] = round(meanp, 2)
                row["pool_picked"] = info["pool_picked"]
            print(json.dumps(row), flush=True)
        if "ladder" in modes:
            # multiscale: alignment evidence at `wlen` (alive at 128 ms
            # for syllabic envelopes, dead at 256 ms -- measured blind
            # -0.68 dB at wlen 4096 vs +2.17 at 2048), model capacity at
            # 2*wlen (oracle ceiling 13.5 at 4096 vs 9.8 at 2048)
            from pyfasst_jax.models.reverb import (
                blind_reverb_separate_multiscale,
            )
            t0 = time.perf_counter()
            wc = args.coarse_mult * wlen
            Y, info = blind_reverb_separate_multiscale(
                mix.astype(np.float32), J=J, fs=FS, wlen_fine=wlen,
                wlen_coarse=wc, iters=args.iters,
                em_seeds=args.em_seeds, chunk=12,
                env_transform=args.env_transform,
                realign_reseeds=args.realign_reseeds,
                band_em=args.band_em, noalign=args.noalign,
                select=args.select)
            ys = _istft_images(info["transform"], Y, n)
            mn, mean = _best_perm_sdr(ys, ys_true)
            print(json.dumps({
                "spk": J, "t60": args.t60, "wlen": wlen, "mode": "ladder",
                "wlen_coarse": wc, "select": args.select,
                "min_sdr_db": round(mn, 2), "mean_sdr_db": round(mean, 2),
                "picked": info["picked"],
                "wall_s": round(time.perf_counter() - t0, 1)}), flush=True)


if __name__ == "__main__":
    main()
