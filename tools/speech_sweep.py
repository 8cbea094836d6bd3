"""Speech-regime operating-point sweep (VERDICT r3 item 3).

Sweeps the blind pipeline's knobs over >= 5 speech-like draws (the
validate_hw _speech_sources fixture family at T60 = 0.25 s) to choose a
shipped `--preset speech` operating point. One long-lived process (the
device grant is expensive to reacquire); one JSON line per (draw,
config) run plus a per-config summary at the end.

Usage:
  python tools/speech_sweep.py [--seeds 120,121,122,123,124]
      [--iters 400] [--configs default] [--out /tmp/speech_sweep.jsonl]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from pyfasst_jax.tf.stft import STFT                     # noqa: E402

from validate_hw import (_best_perm_sdr, _istft_images, _music_mix,
                         _speech_sources)               # noqa: E402

FS = 16000
DUR = 10.0


def _fixture(n_spk: int, t60: float, seed: int):
    rng = np.random.default_rng(seed)
    n = int(FS * DUR)
    srcs = _speech_sources(rng, n, FS, n_spk)
    pans = [(0.9, 1.0), (-0.9, 1.0), (0.0, 1.0), (0.45, 1.0)][:n_spk]
    ys_true = _music_mix(rng, srcs, n, FS, t60, pans)
    return ys_true.sum(0), ys_true, n


# each config: name + kwargs for the pipeline; 'mode' picks single-grid
# vs multiscale ladder
CONFIG_SETS = {
    "default": [
        {"name": "w1024-log1p", "wlen": 1024, "env_transform": None},
        {"name": "w1024-rank", "wlen": 1024, "env_transform": "rank"},
        {"name": "w2048-log1p", "wlen": 2048, "env_transform": None},
        {"name": "w2048-rank", "wlen": 2048, "env_transform": "rank"},
        {"name": "ladder1024-4096", "mode": "ladder", "wlen": 1024,
         "wlen_coarse": 4096, "env_transform": None},
    ],
    "refine": [
        # round 2: winner family +/- pool size and NMF capacity
        {"name": "w2048-log1p-k10", "wlen": 2048, "nmf_comps": 10},
        {"name": "w2048-log1p-s12", "wlen": 2048, "n_seeds": 12},
        {"name": "w1024-log1p-k10", "wlen": 1024, "nmf_comps": 10},
        {"name": "w1024-log1p-s12", "wlen": 1024, "n_seeds": 12},
    ],
    "bandem": [
        # round 4: band-local-EM vote candidates (the new per-bin
        # feature family; speech lab consensus 0.62 -> 0.87 on seed 120)
        {"name": "w2048-bandem32", "wlen": 2048, "band_em": 32},
        {"name": "w1024-bandem32", "wlen": 1024, "band_em": 32},
        {"name": "ladder1024-4096-bandem32", "mode": "ladder",
         "wlen": 1024, "wlen_coarse": 4096, "band_em": 32},
    ],
}


def run_one(mix, ys_true, n, cfg, iters: int, em_seeds: int):
    from pyfasst_jax.models.reverb import (
        blind_reverb_separate, blind_reverb_separate_multiscale,
    )

    kw = dict(iters=iters, em_seeds=em_seeds,
              env_transform=cfg.get("env_transform"),
              nmf_comps=cfg.get("nmf_comps", 6),
              n_seeds=cfg.get("n_seeds", 8),
              band_em=cfg.get("band_em"),
              noalign=cfg.get("noalign", False))
    t0 = time.perf_counter()
    if cfg.get("mode") == "ladder":
        Y, info = blind_reverb_separate_multiscale(
            mix.astype(np.float32), J=ys_true.shape[0], fs=FS,
            wlen_fine=cfg["wlen"], wlen_coarse=cfg["wlen_coarse"],
            chunk=12, **kw)
        tft = info["transform"]
    else:
        tft = STFT(wlen=cfg["wlen"], fs=FS)
        X = np.asarray(tft.computeTransform(mix.astype(np.float32)))
        Y, info = blind_reverb_separate(
            X, J=ys_true.shape[0], chunk=12 if cfg["wlen"] <= 2048 else 6,
            **kw)
    ys = _istft_images(tft, Y, n)
    mn, mean = _best_perm_sdr(ys, ys_true)
    return {"min_sdr_db": round(mn, 2), "mean_sdr_db": round(mean, 2),
            "picked": info["picked"],
            "wall_s": round(time.perf_counter() - t0, 1)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="120,121,122,123,124")
    ap.add_argument("--iters", type=int, default=400)
    ap.add_argument("--em-seeds", type=int, default=2)
    ap.add_argument("--spk", type=int, default=3)
    ap.add_argument("--t60", type=float, default=0.25)
    ap.add_argument("--configs", default="default",
                    choices=sorted(CONFIG_SETS))
    ap.add_argument("--out", default=None,
                    help="also append JSON lines to this file")
    args = ap.parse_args()
    seeds = [int(s) for s in args.seeds.split(",")]
    configs = CONFIG_SETS[args.configs]

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    per_cfg = {c["name"]: [] for c in configs}
    for seed in seeds:
        mix, ys_true, n = _fixture(args.spk, args.t60, seed)
        for cfg in configs:
            rec = run_one(mix, ys_true, n, cfg, args.iters, args.em_seeds)
            rec.update({"seed": seed, "config": cfg["name"]})
            per_cfg[cfg["name"]].append(rec)
            emit(rec)

    for name, recs in per_cfg.items():
        mins = [r["min_sdr_db"] for r in recs]
        means = [r["mean_sdr_db"] for r in recs]
        emit({"summary": name, "draws": len(recs),
              "min_sdr": {"worst": min(mins),
                          "median": float(np.median(mins)),
                          "mean": round(float(np.mean(mins)), 2)},
              "mean_sdr": {"median": float(np.median(means)),
                           "mean": round(float(np.mean(means)), 2)}})


if __name__ == "__main__":
    main()
