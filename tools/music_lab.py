"""Music-like scenario lab: where is the ceiling, and what sets it?

The validate_hw music rows (20 s, 44.1 kHz, T60 0.12-0.25 s, shared
harmonics, beat-locked stems) score ~0 dB blind AND the gradient 3-stem
row failed too (round-3 hardware: min -0.76). Two structural suspects:

1. WINDOW MISMATCH: wlen=2048 at 44.1 kHz is a 46 ms window against a
   120-250 ms T60 -- the narrowband (convolutive-in-frequency) model the
   full-rank spatial covariance relies on is badly violated. configs[2]
   (where the pipeline reaches 5.6-11.1 dB) has a ~6 ms RIR inside a
   64 ms window.
2. BEAT-LOCKING: every stem shares onset times, so the envelope
   statistics used for permutation alignment AND run selection are
   blinded (cross-stem envelopes genuinely correlate).

This lab separates model ceiling from init quality per window length:
for each wlen it scores (a) ORACLE-INIT EM (per-bin dominance votes from
the true images -- the model's own ceiling at that window), and
(b) the BLIND pipeline. Usage:
    python tools/music_lab.py --stems 3 --wlens 2048,4096,8192 [--iters 400]
One JSON line per (wlen, mode) to stdout; diagnostics to stderr.
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

from validate_hw import (_best_perm_sdr, _istft_images, _music_mix,
                         _music_sources)

FS = 44100
DUR = 20.0


def _fixture(stems: int, t60: float, seed: int):
    rng = np.random.default_rng(seed)
    n = int(FS * DUR)
    srcs = _music_sources(rng, n, FS)
    if stems == 3:
        kinds = [0, 2, 3]
        pans = [(0.9, 1.0), (-0.9, 1.0), (0.0, 1.0)]
    else:
        kinds = [0, 1, 2, 3]
        pans = [(0.0, 1.3), (0.8, 0.5), (-0.8, 0.5), (0.0, 0.9)]
    srcs = [srcs[k] for k in kinds]
    ys_true = _music_mix(rng, srcs, n, FS, t60, pans)
    return ys_true.sum(0), ys_true, n


def _oracle_votes(tft, ys_true, J):
    """Per-bin dominance votes from the TRUE image spectra (oracle init)."""
    P = []
    for j in range(J):
        Yj = np.asarray(tft.computeTransform(
            ys_true[j].astype(np.float32)))
        P.append((np.abs(Yj) ** 2).sum(-1))
    lab = np.argmax(np.stack(P), axis=0)              # (F, N)
    return np.eye(J)[lab]


def _run_from_votes(X, votes, J, iters, nmf_comps=6, rank=2, seed=0):
    """One full-rank EM from a vote plane (the reverb pipeline's inner
    fit, single run)."""
    import jax
    import jax.numpy as jnp

    from pyfasst_jax.models.components import (
        CONV, FasstParams, SpatialComp, init_nmf_comp,
    )
    from pyfasst_jax.models.spatial_init import (
        activity_profiles, apply_profiles, mixing_from_votes,
        tf_covariance_features,
    )
    from pyfasst_jax.ops.gem import annealing_endpoints, run_gem
    from pyfasst_jax.ops.wiener import separate_sources
    from pyfasst_jax.utils.config import GEMConfig
    import jax.numpy as jnp

    feat, w, pw, xx = tf_covariance_features(X)
    A = mixing_from_votes(votes, xx, pw, rank=rank)
    twp, fbp = activity_profiles(votes, pw)
    keys = list(jax.random.split(jax.random.PRNGKey(seed), J))
    F, N = X.shape[:2]
    spat = tuple(SpatialComp(A=jnp.asarray(A[j]), mix_type=CONV)
                 for j in range(J))
    spec = tuple(init_nmf_comp(keys[j], F, N, nmf_comps, spat_ind=j)
                 for j in range(J))
    params = apply_profiles(FasstParams(spat=spat, spec=spec), twp, fbp)
    scale = float(np.sqrt(np.mean(np.abs(X) ** 2)))
    Xd = jnp.asarray(np.ascontiguousarray(X)) / scale
    cfg = GEMConfig(niter=iters, spatial_hold_frac=0.3)
    params, lls = run_gem(params, Xd, cfg)
    _, sigma1 = annealing_endpoints(Xd, cfg)
    Y = separate_sources(params, Xd, sigma1)
    return np.asarray(Y) * scale, float(np.asarray(lls)[-1])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--stems", type=int, default=3, choices=(3, 4))
    ap.add_argument("--t60", type=float, default=None,
                    help="default: 0.12 for 3 stems, 0.25 for 4")
    ap.add_argument("--wlens", default="2048,4096,8192")
    ap.add_argument("--iters", type=int, default=400)
    ap.add_argument("--seed", type=int, default=100)
    ap.add_argument("--modes", default="oracle,blind")
    ap.add_argument("--em-seeds", type=int, default=2)
    args = ap.parse_args()
    t60 = args.t60 if args.t60 is not None else (
        0.12 if args.stems == 3 else 0.25)
    mix, ys_true, n = _fixture(args.stems, t60, args.seed)
    J = args.stems
    modes = args.modes.split(",")

    for wlen in (int(x) for x in args.wlens.split(",")):
        tft = STFT(wlen=wlen, fs=FS)
        X = np.asarray(tft.computeTransform(mix.astype(np.float32)))
        F, N = X.shape[:2]
        print(f"music_lab: wlen {wlen} -> F {F} N {N}", file=sys.stderr,
              flush=True)
        if "oracle" in modes:
            votes = _oracle_votes(tft, ys_true, J)
            t0 = time.perf_counter()
            Y, ll = _run_from_votes(X, votes, J, args.iters)
            ys = _istft_images(tft, Y, n)
            mn, mean = _best_perm_sdr(ys, ys_true)
            print(json.dumps({
                "stems": J, "t60": t60, "wlen": wlen, "mode": "oracle",
                "min_sdr_db": round(mn, 2), "mean_sdr_db": round(mean, 2),
                "final_ll": round(ll, 1),
                "wall_s": round(time.perf_counter() - t0, 1)}), flush=True)
        if "blind" in modes:
            from pyfasst_jax.models.reverb import blind_reverb_separate
            t0 = time.perf_counter()
            Y, info = blind_reverb_separate(X, J=J, iters=args.iters,
                                            em_seeds=args.em_seeds,
                                            chunk=12 if F <= 2049 else 6)
            ys = _istft_images(tft, Y, n)
            mn, mean = _best_perm_sdr(ys, ys_true)
            print(json.dumps({
                "stems": J, "t60": t60, "wlen": wlen, "mode": "blind",
                "min_sdr_db": round(mn, 2), "mean_sdr_db": round(mean, 2),
                "picked": info["picked"],
                "wall_s": round(time.perf_counter() - t0, 1)}), flush=True)


if __name__ == "__main__":
    main()
