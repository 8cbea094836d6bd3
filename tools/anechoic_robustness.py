"""configs[1] robustness: the anechoic ERB+DEMIX scenario across fixture
draws (sources, gains, delays redrawn per seed).

Validates the sub-sample DEMIX refinement's generality: the delay fit
must stay within the measured safety margin (~0.3 samples) on mixtures
it has never seen, or the conv EM seed collapses (models/demix.py).

Usage: python tools/anechoic_robustness.py [--draws 5] [--iters 400]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def run_draw(fixture_seed: int, iters: int):
    import jax.numpy as jnp

    from tools.validate_hw import FS, WLEN, _best_perm_sdr, _sources
    from pyfasst_jax.models.components import (
        CONV, FasstParams, SpatialComp, SpectralComp)
    from pyfasst_jax.models.demix import DEMIX
    from pyfasst_jax.ops.gem import annealing_endpoints, run_gem
    from pyfasst_jax.ops.wiener import separate_sources
    from pyfasst_jax.tf.filterbank import spectral_basis
    from pyfasst_jax.tf.stft import STFT
    from pyfasst_jax.utils.config import GEMConfig
    import jax.numpy as jnp

    rng = np.random.default_rng(fixture_seed)
    n = int(FS * 6.0)
    # three band-limited noises with random-ish disjoint bands, random
    # gains in [0.4, 2.2] and delays in [-6, 6] samples
    edges = np.sort(rng.uniform(0.05, 0.95, 2))
    bands = [(0.01, edges[0]), (edges[0], edges[1]), (edges[1], 0.98)]
    srcs = _sources(rng, n, [f"band:{lo:.3f}-{hi:.3f}" for lo, hi in bands])
    gains = rng.uniform(0.4, 2.2, 3)
    delays = rng.uniform(-6.0, 6.0, 3)
    delays[rng.integers(3)] = 0.0          # one broadside source
    ys_true = []
    for s, g, d in zip(srcs, gains, delays):
        # fractional delay via frequency-domain phase ramp (exact fixture)
        S = np.fft.rfft(s)
        k = np.arange(len(S))
        ch1 = g * np.fft.irfft(S * np.exp(-2j * np.pi * k * d / n), n)
        ys_true.append(np.stack([s, ch1], 1))
    ys_true = np.stack(ys_true)
    mix = ys_true.sum(0)
    tft = STFT(wlen=WLEN, fs=FS)
    X = np.asarray(tft.computeTransform(mix.astype(np.float32)))
    F, N = X.shape[:2]

    t0 = time.perf_counter()
    dm = DEMIX(X=X, wlen=WLEN)
    dm.comp_parameters(K=3)
    A0 = dm.mixing(F)
    # delay recovery error at the best permutation
    derr = min(
        max(abs(dm.delays[list(p)[j]] - delays[j]) for j in range(3))
        for p in __import__("itertools").permutations(range(3)))

    FB_erb = jnp.asarray(spectral_basis("erb", 32, F, FS, WLEN),
                         jnp.float32)
    spat = tuple(SpatialComp(A=jnp.asarray(
        np.ascontiguousarray(A0[j])), mix_type=CONV) for j in range(3))
    rng2 = np.random.default_rng(5)
    spec = tuple(SpectralComp(
        FB=FB_erb, FW=jnp.asarray(0.5 + rng2.random((32, 6)), jnp.float32),
        TW=jnp.asarray(0.5 + rng2.random((6, N)), jnp.float32),
        free=(False, True, True, False), spat_ind=j) for j in range(3))
    params = FasstParams(spat=spat, spec=spec)
    Xd = jnp.asarray(X)
    scale = float(np.sqrt(np.mean(np.abs(X) ** 2)))
    Xd = Xd / scale
    cfg = GEMConfig(niter=iters, spatial_hold_frac=0.3)
    params, lls = run_gem(params, Xd, cfg)
    _, sigma1 = annealing_endpoints(Xd, cfg)
    Y = separate_sources(params, Xd, sigma1)
    Yh = np.asarray(Y) * scale
    ys = np.stack([np.asarray(tft.invertTransform(Yh[j], nsamples=n))
                   for j in range(3)])
    wall = time.perf_counter() - t0
    mn, mean = _best_perm_sdr(ys, ys_true)
    return {"fixture_seed": fixture_seed,
            "min_sdr_db": round(float(mn), 2),
            "mean_sdr_db": round(float(mean), 2),
            "max_delay_err": round(float(derr), 3),
            "wall_s": round(wall, 1)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--draws", type=int, default=5)
    ap.add_argument("--iters", type=int, default=400)
    ap.add_argument("--base-seed", type=int, default=201)
    args = ap.parse_args()

    recs = []
    for d in range(args.draws):
        rec = run_draw(args.base_seed + d, iters=args.iters)
        recs.append(rec)
        print(json.dumps(rec), flush=True)
    mins = [r["min_sdr_db"] for r in recs]
    means = [r["mean_sdr_db"] for r in recs]
    print(json.dumps({
        "summary": "configs[1] robustness", "draws": len(recs),
        "iters": args.iters,
        "min_sdr": {"worst": min(mins), "median": float(np.median(mins)),
                    "best": max(mins)},
        "mean_sdr": {"worst": min(means),
                     "median": float(np.median(means)),
                     "best": max(means)},
        "max_delay_err": max(r["max_delay_err"] for r in recs),
    }), flush=True)


if __name__ == "__main__":
    main()
