"""Mono spectral-only separation: where does the 0.6 dB live? (item 9)

docs/validation.md row 7 (mono 2src, blind): BSS-Eval-512 0.62/1.12 dB,
exact-image 3.17 mean. This tool separates blind-INIT loss from MODEL
capacity on the SAME fixture (validate_hw scenario_general_I's mono row,
rng(110), second _sources call) by running the identical EM from an
oracle frequency-basis init:

  blind      -- the shipped row: random FB/TW init (reference point);
  oracle-fb  -- FB_j initialized from a per-source IS-NMF of the TRUE
                source power spectrogram, all factors free (basin-entry
                ceiling: what a perfect init could reach);
  oracle-fb-fixed -- same init, FB held FIXED (model-capacity ceiling:
                the most the v = FB @ TW model can do when told each
                source's spectral dictionary).

Usage: python tools/mono_ceiling.py [--iters 300] [--nmf-comps 6]

Round-5 addition (VERDICT r4 item 5): `--sweep N` replaces the single
fixture with N independent mono draws (varying source-kind pairs/triples,
J in {2,3}, per-draw rng) and reports blind-random vs nmf-cluster init on
every draw plus worst/median/mean summaries:
  python tools/mono_ceiling.py --sweep 6 --iters 300
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from validate_hw import FS, DUR, WLEN, _best_perm_sdr, _sources  # noqa: E402


def _is_nmf(P, K, iters=150, seed=0, eps=1e-9):
    """Plain float64 IS-NMF P ~ W @ H (multiplicative updates)."""
    rng = np.random.default_rng(seed)
    F, N = P.shape
    W = 0.5 + rng.random((F, K))
    H = 0.5 + rng.random((K, N))
    P = np.maximum(P, eps)
    for _ in range(iters):
        V = np.maximum(W @ H, eps)
        W *= ((P / V ** 2) @ H.T) / np.maximum((1.0 / V) @ H.T, eps)
        V = np.maximum(W @ H, eps)
        H *= (W.T @ (P / V ** 2)) / np.maximum(W.T @ (1.0 / V), eps)
    s = W.sum(0, keepdims=True)
    return W / np.maximum(s, eps), H * s.T


def _sweep(args):
    """Blind mono robustness over independent draws (VERDICT r4 item 5).

    Per draw: J sampled in {2,3}, source kinds sampled from spectrally
    distinct pairs/triples, fresh rng. Runs the production blind path
    (estim_param_blind_mono = mixture IS-NMF + envelope clustering init)
    against the random-init reference on the identical model."""
    import jax  # noqa: F401  (device selection happens at import)

    from pyfasst_jax.models.variants import MultiChanNMFInst_FASST
    from pyfasst_jax.tf.stft import STFT  # noqa: F401
    from pyfasst_jax.utils.metrics import bss_eval_images

    kind_sets = [
        ["harm", "noise_lo"], ["harm", "noise_hi"],
        ["tone_switch", "noise_lo"], ["clicks", "harm"],
        ["harm", "noise_lo", "noise_hi"],
        ["tone_switch", "clicks", "noise_lo"],
        ["band:0.02-0.2", "band:0.3-0.8"],
        ["harm", "band:0.25-0.7"],
    ]
    n = int(FS * DUR)
    rows = []
    for d in range(args.sweep):
        seed = args.sweep_seed0 + d
        rng = np.random.default_rng(seed)
        kinds = kind_sets[int(rng.integers(0, len(kind_sets)))]
        J = len(kinds)
        srcs = _sources(rng, n, kinds)
        lev = 10 ** (rng.uniform(-2, 2, J) / 20)
        ys_true = np.stack([lev[j] * srcs[j][:, None] for j in range(J)])
        mix = ys_true.sum(0).astype(np.float32)
        for mode in ("random", "nmf-cluster"):
            model = MultiChanNMFInst_FASST(mix, fs=FS, nbComps=J,
                                           nbNMFComps=args.nmf_comps,
                                           wlen=WLEN, iter_num=args.iters,
                                           seed=0)
            t0 = time.perf_counter()
            if mode == "nmf-cluster":
                lls = model.estim_param_blind_mono()
            else:
                lls = model.estim_param_a_posteriori()
            ys = model.separated_images()
            wall = time.perf_counter() - t0
            mn, mean = _best_perm_sdr(ys, ys_true)
            out = bss_eval_images(ys, ys_true, filt_len=512)
            row = {"draw": seed, "J": J, "kinds": kinds, "mode": mode,
                   "min_sdr_db": round(float(mn), 2),
                   "mean_sdr_db": round(float(mean), 2),
                   "bss512_min_sdr_db": round(float(out["sdr"].min()), 2),
                   # same model class + same data, different INIT: the
                   # final loglik is a legitimate arbiter here (unlike
                   # the stereo pool, where candidates differ
                   # structurally and loglik is measured misleading)
                   "final_ll": round(float(np.asarray(lls)[-1]), 1),
                   "wall_s": round(wall, 1)}
            rows.append(row)
            print(json.dumps(row), flush=True)
    for mode in ("random", "nmf-cluster"):
        mns = [r["min_sdr_db"] for r in rows if r["mode"] == mode]
        print(json.dumps({
            "mode": mode, "n_draws": len(mns),
            "min_sdr worst/median/mean":
                [round(float(np.min(mns)), 2),
                 round(float(np.median(mns)), 2),
                 round(float(np.mean(mns)), 2)]}), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--nmf-comps", type=int, default=6)
    ap.add_argument("--sweep", type=int, default=0)
    ap.add_argument("--sweep-seed0", type=int, default=500)
    args = ap.parse_args()
    if args.sweep:
        _sweep(args)
        return

    import jax.numpy as jnp

    from pyfasst_jax.models.variants import MultiChanNMFInst_FASST
    from pyfasst_jax.tf.stft import STFT
    from pyfasst_jax.utils.metrics import bss_eval_images

    # the exact validate_hw mono fixture: rng(110), 3ch sources drawn
    # first (and discarded), then the mono pair
    rng = np.random.default_rng(110)
    n = int(FS * DUR)
    _ = _sources(rng, n, ["harm", "noise_hi"])
    s1m, s2m = _sources(rng, n, ["harm", "noise_lo"])
    ys_true = np.stack([s1m[:, None], s2m[:, None]])
    mix = ys_true.sum(0).astype(np.float32)

    tft = STFT(wlen=WLEN, fs=FS)
    P_true = [np.abs(np.asarray(
        tft.computeTransform(ys_true[j].astype(np.float32)))[:, :, 0])
        ** 2 for j in range(2)]

    def run(tag, oracle_fb: bool, fix_fb: bool):
        model = MultiChanNMFInst_FASST(mix, fs=FS, nbComps=2,
                                       nbNMFComps=args.nmf_comps,
                                       wlen=WLEN, iter_num=args.iters,
                                       seed=0)
        if oracle_fb:
            spec = []
            for j, sc in enumerate(model.params.spec):
                W, H = _is_nmf(P_true[j], args.nmf_comps, seed=j)
                sc = dataclasses.replace(
                    sc, FB=jnp.asarray(W, jnp.float32),
                    TW=jnp.asarray(np.maximum(H, 1e-6), jnp.float32))
                if fix_fb:
                    free = list(sc.free)
                    free[0] = False
                    sc = dataclasses.replace(sc, free=tuple(free))
                spec.append(sc)
            model.params = dataclasses.replace(model.params,
                                               spec=tuple(spec))
        t0 = time.perf_counter()
        model.estim_param_a_posteriori()
        ys = model.separated_images()
        wall = time.perf_counter() - t0
        mn, mean = _best_perm_sdr(ys, ys_true)
        out = bss_eval_images(ys, ys_true, filt_len=512)
        print(json.dumps({
            "mode": tag, "min_sdr_db": round(float(mn), 2),
            "mean_sdr_db": round(float(mean), 2),
            "bss512_min_sdr_db": round(float(out["sdr"].min()), 2),
            "bss512_mean_sdr_db": round(float(out["sdr"].mean()), 2),
            "wall_s": round(wall, 1)}), flush=True)

    def run_nmf_cluster():
        """The round-4 production blind mono init (models/mono.py)."""
        model = MultiChanNMFInst_FASST(mix, fs=FS, nbComps=2,
                                       nbNMFComps=args.nmf_comps,
                                       wlen=WLEN, iter_num=args.iters,
                                       seed=0)
        t0 = time.perf_counter()
        model.estim_param_blind_mono()
        ys = model.separated_images()
        wall = time.perf_counter() - t0
        mn, mean = _best_perm_sdr(ys, ys_true)
        out = bss_eval_images(ys, ys_true, filt_len=512)
        print(json.dumps({
            "mode": "nmf-cluster", "min_sdr_db": round(float(mn), 2),
            "mean_sdr_db": round(float(mean), 2),
            "bss512_min_sdr_db": round(float(out["sdr"].min()), 2),
            "bss512_mean_sdr_db": round(float(out["sdr"].mean()), 2),
            "wall_s": round(wall, 1)}), flush=True)

    run("blind", oracle_fb=False, fix_fb=False)
    run_nmf_cluster()
    run("oracle-fb", oracle_fb=True, fix_fb=False)
    run("oracle-fb-fixed", oracle_fb=True, fix_fb=True)


if __name__ == "__main__":
    main()
