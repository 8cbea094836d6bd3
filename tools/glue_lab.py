"""Model-evidence band gluing lab: oracle-score the untried alignment family.

Round-4 state (docs/design.md §6f/§6g): band-local EM probes give
per-band stems whose WITHIN-band labels are good (band-EM UB 0.73-0.95),
but every measured CROSS-band matcher fails somewhere -- envelope
clustering dies on the image family and on speech draws, init anchoring
is blind to global init errors, and spatial band centroids are dead even
with oracle labels (30/72, 134-164/272 pairs). The one untried family is
MODEL-EVIDENCE gluing (spatial_init.glue_band_perms): a short joint EM
per adjacent band pair and relative permutation, link picked by final
log-likelihood.

This lab scores all alignment families per draw with ORACLE dominance
labels:

  pair_acc  -- fraction of adjacent band pairs whose RELATIVE permutation
               matches the oracle's (the decisive per-link number; the
               spatial matcher measured 0.42-0.60 here, envelope 0.92 on
               family 1).
  band_acc  -- fraction of bands globally aligned after chaining, at the
               best global permutation (what the emitted votes inherit).
  vote_acc  -- power-weighted per-bin accuracy of the emitted vote plane
               (align_diag._acc; comparable with feat_dereverb_lab).
  ub        -- vote accuracy with ORACLE band alignment (the ceiling any
               band matcher could reach from these probes).

Families: mini (CPU-friendly J=3 configs[2] miniature), reverb
(family-1 configs[2] draws), image (image-method rooms, the measured
hard boundary), music3 (beat-locked stems, fine grid).

Usage:
  python tools/glue_lab.py --family image --seeds 202,203
  python tools/glue_lab.py --family mini --seeds 102 --glue-iters 40,60
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))

from align_diag import _acc  # noqa: E402


def _fixture(family: str, seed: int):
    """-> (mix, ys_true (J, n, I), fs, wlen, J)"""
    if family == "mini":
        from test_reverb_pipeline import _mini_configs2_fixture
        mix, ys = _mini_configs2_fixture(seed, fs=8000)
        return mix, ys, 8000, 512, 3
    if family == "reverb":
        from validate_hw import FS, _sources
        rng = np.random.default_rng(seed)
        n = int(FS * 6.0)
        srcs = _sources(rng, n, ["harm", "noise_lo", "noise_hi", "clicks"])
        ys = []
        for j, s in enumerate(srcs):
            chs = []
            for ch in range(2):
                h = rng.standard_normal(100) * np.exp(-np.arange(100) / 20.)
                h[0] += 1.5 if ch == (j % 2) else 0.4
                chs.append(np.convolve(s, h, "same"))
            ys.append(np.stack(chs, 1))
        ys = np.stack(ys)
        return ys.sum(0), ys, FS, 1024, 4
    if family == "image":
        from fixtures2 import make_image_fixture
        mix, ys, _meta = make_image_fixture(seed, fs=16000, dur=6.0, J=4)
        return mix, ys, 16000, 1024, 4
    if family == "music3":
        from music_lab import _fixture as mfix
        mix, ys, _n = mfix(3, 0.12, seed)
        return mix, ys, 44100, 2048, 3
    if family == "speech":
        # the speech preset's operating point (3 spk, T60 0.25, wlen
        # 2048) -- the one regime where band-EM votes are pool-picked
        from speech_lab import _fixture as sfix
        mix, ys, _n = sfix(3, 0.25, seed)
        return mix, ys, 16000, 2048, 3
    raise SystemExit(f"unknown family {family}")


def _oracle_band_perms(lab_b, pick, starts, Fb, olab, pw, J):
    """Per-band oracle assignment sigma[b][stem] = oracle source, via
    power-weighted agreement (the 'init' emitter's construction against
    the oracle plane)."""
    from pyfasst_jax.models.spatial_init import _best_assignment
    B = len(starts)
    sigma = np.zeros((B, J), np.int64)
    for b, s0 in enumerate(starts):
        sl = slice(s0, s0 + Fb)
        oh = np.eye(J)[lab_b[pick[b]]]                    # (Fb, N, J)
        ov = np.eye(J)[olab[sl]] * pw[sl, :, None]
        T = np.einsum("fna,fnb->ab", oh, ov)[None]
        sigma[b] = np.argsort(_best_assignment(T)[0])
    return sigma


def _rel_from_global(inv):
    """inv (B, J) global band alignment -> relative perms (B-1, J):
    rel[b][a] = stem of band b+1 carrying the same channel as stem a of
    band b."""
    B, J = inv.shape
    rel = np.zeros((B - 1, J), np.int64)
    for b in range(B - 1):
        rel[b] = np.argsort(inv[b + 1])[inv[b]]
    return rel


def _band_acc(inv, sigma):
    """Fraction of bands whose channel->source map agrees with the
    majority, maximized over the global permutation (= best global
    relabeling of the emitted channels)."""
    from itertools import permutations
    B, J = inv.shape
    comp = np.stack([sigma[b][np.argsort(inv[b])] for b in range(B)])
    best = 0.0
    for g in permutations(range(J)):
        best = max(best, float(np.mean([np.array_equal(comp[b], g)
                                        for b in range(B)])))
    return best


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--family", default="image",
                    choices=("mini", "reverb", "image", "music3",
                             "speech"))
    ap.add_argument("--seeds", default="202,203")
    ap.add_argument("--band-width", type=int, default=32)
    ap.add_argument("--iters", type=int, default=150)
    ap.add_argument("--glue-iters", default="60")
    ap.add_argument("--glue-comps", type=int, default=3,
                    help="nmf comps per source in the glue EMs (small = "
                         "stronger coupling penalty for a wrong glue)")
    ap.add_argument("--fixed-spatial", default="both",
                    choices=("both", "yes", "no"))
    ap.add_argument("--nmf-comps", type=int, default=3)
    ap.add_argument("--n-seeds", type=int, default=8)
    ap.add_argument("--em-seeds", type=int, default=2)
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend")
    args = ap.parse_args()

    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    from pyfasst_jax.models.spatial_init import (
        _band_em_probes, _chain_glue, glue_band_perms,
    )
    from pyfasst_jax.models.spatial_init import band_em_votes  # noqa: F401
    from pyfasst_jax.tf.stft import STFT

    glue_iters = [int(x) for x in args.glue_iters.split(",")]

    for seed in (int(s) for s in args.seeds.split(",")):
        mix, ys_true, fs, wlen, J = _fixture(args.family, seed)
        n = mix.shape[0]
        tft = STFT(wlen=wlen, fs=fs)
        X = np.asarray(tft.computeTransform(mix.astype(np.float32)))
        P = [np.abs(np.asarray(tft.computeTransform(
            ys_true[j].astype(np.float32)))).astype(np.float64) ** 2
            for j in range(J)]
        olab = np.argmax(np.stack([p.sum(-1) for p in P]), axis=0)

        t0 = time.perf_counter()
        probes = _band_em_probes(
            X, J, band_width=args.band_width, iters=args.iters,
            nmf_comps=args.nmf_comps, n_seeds=args.n_seeds,
            em_seeds=args.em_seeds, seed=0)
        t_probe = time.perf_counter() - t0
        starts, Fb, pick = probes.starts, probes.Fb, probes.pick
        pw = probes.pw
        B = len(starts)
        sigma = _oracle_band_perms(probes.lab, pick, starts, Fb,
                                   olab, pw, J)
        # sigma maps stem->source, so it is itself a global alignment
        # with channel = oracle source; the oracle relative perms follow
        rel_star = _rel_from_global(sigma)
        inv_oracle = sigma

        def _emit(inv):
            F, N = X.shape[:2]
            votes = np.zeros((F, N, J))
            counts = np.zeros((F, 1, 1))
            for b, s0 in enumerate(starts):
                lab = inv[b][probes.lab[pick[b]]]
                votes[s0:s0 + Fb] += np.eye(J)[lab]
                counts[s0:s0 + Fb] += 1.0
            return votes / counts

        rows = {}
        ub = _acc(np.argmax(_emit(inv_oracle), -1), olab, pw, J)

        # envelope + init + spatial from band_em_votes' emitters,
        # reusing the SAME probe set
        _votes, detail = band_em_votes(
            X, J, band_width=args.band_width, seed=0, band_align="all",
            probes=probes, return_detail=True)
        for mode, inv in detail["inv"].items():
            rows[mode] = {
                "pair_acc": float(np.mean(np.all(
                    _rel_from_global(inv) == rel_star, axis=1))),
                "band_acc": _band_acc(inv, sigma),
                "vote_acc": round(_acc(np.argmax(_votes[mode], -1),
                                       olab, pw, J), 4),
            }

        for gi in glue_iters:
            for fixed in (False, True) if args.fixed_spatial == "both" \
                    else ((args.fixed_spatial == "yes"),):
                t0 = time.perf_counter()
                perms, margins = glue_band_perms(
                    X, J, probes, glue_iters=gi, fixed_spatial=fixed,
                    nmf_comps=args.glue_comps, seed=0)
                t_glue = time.perf_counter() - t0
                inv = _chain_glue(perms, J)
                correct = np.all(perms == rel_star, axis=1)
                rows[f"glue{'F' if fixed else ''}{gi}"] = {
                    "pair_acc": float(np.mean(correct)),
                    "band_acc": _band_acc(inv, sigma),
                    "vote_acc": round(_acc(np.argmax(_emit(inv), -1),
                                           olab, pw, J), 4),
                    "margin_ok": round(float(
                        np.median(margins[correct])), 2)
                    if correct.any() else None,
                    "margin_bad": round(float(
                        np.median(margins[~correct])), 2)
                    if (~correct).any() else None,
                    "wall_s": round(t_glue, 1),
                }

        print(json.dumps({
            "family": args.family, "seed": seed, "B": B,
            "pairs": B - 1, "ub_vote_acc": round(ub, 4),
            "probe_wall_s": round(t_probe, 1),
            "methods": rows,
        }), flush=True)


if __name__ == "__main__":
    main()
