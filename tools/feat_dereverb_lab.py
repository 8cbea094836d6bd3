"""Per-bin FEATURE-family lab: WPE dereverberation + onset weighting.

design.md §6e closes round 3 with: every selection/alignment/smoothing
lever on fine-grid vote quality is measured dead; "the levers that would
move it are better per-bin FEATURES (raising the 0.74 clustering UB
itself)". This lab measures the two untried feature families that attack
the saturation MECHANISM (0 dB direct-to-reverb per-bin covariances):

  wpe     -- per-frequency multichannel linear-prediction dereverberation
             (pyfasst_jax/tf/dereverb.py) BEFORE feature extraction:
             removes the predictable late tail, raising every bin's D/R.
  onsetw  -- precedence-effect weighting: cluster centroids estimated
             from onset-novelty-weighted frames (at onsets the direct
             path dominates before the tail builds up), labels assigned
             to all bins as usual.
  combinations thereof, vs the plain production features.

Scored exactly like feat_context_lab: per k-means seed the raw /
spectrally-aligned / per-frequency-oracle-fix-UB accuracies on the
oracle dominance plane, plus the 8-seed consensus vote accuracy (the
quantity the candidate pool consumes). No EM.

Usage: python tools/feat_dereverb_lab.py [--scenario music3|reverb|speech]
           [--seed 100] [--wlen 2048] [--variants plain,wpe,onsetw,...]
           [--wpe-order 8] [--wpe-delay 2]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from align_diag import _acc, _acc_perfreq                   # noqa: E402


def onset_weights(pw: np.ndarray, blend: float = 0.0) -> np.ndarray:
    """Per-bin onset-novelty weights, frame-mean-normalized like the
    production power weights. blend in [0, 1]: geometric blend with the
    plain power weight (1.0 = pure power = production)."""
    nov = np.maximum(pw - np.concatenate(
        [pw[:, :1], pw[:, :-1]], axis=1), 0.0)
    w_on = nov / np.maximum(nov.mean(axis=1, keepdims=True), 1e-20)
    if blend <= 0:
        return w_on
    w_pw = pw / np.maximum(pw.mean(axis=1, keepdims=True), 1e-20)
    return w_on ** (1 - blend) * w_pw ** blend


def build_variant(X, name: str, wpe_order: int, wpe_delay: int):
    """-> (feat, w_cluster, pw) for a named feature variant."""
    from pyfasst_jax.models.spatial_init import tf_covariance_features
    from pyfasst_jax.tf.dereverb import wpe_dereverb

    base = name.split("+")
    Xf = X
    if "wpe" in base:
        Xf = wpe_dereverb(X, order=wpe_order, delay=wpe_delay)
    feat, w, pw_f, _ = tf_covariance_features(Xf)
    pw = (np.abs(X) ** 2).sum(-1)      # alignment/votes use ORIGINAL power
    if "onsetw" in base:
        w = onset_weights(pw_f)
    elif "onsetb" in base:
        w = onset_weights(pw_f, blend=0.5)
    return feat, w, pw


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", default="music3",
                    choices=("music3", "music4", "reverb", "speech",
                             "image"))
    ap.add_argument("--wlen", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=100)
    ap.add_argument("--variants",
                    default="plain,wpe,onsetw,onsetb,wpe+onsetw")
    ap.add_argument("--wpe-order", type=int, default=8)
    ap.add_argument("--wpe-delay", type=int, default=2)
    ap.add_argument("--n-seeds", type=int, default=8)
    args = ap.parse_args()

    from pyfasst_jax.models.spatial_init import (
        _align_spectral, _cluster_labels_jax, _vote_consensus,
    )
    from pyfasst_jax.tf.stft import STFT

    if args.scenario.startswith("music"):
        from music_lab import _fixture, FS
        J = 3 if args.scenario == "music3" else 4
        t60 = 0.12 if J == 3 else 0.25
        mix, ys_true, n = _fixture(J, t60, args.seed)
        tft = STFT(wlen=args.wlen, fs=FS)
        X = np.asarray(tft.computeTransform(mix.astype(np.float32)))
    elif args.scenario == "speech":
        from speech_lab import _fixture, FS
        J = 3
        mix, ys_true, n = _fixture(J, 0.25, args.seed)
        tft = STFT(wlen=args.wlen, fs=FS)
        X = np.asarray(tft.computeTransform(mix.astype(np.float32)))
    elif args.scenario == "image":
        from fixtures2 import make_image_fixture
        J = 4
        mix, ys_true, _meta = make_image_fixture(args.seed, fs=16000,
                                                 dur=6.0, J=J)
        tft = STFT(wlen=1024, fs=16000)
        X = np.asarray(tft.computeTransform(mix.astype(np.float32)))
    else:
        from reverb_lab import make_fixture
        X, Yt, ys_true, mix, tft, n = make_fixture(args.seed)
        J = 4

    P = []
    for j in range(J):
        Yj = np.asarray(tft.computeTransform(
            np.ascontiguousarray(ys_true[j]).astype(np.float32)))
        P.append((np.abs(Yj) ** 2).sum(-1))
    olab = np.argmax(np.stack(P), axis=0)

    print(json.dumps({"scenario": args.scenario, "seed": args.seed,
                      "wlen": args.wlen, "wpe_order": args.wpe_order,
                      "wpe_delay": args.wpe_delay}), flush=True)
    for name in args.variants.split(","):
        if name.startswith("bandem"):
            # model-evidence votes (band-local EM probes); scored on the
            # SAME oracle plane. bandem32 etc. selects the band width.
            from pyfasst_jax.models.spatial_init import band_em_votes
            bw = int(name[6:]) if len(name) > 6 else 32
            pw = (np.abs(X) ** 2).sum(-1)
            bv = band_em_votes(X, J, band_width=bw, iters=150,
                               n_seeds=args.n_seeds, band_align="all")
            rec = {"variant": name}
            for mode, v in bv.items():
                lab = np.argmax(v, -1)
                key = "" if mode == "envelope" else f"_{mode}"
                rec["ub" + key] = round(
                    float(_acc_perfreq(lab, olab, pw, J)), 4)
                rec["consensus" + key] = round(
                    float(_acc(lab, olab, pw, J)), 4)
            print(json.dumps(rec), flush=True)
            continue
        noalign = name.endswith("-noalign")
        base = name[:-8] if noalign else name
        feat, w, pw = build_variant(X, base, args.wpe_order,
                                    args.wpe_delay)
        labs_all = _cluster_labels_jax(feat, w, J, args.n_seeds, 30)
        raws, specs, ubs, aligned = [], [], [], []
        for s in range(args.n_seeds):
            L = np.asarray(labs_all[s])
            raws.append(_acc(L, olab, pw, J))
            ubs.append(_acc_perfreq(L, olab, pw, J))
            if noalign:
                # trust the global warm-start's own cross-frequency
                # consistency (the consensus vote still permutation-
                # matches seeds to each other)
                aligned.append(L)
                specs.append(raws[-1])
            else:
                La = _align_spectral(L, pw, J)
                aligned.append(La)
                specs.append(_acc(La, olab, pw, J))
        v = _vote_consensus(aligned, pw, J)
        cons = _acc(np.argmax(v, -1), olab, pw, J)
        print(json.dumps({
            "variant": name,
            "raw": round(float(np.mean(raws)), 4),
            "spectral": round(float(np.mean(specs)), 4),
            "ub": round(float(np.mean(ubs)), 4),
            "ub_max": round(float(np.max(ubs)), 4),
            "consensus": round(float(cons), 4),
        }), flush=True)


if __name__ == "__main__":
    main()
