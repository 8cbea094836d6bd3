"""Alignment-machinery isolation lab (speech + music fine grids).

speech_lab/feat_context_lab found: speech partitions are EXCELLENT
(per-frequency oracle-fix UB 0.81-0.87 at wlen 2048) yet the aligned
consensus lands at 0.44-0.65 — the cross-frequency alignment machinery
itself is failing in its design regime (independent syllabic envelopes).

This lab isolates WHERE, with two controlled inputs per scenario:

  scrambled-oracle   oracle labels with a random per-frequency
                     permutation: PERFECT partitions, only the
                     permutation is lost. Recovery == how well the
                     alignment machinery can ever do here (its own UB
                     is 1.0 by construction).
  real clusters      one production k-means seed (the deployed input).

and two embedding backends for each:

  device   production path at FJ > 2052: jitted graph build + 64-step
           reorthogonalized float32 Lanczos (_embed_nodes_device)
  host     float64 dense eigh (the path every configs[2]-gated number
           used; FJ <= 2052 still takes it in production)

If device << host on the SAME labels, the Lanczos embedding is lossy and
every FJ > 2052 alignment (speech 3075, music fine grid 3075, music
coarse 12291) silently degraded when the device path landed — the
scrambled-oracle music recovery of 0.75 in design.md §6e predates it.

Usage: python tools/speech_align_lab.py --scenario speech --seed 120
       python tools/speech_align_lab.py --scenario music3 --seed 100
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", default="speech",
                    choices=("speech", "music3", "reverb"))
    ap.add_argument("--wlen", type=int, default=2048)
    ap.add_argument("--hop", type=int, default=None,
                    help="STFT hop (default wlen//2); wlen//4 doubles "
                         "the frames the alignment envelopes see "
                         "without changing window smearing")
    ap.add_argument("--seed", type=int, default=120)
    ap.add_argument("--backends", default="device,host")
    ap.add_argument("--env-transform", default=None,
                    help="override spatial_init._ENV_TRANSFORM "
                         "(log1p | rank) for the production path")
    ap.add_argument("--skip-real", action="store_true")
    args = ap.parse_args()

    from pyfasst_jax.tf.stft import STFT
    import pyfasst_jax.models.spatial_init as si

    if args.scenario == "speech":
        from speech_lab import _fixture, FS
        J = 3
        mix, ys_true, n = _fixture(J, 0.25, args.seed)
    elif args.scenario == "music3":
        from music_lab import _fixture, FS
        J = 3
        mix, ys_true, n = _fixture(J, 0.12, args.seed)
    else:
        from reverb_lab import make_fixture
        X, Yt, ys_true, mix, tft, n = make_fixture(args.seed)
        J = 4
        FS = None
    if args.scenario != "reverb":
        tft = STFT(wlen=args.wlen, hop=args.hop, fs=FS)
        X = np.asarray(tft.computeTransform(mix.astype(np.float32)))

    P = []
    for j in range(J):
        Yj = np.asarray(tft.computeTransform(
            np.ascontiguousarray(ys_true[j]).astype(np.float32)))
        P.append((np.abs(Yj) ** 2).sum(-1))
    olab = np.argmax(np.stack(P), axis=0)
    feat, w, pw, xx = si.tf_covariance_features(X)
    F, N = pw.shape
    print(f"align_lab: {args.scenario} F {F} N {N} J {J} FJ {F * J}",
          file=sys.stderr, flush=True)

    rng = np.random.default_rng(0)
    perms = np.stack([rng.permutation(J) for _ in range(F)])  # (F, J)
    scr = np.take_along_axis(perms, olab, axis=1)             # scrambled
    assert abs(_acc_perfreq(scr, olab, pw, J) - 1.0) < 1e-4, \
        _acc_perfreq(scr, olab, pw, J)

    inputs = [("scrambled_oracle", scr)]
    if not args.skip_real:
        labs_all = si._cluster_labels_jax(feat, w, J, 1, 30)
        inputs.append(("real_clusters", np.asarray(labs_all[0])))

    saved = si._EMBED_DEVICE_MIN_NODES
    saved_tr = si._ENV_TRANSFORM
    if args.env_transform:
        si._ENV_TRANSFORM = args.env_transform
    for name, lab in inputs:
        ub = _acc_perfreq(lab, olab, pw, J)
        for backend in args.backends.split(","):
            si._EMBED_DEVICE_MIN_NODES = 0 if backend == "device" \
                else 10 ** 9
            t0 = time.time()
            La = si._align_spectral(lab, pw, J)
            acc = _acc(La, olab, pw, J)
            print(json.dumps({
                "input": name, "backend": backend,
                "env_transform": si._ENV_TRANSFORM,
                "acc": round(acc, 4), "ub": round(ub, 4),
                "wall_s": round(time.time() - t0, 1)}), flush=True)
    si._EMBED_DEVICE_MIN_NODES = saved
    si._ENV_TRANSFORM = saved_tr


if __name__ == "__main__":
    main()
