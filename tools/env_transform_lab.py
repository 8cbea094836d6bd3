"""Node-envelope transform sweep for the spectral alignment.

speech_align_lab found the alignment machinery saturates at ~0.70-0.77
scrambled-ORACLE recovery on speech/music fine grids — with PERFECT
per-frequency partitions. The node envelope entering the affinity graph
is log1p(act / mean) (centered cosine). For sparse, switching sources
(speech syllables) other transforms of the dominance-masked power may
correlate better across frequency. This lab scores the SAME spectral
pipeline (host eigh; production k-means) with the transform swapped:

  log1p    production (log1p of mean-normalized activity)
  sqrt     amplitude-ish compression
  raw      plain activity
  binary   active = act > 0.1 * active-mean (a dominance indicator)
  rank     per-node rank transform (Spearman-style correlation)

Inputs per scenario/seed: scrambled-oracle labels and one real k-means
seed. Usage: python tools/env_transform_lab.py --scenario speech
                 --seed 120 [--wlen 2048]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from align_diag import _acc, _acc_perfreq


def _align_with_transform(lab, pw, J, transform: str, seed: int = 0):
    import pyfasst_jax.models.spatial_init as si

    F, N = lab.shape
    oh = np.eye(J)[lab]
    act = np.einsum('fnj,fn->fjn', oh, pw)
    npow = act.sum(-1).reshape(F * J)

    a = act / np.maximum(act.mean(-1, keepdims=True), 1e-20)
    if transform == "log1p":
        E = np.log1p(a)
    elif transform == "sqrt":
        E = np.sqrt(a)
    elif transform == "raw":
        E = a
    elif transform == "binary":
        E = (a > 0.1).astype(np.float64)
    elif transform == "rank":
        E = np.argsort(np.argsort(a, axis=-1), axis=-1).astype(np.float64)
    else:
        raise ValueError(transform)
    E = si._normrows(E)
    nodes = E.reshape(F * J, N)
    W = np.maximum(nodes @ nodes.T, 0.0)
    idx = np.arange(F * J).reshape(F, J)
    for f in range(F):
        W[np.ix_(idx[f], idx[f])] = 0.0
    sw = np.sqrt(npow / max(npow.mean(), 1e-20))
    W = W * np.minimum(sw[:, None], 3) * np.minimum(sw[None, :], 3)
    d = W.sum(1) + 1e-9
    Dm = 1.0 / np.sqrt(d)
    L = Dm[:, None] * W * Dm[None, :]
    _, vecs = np.linalg.eigh(L)
    U = vecs[:, -J:]
    U = U / np.maximum(np.linalg.norm(U, axis=1, keepdims=True), 1e-12)
    cent = si._spherical_kmeans(U, npow, J, seed=seed)
    sel = si._assignment_from_embedding(U, cent, F, J)
    inv = np.argsort(sel, axis=1)
    return np.take_along_axis(inv, lab, axis=1)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", default="speech",
                    choices=("speech", "music3", "reverb"))
    ap.add_argument("--wlen", type=int, default=2048)
    ap.add_argument("--hop", type=int, default=None)
    ap.add_argument("--seed", type=int, default=120)
    ap.add_argument("--transforms",
                    default="log1p,sqrt,raw,binary,rank")
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
    print(f"env_lab: {args.scenario} F {F} N {N} J {J}",
          file=sys.stderr, flush=True)

    rng = np.random.default_rng(0)
    perms = np.stack([rng.permutation(J) for _ in range(F)])
    scr = np.take_along_axis(perms, olab, axis=1)
    inputs = [("scrambled_oracle", scr)]
    if not args.skip_real:
        labs_all = si._cluster_labels_jax(feat, w, J, 1, 30)
        inputs.append(("real_clusters", np.asarray(labs_all[0])))

    for name, lab in inputs:
        ub = _acc_perfreq(lab, olab, pw, J)
        for tr in args.transforms.split(","):
            La = _align_with_transform(lab, pw, J, tr)
            print(json.dumps({
                "input": name, "transform": tr,
                "acc": round(_acc(La, olab, pw, J), 4),
                "ub": round(ub, 4)}), flush=True)


if __name__ == "__main__":
    main()
