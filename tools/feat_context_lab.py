"""Feature-context lab: does local covariance smoothing raise the
fine-grid clustering's own upper bound?

design.md §6e: the fine-grid (wlen 2048) per-frequency clusters cap the
whole music ladder at a per-frequency oracle-fix UB of ~0.74 (vs 0.83 at
wlen 8192). The clustering features are PER-BIN normalized rank-1
covariance entries (tf_covariance_features); at 0 dB direct-to-reverb a
single bin's covariance is a noisy estimate of the source's spatial
signature. The classic remedy is local expectation: average the rank-1
covariances over a small time/frequency neighborhood BEFORE normalizing
(Duong-style local Gaussian model), trading temporal purity (neighbor
frames may be dominated by another source) against estimator variance.

This lab scores, per k-means seed, on the oracle dominance plane:
  raw  acc   global-permutation accuracy of the clusters as they come
  spec acc   after _align_spectral (the production path)
  UB         per-frequency oracle-fix accuracy (ceiling of ANY alignment)
for covariance smoothing windows (time x freq): 1x1 (baseline), 3x1,
5x1, 1x3, 3x3. No EM — minutes per scenario.

Usage: python tools/feat_context_lab.py [--scenario music3|music4|reverb]
           [--wlen 2048] [--seed 100] [--n-seeds 4]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from align_diag import _acc, _acc_perfreq


def smoothed_features(X: np.ndarray, tw: int = 1, fw: int = 1):
    """tf_covariance_features with the rank-1 bin covariances box-averaged
    over a (fw x tw) frequency-time neighborhood before normalization.
    Weights/powers stay PER-BIN (the partition is still over bins; only
    the spatial signature estimate is smoothed). Stereo-only lab helper."""
    p0 = np.abs(X[..., 0]) ** 2
    p1 = np.abs(X[..., 1]) ** 2
    cr = X[..., 0] * np.conj(X[..., 1])
    pw = p0 + p1
    ent = np.stack([p0, p1, cr.real, cr.imag], -1)         # (F, N, 4)

    def box(a, w, axis):
        if w <= 1:
            return a
        k = np.ones(w) / w
        return np.apply_along_axis(
            lambda v: np.convolve(v, k, mode="same"), axis, a)

    ent_s = box(box(ent, tw, 1), fw, 0)
    den = ent_s[..., 0] + ent_s[..., 1]
    feat = ent_s / np.maximum(den, 1e-20)[..., None]
    w = pw / np.maximum(pw.mean(axis=1, keepdims=True), 1e-20)
    return feat.astype(np.float64), w, pw


def _acc_perfreq_plane(lab, olab, pw, J):
    """Per-frequency oracle-fixed correct POWER MASS (F,) plus the
    per-frequency total mass (F,). Summing the ratio gives _acc_perfreq."""
    from itertools import permutations
    perms = list(permutations(range(J)))
    oh = np.eye(J)[lab] * pw[..., None]
    T = np.einsum('fnj,fnk->fjk', oh, np.eye(J)[olab])
    scores = np.stack([T[:, list(p), np.arange(J)].sum(-1)
                       for p in perms], 1)                 # (F, P)
    return scores.max(1), pw.sum(1)


def _r2_perfreq(lab, feat, w, J):
    """Per-frequency weighted 1 - SSW/SST of partition `lab` scored on
    feature set `feat` (the blind cluster-quality statistic)."""
    F, N = lab.shape
    oh = np.eye(J)[lab]
    wm = oh * w[..., None]
    den = wm.sum(1)                                        # (F, J)
    C = np.einsum('fnj,fnd->fjd', wm, feat) \
        / np.maximum(den, 1e-12)[..., None]
    Cl = C[np.arange(F)[:, None], lab]                     # (F, N, D)
    ssw = (w * ((feat - Cl) ** 2).sum(-1)).sum(1)
    wsum = np.maximum(w.sum(1), 1e-12)
    mu = np.einsum('fn,fnd->fd', w, feat) / wsum[..., None]
    sst = (w * ((feat - mu[:, None]) ** 2).sum(-1)).sum(1)
    return 1.0 - ssw / np.maximum(sst, 1e-12)


def _stability_perfreq(labs, pw, J):
    """Per-frequency mean pairwise best-permutation agreement (power
    mass fraction) across seeds — a blind per-window statistic."""
    from itertools import permutations
    perms = list(permutations(range(J)))
    S = len(labs)
    pw_f = np.maximum(pw.sum(1), 1e-20)
    agr = np.zeros(pw.shape[0])
    npairs = 0
    ohs = [np.eye(J)[L] for L in labs]
    for a in range(S):
        wa = ohs[a] * pw[..., None]
        for b in range(a + 1, S):
            T = np.einsum('fnj,fnk->fjk', wa, ohs[b])
            scores = np.stack([T[:, list(p), np.arange(J)].sum(-1)
                               for p in perms], 1)
            agr += scores.max(1) / pw_f
            npairs += 1
    return agr / max(npairs, 1)


def _consensus_acc(labs, pw, J, olab, _align, _vote):
    labs_a = [_align(L, pw, J) for L in labs]
    v = _vote(labs_a, pw, J)
    return _acc(np.argmax(v, -1), olab, pw, J)


def run_perfreq(args, X, olab, J):
    """Per-frequency adaptive context window: is there a blind,
    per-frequency signal for WHERE covariance smoothing helps?

    Measures (8 seeds, windows 1x1 vs 3x1, draw-shared pick planes):
    the oracle-mix UB ceiling (complementarity of the two windows'
    per-frequency-fix planes), blind picks by R^2-on-plain-features and
    by cross-seed stability, concat (8-dim) features, and the realized
    consensus-vote accuracy of each variant."""
    from pyfasst_jax.models.spatial_init import (
        _align_spectral, _cluster_labels_jax, _vote_consensus,
    )
    n_seeds = 8
    wins = [(1, 1), (3, 1)]
    feats, labs_w = [], []
    for tw, fw in wins:
        feat, w, pw = smoothed_features(X, tw=tw, fw=fw)
        feats.append((feat, w, pw))
        labs_all = _cluster_labels_jax(feat, w, J, n_seeds, 30)
        labs_w.append([np.asarray(labs_all[s]) for s in range(n_seeds)])
    pw = feats[0][2]
    pw_f = np.maximum(pw.sum(1), 1e-20)

    # per-frequency oracle-fixed mass planes, seed-averaged per window
    mass = []            # mass[v] (F,): mean correct mass per frequency
    for v in range(len(wins)):
        planes = [_acc_perfreq_plane(L, olab, pw, J)[0] for L in labs_w[v]]
        mass.append(np.mean(planes, axis=0))
    ub = [float(m.sum() / pw_f.sum()) for m in mass]

    # draw-shared pick planes
    picks = {"oracle": np.argmax(np.stack(mass), 0)}
    feat_plain, w_plain = feats[0][0], feats[0][1]
    r2 = [np.mean([_r2_perfreq(L, feat_plain, w_plain, J)
                   for L in labs_w[v]], axis=0) for v in range(len(wins))]
    picks["r2"] = np.argmax(np.stack(r2), 0)
    stab = [_stability_perfreq(labs_w[v], pw, J) for v in range(len(wins))]
    picks["stab"] = np.argmax(np.stack(stab), 0)

    rec = {"ub_1x1": round(ub[0], 4), "ub_3x1": round(ub[1], 4)}
    for name, pick in picks.items():
        mixed_mass = np.take_along_axis(
            np.stack(mass), pick[None], 0)[0]
        rec[f"ub_{name}mix"] = round(float(mixed_mass.sum() / pw_f.sum()), 4)
        if name != "oracle":
            agree = float((pw_f * (pick == picks["oracle"])).sum()
                          / pw_f.sum())
            rec[f"agree_{name}"] = round(agree, 4)

    # realized consensus accuracy: per window, per pick plane, concat
    def cons_of(labs):
        labs_a = [_align_spectral(L, pw, J) for L in labs]
        v = _vote_consensus(labs_a, pw, J)
        return round(_acc(np.argmax(v, -1), olab, pw, J), 4)

    rec["cons_1x1"] = cons_of(labs_w[0])
    rec["cons_3x1"] = cons_of(labs_w[1])
    for name, pick in picks.items():
        mixed = [np.where(pick[:, None] == 0, labs_w[0][s], labs_w[1][s])
                 for s in range(n_seeds)]
        rec[f"cons_{name}mix"] = cons_of(mixed)

    featc = np.concatenate([feats[0][0], feats[1][0]], -1)
    labs_all = _cluster_labels_jax(featc, w_plain, J, n_seeds, 30)
    labs_c = [np.asarray(labs_all[s]) for s in range(n_seeds)]
    planes = [_acc_perfreq_plane(L, olab, pw, J)[0] for L in labs_c]
    rec["ub_concat"] = round(
        float(np.mean(planes, axis=0).sum() / pw_f.sum()), 4)
    rec["cons_concat"] = cons_of(labs_c)
    print(json.dumps(rec), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", default="music3",
                    choices=("music3", "music4", "reverb", "speech"))
    ap.add_argument("--wlen", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=100)
    ap.add_argument("--n-seeds", type=int, default=4)
    ap.add_argument("--windows", default="1x1,3x1,5x1,1x3,3x3")
    ap.add_argument("--consensus", action="store_true",
                    help="also score the production-style 8-seed "
                         "consensus vote plane (the quantity the "
                         "candidate pool actually consumes)")
    ap.add_argument("--perfreq", action="store_true",
                    help="per-frequency adaptive window diagnostic "
                         "(oracle-mix ceiling, blind pick statistics, "
                         "concat features)")
    args = ap.parse_args()

    from pyfasst_jax.tf.stft import STFT
    from pyfasst_jax.models.spatial_init import (
        _align_spectral, _cluster_labels_jax, _vote_consensus,
    )

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

    if args.perfreq:
        print(json.dumps({"scenario": args.scenario, "seed": args.seed,
                          "wlen": args.wlen, "mode": "perfreq"}),
              flush=True)
        run_perfreq(args, X, olab, J)
        return

    for wspec in args.windows.split(","):
        tw, fw = (int(v) for v in wspec.split("x"))
        feat, w, pw = smoothed_features(X, tw=tw, fw=fw)
        n_seeds = 8 if args.consensus else args.n_seeds
        labs_all = _cluster_labels_jax(feat, w, J, n_seeds, 30)
        raws, specs, ubs, aligned = [], [], [], []
        for s in range(n_seeds):
            L = np.asarray(labs_all[s])
            raws.append(_acc(L, olab, pw, J))
            ubs.append(_acc_perfreq(L, olab, pw, J))
            La = _align_spectral(L, pw, J)
            aligned.append(La)
            specs.append(_acc(La, olab, pw, J))
        rec = {
            "win": wspec,
            "raw": round(float(np.mean(raws)), 4),
            "spectral": round(float(np.mean(specs)), 4),
            "spectral_max": round(float(np.max(specs)), 4),
            "ub": round(float(np.mean(ubs)), 4),
            "ub_max": round(float(np.max(ubs)), 4),
        }
        if args.consensus:
            v = _vote_consensus(aligned, pw, J)
            rec["consensus"] = round(_acc(np.argmax(v, -1), olab, pw, J), 4)
            # blind per-window health statistics (candidate selectors for
            # a per-draw feature-set pick -- no oracle input):
            # margin: power-weighted mean (top - second) consensus share;
            # seed_agree: power-weighted mean per-seed agreement with the
            # consensus argmax at the best global permutation
            vs = np.sort(v, axis=-1)
            marg = (vs[..., -1] - vs[..., -2]) * pw
            rec["margin"] = round(float(marg.sum() / pw.sum()), 4)
            cons_lab = np.argmax(v, -1)
            agr = [_acc(La, cons_lab, pw, J) for La in aligned]
            rec["seed_agree"] = round(float(np.mean(agr)), 4)
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
