"""configs[2] diagnosis lab: every blind-init hypothesis run to FULL
convergence, scored against ground truth, with the blind selection
statistics recorded alongside.

The round-2 verdict's top item is the blind reverberant full-rank gap:
median blind min-SDR 2.4 dB vs ~13.5 dB from oracle spatial init. The
production pipeline (models/spatial_init.py) probes candidates for 60
iterations and picks by vetoed likelihood, then re-runs the winner from a
fresh spectral seed. This lab separates the two failure hypotheses:

  (a) CANDIDATE quality: does ANY hypothesis in the pool reach a good
      min-SDR when run to full convergence? (oracle-selection ceiling)
  (b) SELECTION quality: do the blind statistics (final loglik, stem
      envelope correlation) identify that hypothesis?

Method: build the full candidate pool (raw + merge/split + direction-first
splits), replicate each under `--em-seeds` spectral seeds, run ALL of them
to `--iters` in ONE batched device program (the configs[4] executable),
Wiener-separate, and score (c, J, J) pairwise STFT-domain errors against
the true source-image STFTs ON DEVICE -- only (C, J, J) scalars come back
to the host, not C full separations. Prints one JSON line per run and an
oracle-vs-blind summary per draw.

Usage: python tools/reverb_lab.py --draws 102 103 104 105 106 --iters 400
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def make_fixture(fixture_seed: int):
    """The reverb_robustness / validate_hw::scenario_reverb fixture family."""
    from tools.validate_hw import FS, WLEN, _sources
    from pyfasst_jax.tf.stft import STFT

    rng = np.random.default_rng(fixture_seed)
    n = int(FS * 6.0)
    srcs = _sources(rng, n, ["harm", "noise_lo", "noise_hi", "clicks"])
    ys_true = []
    for j, s in enumerate(srcs):
        chs = []
        for ch in range(2):
            h = rng.standard_normal(100) * np.exp(-np.arange(100) / 20.0)
            h[0] += 1.5 if ch == (j % 2) else 0.4
            chs.append(np.convolve(s, h, "same"))
        ys_true.append(np.stack(chs, 1))
    ys_true = np.stack(ys_true)
    mix = ys_true.sum(0)
    tft = STFT(wlen=WLEN, fs=FS)
    X = np.asarray(tft.computeTransform(mix.astype(np.float32)))
    Yt = np.stack([np.asarray(tft.computeTransform(
        ys_true[j].astype(np.float32))) for j in range(4)])
    return X, Yt, ys_true, mix, tft, n


def candidate_pool(X: np.ndarray, J: int):
    """The production pool: raw votes + merge/split + direction-first."""
    from pyfasst_jax.models.spatial_init import (
        candidate_votes, direction_split_candidates, tf_covariance_features,
        consensus_votes,
    )
    feat, w, pw, xx = tf_covariance_features(X)
    votes = consensus_votes(X, J)
    cands = candidate_votes(votes, pw)
    cands += direction_split_candidates(X, J, pw)
    return cands, pw, xx


def run_pool(X, cands, pw, xx, Yt, iters: int, em_seeds: int,
             nmf_comps: int = 6, align_at=None, chunk: int = 24,
             return_Y: bool = False, return_votes: bool = False):
    """Run every (candidate, seed) to `iters` in batched programs of at
    most `chunk` runs each (production probes run ~20-40 wide).

    Returns a list of records with blind stats (final ll, envcorr) and
    oracle stats (min/mean STFT-domain image SDR at best permutation).
    align_at: optional fraction in (0, 1) -- run to align_at*iters, apply
    host-side per-frequency permutation re-alignment of the mixing planes
    (Duong-style), then continue to iters (uses the chunked bounds path).
    """
    import jax
    import jax.numpy as jnp

    from pyfasst_jax.models.components import (
        CONV, FasstParams, SpatialComp, init_nmf_comp,
    )
    from pyfasst_jax.models.spatial_init import (
        _max_env_corr, activity_profiles, apply_profiles, mixing_from_votes,
    )
    from pyfasst_jax.ops.gem import annealing_endpoints
    from pyfasst_jax.parallel.sharding import (
        batch_params, batched_run_gem, make_mesh, sharded_batch_separate,
    )
    from pyfasst_jax.utils.config import GEMConfig
    import jax.numpy as jnp

    J = cands[0][1].shape[-1]
    F, N = X.shape[:2]
    scale = float(np.sqrt(np.mean(np.abs(X) ** 2)))
    Xd = jnp.asarray(np.ascontiguousarray(X)) / scale
    Yt_d = jnp.asarray(np.ascontiguousarray(
        np.transpose(Yt, (0, 1, 2, 3)))) / scale      # (J, F, N, 2)
    cfg = GEMConfig(niter=iters, spatial_hold_frac=0.3)

    names, plist = [], []
    for name, v in cands:
        A = mixing_from_votes(v, xx, pw, rank=2)
        twp, fbp = activity_profiles(v, pw)
        for s in range(em_seeds):
            keys = list(jax.random.split(jax.random.PRNGKey(s), J))
            spat = tuple(SpatialComp(A=jnp.asarray(A[j]),
                                     mix_type=CONV) for j in range(J))
            spec = tuple(init_nmf_comp(keys[j], F, N, nmf_comps, spat_ind=j)
                         for j in range(J))
            plist.append(apply_profiles(FasstParams(spat=spat, spec=spec),
                                        twp, fbp))
            names.append(f"{name}|s{s}")

    mesh = make_mesh(1)
    _, sigma1 = annealing_endpoints(Xd, cfg)

    @jax.jit
    def pair_errors(Y_b, Yt_d):
        # (C, Je, Jt) squared errors + per-true reference powers, computed
        # ON device -- the only fetch is (C, J, J) + (J,) scalars. Yt_d is
        # an ARGUMENT, not a closure capture (a captured array would be
        # embedded in the program as a constant).
        d = Y_b[:, :, None] - Yt_d[None, None]          # (C, Je, Jt, F, N, 2)
        E = jnp.sum(jnp.abs(d) ** 2, axis=(3, 4, 5))
        R = jnp.sum(jnp.abs(Yt_d) ** 2, axis=(1, 2, 3))
        return E, R

    @jax.jit
    def stem_shares(Y_b):
        # per-run fraction of total separated energy in each stem (C, J):
        # a blind health statistic -- a buried source shows up as a
        # near-zero share (selection rules use the min share)
        p = jnp.sum(jnp.abs(Y_b) ** 2, axis=(2, 3, 4))   # (C, J)
        return p / jnp.maximum(p.sum(1, keepdims=True), 1e-20)

    @jax.jit
    def adjacent_agreement(Y_b):
        # cross-run agreement between ADJACENT runs in the chunk (c, c+1):
        # correlation matrices (C-1, Je, Je) of normalized log-power
        # planes. Consumed on host for same-candidate seed pairs only --
        # the cross-seed CONSISTENCY statistic (degenerate fits are
        # seed-sensitive; correct basins reproduce across spectral seeds).
        P = jnp.log1p(jnp.sum(jnp.abs(Y_b) ** 2, axis=4))  # (C, J, F, N)
        P = P.reshape(P.shape[:2] + (-1,))
        P = P - P.mean(-1, keepdims=True)
        P = P / jnp.maximum(
            jnp.linalg.norm(P, axis=-1, keepdims=True), 1e-12)
        return jnp.einsum('cjt,ckt->cjk', P[:-1], P[1:])

    from pyfasst_jax.models.spatial_init import (
        _band_coherence_stats, _min_band_coherence)
    envcorr_fn = jax.jit(jax.vmap(_max_env_corr))   # one wrapper: no
    coh_fn = jax.jit(jax.vmap(_min_band_coherence))
    cohstats_fn = jax.jit(jax.vmap(_band_coherence_stats))
    t0 = time.perf_counter()                        # per-chunk retrace
    lls_all, ec_all, coh_all, sh_all, E_all, Y_all = [], [], [], [], [], []
    cohj_all, prj_all = [], []
    agree_mats = {}                   # global run idx -> (J, J) corr with idx+1
    votes_all = []
    for lo in range(0, len(plist), chunk):
        sub = plist[lo:lo + chunk]
        valid = len(sub)
        while len(sub) < min(chunk, len(plist)):   # pad: one executable size
            sub = sub + [sub[0]]
        C = len(sub)
        params_b = batch_params(sub)
        X_b = jnp.broadcast_to(Xd, (C,) + Xd.shape)
        if align_at:
            mid = int(align_at * iters)
            params_b, lls1 = batched_run_gem(params_b, X_b, cfg, mesh,
                                             bounds=(0, mid))
            params_b = realign_mixing(params_b)
            params_b, lls2 = batched_run_gem(params_b, X_b, cfg, mesh,
                                             bounds=(mid, iters))
            lls = np.concatenate([np.asarray(lls1)[:, :mid],
                                  np.asarray(lls2)[:, mid:]], axis=1)
        else:
            params_b, lls = batched_run_gem(params_b, X_b, cfg, mesh)
            lls = np.asarray(lls)
        Y_b = sharded_batch_separate(params_b, X_b,
                                     jnp.broadcast_to(sigma1, (C,)
                                                      + sigma1.shape), mesh)
        ec = np.asarray(envcorr_fn(Y_b), np.float64)
        coh = np.asarray(coh_fn(Y_b), np.float64)
        cohj, prj = cohstats_fn(Y_b)
        sh = np.asarray(stem_shares(Y_b), np.float64)
        agree = np.asarray(adjacent_agreement(Y_b), np.float64)
        for i in range(valid - 1):
            agree_mats[lo + i] = agree[i]
        E, R = pair_errors(Y_b, Yt_d)
        lls_all.append(lls[:valid])
        ec_all.append(ec[:valid])
        coh_all.append(coh[:valid])
        cohj_all.append(np.asarray(cohj, np.float64)[:valid])
        prj_all.append(np.asarray(prj, np.float64)[:valid])
        sh_all.append(sh[:valid])
        E_all.append(np.asarray(E, np.float64)[:valid])
        if return_Y:
            Y_all.append(np.asarray(Y_b)[:valid] * scale)
        if return_votes:
            # per-run per-bin dominance labels: a (C, F, N) int8 fetch
            # (~1 MB/run) instead of the full separations
            lab_b = jnp.argmax(jnp.sum(jnp.abs(Y_b) ** 2, axis=4), axis=1)
            votes_all.append(np.asarray(lab_b, np.int8)[:valid])
    lls = np.concatenate(lls_all)
    ec = np.concatenate(ec_all)
    coh = np.concatenate(coh_all)
    cohj = np.concatenate(cohj_all)
    prj = np.concatenate(prj_all)
    sh = np.concatenate(sh_all)
    E = np.concatenate(E_all)
    R = np.asarray(R, np.float64)
    C = len(plist)
    wall = time.perf_counter() - t0

    recs = []
    for c in range(C):
        sdr = 10 * np.log10(np.maximum(R[None, :], 1e-12)
                            / np.maximum(E[c], 1e-12))
        best, bp = None, None
        for p in itertools.permutations(range(J)):
            tot = sum(sdr[p[j], j] for j in range(J))
            if best is None or tot > best:
                best, bp = tot, p
        per = [float(sdr[bp[j], j]) for j in range(J)]
        recs.append({
            "name": names[c],
            "final_ll": float(lls[c, -1]),
            "envcorr": round(float(ec[c]), 4),
            "band_coh": round(float(coh[c]), 4),
            "coh_j": [round(float(x), 4) for x in cohj[c]],
            "pr_j": [round(float(x), 4) for x in prj[c]],
            "min_share": round(float(sh[c].min()), 4),
            "shares": [round(float(x), 4) for x in sh[c]],
            "min_sdr_db": round(min(per), 2),
            "mean_sdr_db": round(float(np.mean(per)), 2),
            "per_src": [round(x, 2) for x in per],
        })
        if return_Y:
            recs[-1]["Y"] = np.concatenate(Y_all)[c]
        if return_votes:
            recs[-1]["votes_lab"] = np.concatenate(votes_all)[c]

    # cross-seed consistency: for adjacent runs of the SAME candidate,
    # best-permutation mean plane correlation (min over stems also kept:
    # one non-reproducing stem should not hide behind two stable ones)
    def _pair_stats(M):
        best = None
        for p in itertools.permutations(range(J)):
            v = [M[p[k], k] for k in range(J)]
            if best is None or sum(v) > sum(best):
                best = v
        return float(np.mean(best)), float(np.min(best))

    for c in range(C):
        vals = []
        for c0 in (c - 1, c):
            if c0 in agree_mats and names[c0].split("|")[0] \
                    == names[c0 + 1].split("|")[0]:
                vals.append(_pair_stats(agree_mats[c0]))
        if vals:
            vals.sort(reverse=True)
            recs[c]["consistency"] = round(vals[0][0], 4)
            recs[c]["consistency_min"] = round(vals[0][1], 4)
    return recs, wall


def realign_mixing(params_b, sweeps: int = 4):
    """Host-side per-frequency permutation re-alignment (Duong-style).

    Full-rank/conv models estimate R_j(f) independently per frequency; an
    imperfect init can leave BANDS where the source identities are swapped
    relative to the rest of the spectrum (the classic per-frequency
    permutation problem). Mid-EM repair: for each run, correlate each
    source's per-frequency log activity envelope (model PSD v_j(f, :))
    with its global (frequency-pooled) envelope, and permute the mixing
    planes A_j(f) -- and the FB rows, which carry the band energy -- to
    the best assignment per frequency, iterating a few sweeps. The
    remaining EM iterations re-learn the spectral detail under the
    repaired spatial identities.
    """
    import dataclasses

    import jax.numpy as jnp

    from pyfasst_jax.models.spatial_init import _best_assignment, _normrows
    import jax.numpy as jnp

    J = len(params_b.spat)
    # np.array copies: device fetches give read-only views, and the loop
    # below writes rows in place
    A = [np.array(np.asarray(c.A)) for c in params_b.spat]  # (C,F,2,R)
    FB = [np.array(c.FB) for c in params_b.spec]          # (C, F, K)
    TW = [np.array(c.TW) for c in params_b.spec]          # (C, K, N)
    C, F = FB[0].shape[:2]
    fidx = np.arange(F)[None, :]
    for c in range(C):
        Astk = np.stack([A[j][c] for j in range(J)])      # (J, F, 2, R)
        FBstk = np.stack([FB[j][c] for j in range(J)])    # (J, F, K)
        act = np.stack([FB[j][c] @ TW[j][c] for j in range(J)])  # (J, F, N)
        An = _normrows(np.log1p(
            act / np.maximum(act.mean(-1, keepdims=True), 1e-20)))
        Afn = np.transpose(An, (1, 0, 2))                 # (F, J, N)
        g = Afn.mean(0)                                   # (J, N)
        for _ in range(sweeps):
            gn = _normrows(g)
            S = np.einsum('fjn,kn->fjk', Afn, gn)         # (F, J, J)
            sel = _best_assignment(S)                     # (F, J)
            if np.all(sel == np.arange(J)[None, :]):
                break
            Afn = np.take_along_axis(Afn, sel[:, :, None], axis=1)
            Astk = Astk[sel.T, fidx]                      # (J, F, 2, R)
            FBstk = FBstk[sel.T, fidx]
            g = Afn.mean(0)
        for j in range(J):
            A[j][c] = Astk[j]
            FB[j][c] = FBstk[j]
    spat = tuple(dataclasses.replace(
        comp, A=jnp.asarray(np.ascontiguousarray(A[j])))
        for j, comp in enumerate(params_b.spat))
    spec = tuple(dataclasses.replace(
        comp, FB=jnp.asarray(FB[j], comp.FB.dtype))
        for j, comp in enumerate(params_b.spec))
    return dataclasses.replace(params_b, spat=spat, spec=spec)


def summarize(draw: int, recs, env_thr: float = 0.6):
    from pyfasst_jax.models.reverb import selection_key

    mins = np.array([r["min_sdr_db"] for r in recs])
    lls = np.array([r["final_ll"] for r in recs])
    ecs = np.array([r["envcorr"] for r in recs])
    oracle = int(np.argmax(mins))
    ok = ecs <= env_thr
    if ok.any():
        blind = int(np.argmax(np.where(ok, lls, -np.inf)))
    else:
        blind = int(np.argmin(ecs))
    prod = min(range(len(recs)), key=lambda i: selection_key(recs[i]))
    out_extra = {}
    cons = [r.get("consistency") for r in recs]
    if any(c is not None for c in cons):
        # candidate selector: max cross-seed consistency among unvetoed
        # tier-0 runs (veto = the production envcorr/share rule)
        def veto(r):
            return selection_key(r)[0] or selection_key(r)[1] > 0
        idxs = [i for i, r in enumerate(recs)
                if cons[i] is not None and not veto(recs[i])]
        if not idxs:
            idxs = [i for i in range(len(recs)) if cons[i] is not None]
        ci = max(idxs, key=lambda i: cons[i])
        out_extra["consistency_pick"] = {
            "name": recs[ci]["name"], "min_sdr": recs[ci]["min_sdr_db"],
            "consistency": cons[ci],
            "consistency_min": recs[ci].get("consistency_min")}
    return {
        "draw": draw, "pool": len(recs), **out_extra,
        "oracle": {"name": recs[oracle]["name"],
                   "min_sdr": recs[oracle]["min_sdr_db"],
                   "mean_sdr": recs[oracle]["mean_sdr_db"]},
        "blind_ll_veto": {"name": recs[blind]["name"],
                          "min_sdr": recs[blind]["min_sdr_db"],
                          "envcorr": recs[blind]["envcorr"],
                          "survivors": int(ok.sum())},
        "selection_key": {"name": recs[prod]["name"],
                          "min_sdr": recs[prod]["min_sdr_db"],
                          "envcorr": recs[prod]["envcorr"],
                          "min_share": recs[prod].get("min_share")},
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--draws", type=int, nargs="+",
                    default=[102, 103, 104, 105, 106])
    ap.add_argument("--iters", type=int, default=400)
    ap.add_argument("--em-seeds", type=int, default=2)
    ap.add_argument("--align-at", type=float, default=None)
    ap.add_argument("--dump", default=None,
                    help="JSONL path for per-run records")
    args = ap.parse_args()

    dump = open(args.dump, "a") if args.dump else None
    for draw in args.draws:
        X, Yt, ys_true, mix, tft, n = make_fixture(draw)
        t0 = time.perf_counter()
        cands, pw, xx = candidate_pool(X, J=4)
        t_pool = time.perf_counter() - t0
        recs, wall = run_pool(X, cands, pw, xx, Yt, args.iters,
                              args.em_seeds, align_at=args.align_at)
        for r in recs:
            r["draw"] = draw
            if dump:
                dump.write(json.dumps(r) + "\n")
        if dump:
            dump.flush()
        s = summarize(draw, recs)
        s["pool_wall_s"] = round(t_pool, 1)
        s["em_wall_s"] = round(wall, 1)
        print(json.dumps(s), flush=True)
    if dump:
        dump.close()


if __name__ == "__main__":
    main()
