"""Blind reverberant full-rank separation pipeline (configs[2]).

The reference pyfasst has no counterpart (its DEMIX init is anechoic --
pyfasst/demixTF.py, UNVERIFIED, mount empty; SURVEY.md §3.4): under late
reverberation the blind init is the whole quality gap (round-1 diagnosis:
oracle spatial init reaches ~13.5 dB min SDR where blind DEMIX got 0.3 dB).
This module is the measured end-to-end recipe, Duong/Sawada lineage
(full-rank spatial covariance EM + permutation alignment) rebuilt for batched
device programs:

1. Consensus spatial-clustering votes with SPECTRAL permutation alignment
   (models/spatial_init.py) plus structural repair hypotheses: merge/split
   candidates, direction-first splits, and a soft re-alignment pass
   (`realign_votes`) -- each candidate is a different resolution of the
   blind ambiguities, and no heuristic picks among them.
2. Every (candidate, EM seed) runs FULL-length GEM in chunked BATCHED
   device programs (the same executable as the configs[4] batched path);
   only scalar statistics cross the host boundary per run.
3. Blind selection by degeneracy statistics measured at convergence:
   runs whose separation contains a duplicated source (stem-envelope
   correlation) or a vanished source (minimum stem energy share) are
   ranked out; the final log-likelihood only breaks ties. Measured on the
   configs[2] family: the likelihood ALONE is actively misleading --
   burying a weak source is cheap, so degenerate fits out-score correct
   ones (draw 102: max-ll picks -0.1 dB with +4.1 dB in the pool).
4. EM-IN-THE-LOOP RESEEDING: the winner's separation yields per-bin
   dominance votes -> a fresh init -> another full EM; accepted only if
   the selection rule improves. Measured: one round adds +1..+2.4 dB on
   4 of 5 draws and the rule's veto stops the occasional collapse a
   second round can cause.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = ["blind_reverb_separate", "blind_reverb_separate_multiscale",
           "selection_key"]


def selection_key(rec: dict, env_thr: float = 0.6,
                  share_floor: float = 0.02, select: str = "envcorr"):
    """Total order over run records; smaller is better.

    Components, in order:
    1. veto flag: stem-envelope correlation above `env_thr` OR a stem
       holding less than `share_floor` of the separated energy -- both
       blind degeneracy signals.
    2. candidate TIER: 0 for clustering-derived candidates (raw,
       merge/split, soft-realign, reseeds), 1 for direction-first NMF
       splits. Measured over 10 configs[2] draws at full convergence:
       within tier 0 the envelope correlation is a near-perfect selector
       (median pick 6.97 dB vs tier-0 oracle 7.58, identical worst), but
       tier-1 runs systematically GAME it -- their NMF-split inits
       converge to frequency-interleaved stems whose time envelopes
       decorrelate beautifully (pool-lowest envcorr at ~2 dB true SDR),
       and their own family oracle (median 4.88) almost never beats tier
       0 (once, by 0.12 dB). So tier-1 competes only when every tier-0
       run is vetoed -- the regime it was built for (same-direction
       mixtures where no clustering split isolates the sources).
    3. select == "envcorr": the envelope correlation itself.
       select == "consistency": cross-seed consistency, DESCENDING --
       best-permutation mean correlation of the converged separation
       planes across the candidate's spectral EM seeds. Raw consistency
       was measured and rejected round 3 (stable-but-wrong merge/split
       basins reproduce deterministically; design.md §6e) but applied
       AFTER the veto tier it picks the pool oracle on all measured
       family-1 gate draws and beats the envcorr order by 2-5 dB on
       speech; on beat-locked music it stays worse. It is the DEFAULT
       of the flat pipeline ONLY at its measured operating point
       (blind_reverb_separate resolves select=None to consistency when
       em_seeds >= 2 AND band-EM candidates are in the pool; the bare
       pool keeps envcorr -- the round-5 gate re-run measured bare
       consistency collapsing draw 102 to 0.31 dB) while the multiscale
       ladder -- the music entry point -- resolves to envcorr
       (design.md §6g). Runs without the statistic (single EM seed)
       rank after any run that has it.
    4. envelope correlation (under "consistency": the next tiebreak).
    5. final log-likelihood, descending (tiebreak only -- measured
       actively misleading as a primary criterion, see module docstring).
    """
    vetoed = rec["envcorr"] > env_thr or rec["min_share"] < share_floor
    tier = rec.get("tier", 1 if rec["name"].startswith("dirs") else 0)
    if select == "consistency":
        return (vetoed, tier, -rec.get("consistency", -1.0),
                rec["envcorr"], -rec["final_ll"])
    if select == "learned":
        # power-weighted best-permutation agreement of the run's converged
        # stem-dominance plane with the learned per-bin votes
        # (models/binfeat), DESCENDING; runs without the statistic rank
        # after any run that has it. Round-5 judge for the speech-regime
        # selection gap (design.md par-6g: the pool holds 2-5 dB the
        # envcorr/consistency keys cannot see).
        return (vetoed, tier, -rec.get("learned", -1.0),
                rec["envcorr"], -rec["final_ll"])
    return (vetoed, tier, rec["envcorr"], -rec["final_ll"])


def _hard_votes_from_sep(Y, J: int) -> np.ndarray:
    """Per-bin dominance votes (F, N, J) from a separated-spectra device
    array (J, F, N, I): one-hot argmax of per-source bin power. The
    argmax runs on device; only the (F, N) int plane is fetched."""
    import jax.numpy as jnp

    lab = np.asarray(jnp.argmax(jnp.sum(jnp.abs(Y) ** 2, axis=3), axis=0))
    return np.eye(J)[lab]


def _run_candidates(X_d, cands, pw, xx, Yref, cfg, mesh, sigma1,
                    em_seeds: int, nmf_comps: int, rank: int,
                    chunk: int, bests=None, env_thr: float = 0.6,
                    share_floor: float = 0.02, verbose: bool = False,
                    topk: int = 1, tiers=None, distinct: bool = False,
                    select: str = "envcorr", judge_votes=None):
    """Run every (candidate, seed) full-rank EM; return (records, bests).

    `bests` carries the running top-`topk` runs across calls (sorted by
    `selection_key`, best first), each a dict holding the device
    params/in-chunk separation -- buffers of non-kept runs are dropped as
    soon as the chunk is scored. `tiers`, if given, maps candidate names
    to explicit selection tiers (rec['tier'], consumed by selection_key;
    the multiscale ladder uses the FINE-stage rank as the coarse tier).

    select == "consistency" additionally computes each candidate's
    cross-seed consistency (best-permutation mean correlation of the
    normalized log-power separation planes between the candidate's
    adjacent spectral-seed runs, which share a chunk because chunk sizes
    are padded to a multiple of em_seeds) and orders survivors by it
    (selection_key(select="consistency"))."""
    import jax
    import jax.numpy as jnp

    from pyfasst_jax.models.components import (
        CONV, FasstParams, SpatialComp, init_nmf_comp,
    )
    from pyfasst_jax.models.spatial_init import (
        _max_env_corr, _min_band_coherence, activity_profiles,
        apply_profiles, mixing_from_votes,
    )
    from pyfasst_jax.parallel.sharding import (
        batch_params, batched_run_gem, sharded_batch_separate,
    )
    import jax.numpy as jnp

    J = cands[0][1].shape[-1]
    F, N = pw.shape
    names, plist = [], []
    for name, v in cands:
        A = mixing_from_votes(v, xx, pw, rank=rank)
        twp, fbp = activity_profiles(v, pw)
        for s in range(em_seeds):
            keys = list(jax.random.split(jax.random.PRNGKey(s), J))
            spat = tuple(SpatialComp(A=jnp.asarray(A[j]),
                                     mix_type=CONV) for j in range(J))
            spec = tuple(init_nmf_comp(keys[j], F, N, nmf_comps,
                                       spat_ind=j) for j in range(J))
            plist.append(apply_profiles(FasstParams(spat=spat, spec=spec),
                                        twp, fbp))
            names.append(f"{name}|s{s}")

    envcorr_fn = jax.jit(jax.vmap(_max_env_corr))
    coh_fn = jax.jit(jax.vmap(_min_band_coherence))

    judge_fn = None
    if judge_votes is not None:
        jv_d = jnp.asarray(np.asarray(judge_votes, np.float32))
        pw_d = jnp.asarray(np.asarray(pw, np.float32))

        @jax.jit
        def judge_fn(Y_b):
            # (C, J_votes, J_runs) power-weighted confusion between the
            # learned vote plane and each run's stem-dominance argmax;
            # best-permutation trace resolved on host. Precision pinned:
            # the einsum feeds a selection decision (TF32 would flip it).
            with jax.default_matmul_precision("highest"):
                P = jnp.sum(jnp.abs(Y_b) ** 2, axis=4)      # (C, J, F, N)
                oh = jax.nn.one_hot(jnp.argmax(P, axis=1), P.shape[1],
                                    dtype=jnp.float32)      # (C, F, N, J)
                return jnp.einsum('fnj,cfnk,fn->cjk', jv_d, oh, pw_d)

    @jax.jit
    def shares_fn(Y_b):
        p = jnp.sum(jnp.abs(Y_b) ** 2, axis=(2, 3, 4))
        return p / jnp.maximum(p.sum(1, keepdims=True), 1e-20)

    @jax.jit
    @jax.default_matmul_precision("highest")
    def agree_fn(Y_b):
        # (C-1, J, J) correlation of normalized log-power planes between
        # ADJACENT runs -- consumed on host for same-candidate seed pairs
        # only (the cross-seed consistency statistic, design.md §6g). The
        # correlation is a matmul that feeds a selection: pinned, as TF32
        # would round it to ~3 digits.
        P = jnp.log1p(jnp.sum(jnp.abs(Y_b) ** 2, axis=4))   # (C, J, F, N)
        P = P.reshape(P.shape[:2] + (-1,))
        P = P - P.mean(-1, keepdims=True)
        P = P / jnp.maximum(
            jnp.linalg.norm(P, axis=-1, keepdims=True), 1e-12)
        return jnp.einsum('cjt,ckt->cjk', P[:-1], P[1:])

    def _best_perm_mean(M):
        import itertools
        best = None
        for p in itertools.permutations(range(J)):
            v = sum(M[p[k], k] for k in range(J))
            if best is None or v > best:
                best = v
        return float(best) / J

    key_fn = lambda r: selection_key(r, env_thr, share_floor, select)
    records = []
    bests = list(bests or [])
    # one executable size across chunks, rounded up to a multiple of the
    # mesh's dp axis (the pool is embarrassingly DP over (candidate, seed)
    # runs; padded slots repeat sub[0] and are dropped after scoring)
    dp = mesh.shape.get("dp", 1)
    if select == "consistency" and em_seeds > 1:
        # seed pairs must share a chunk for the cross-seed statistic
        chunk = max(em_seeds, chunk - chunk % em_seeds)
    csize = min(chunk, len(plist))
    csize = ((csize + dp - 1) // dp) * dp
    for lo in range(0, len(plist), chunk):
        sub = plist[lo:lo + chunk]
        valid = len(sub)
        while len(sub) < csize:                    # pad: one executable size
            sub = sub + [sub[0]]
        C = len(sub)
        params_b = batch_params(sub)
        X_b = jnp.broadcast_to(X_d, (C,) + X_d.shape)
        params_b, lls = batched_run_gem(params_b, X_b, cfg, mesh)
        Y_b = sharded_batch_separate(
            params_b, X_b, jnp.broadcast_to(sigma1, (C,) + sigma1.shape),
            mesh)
        ec = np.asarray(envcorr_fn(Y_b), np.float64)
        coh = np.asarray(coh_fn(Y_b), np.float64)
        sh = np.asarray(shares_fn(Y_b), np.float64)
        ll = np.asarray(lls[:, -1], np.float64)
        jconf = np.asarray(judge_fn(Y_b), np.float64) \
            if judge_fn is not None else None
        chunk_recs = []
        for i in range(valid):
            rec = {"name": names[lo + i], "final_ll": float(ll[i]),
                   "envcorr": round(float(ec[i]), 4),
                   "band_coh": round(float(coh[i]), 4),
                   "min_share": round(float(sh[i].min()), 4)}
            if jconf is not None:
                rec["learned"] = round(
                    _best_perm_mean(jconf[i]) * J / max(pw.sum(), 1e-20),
                    4)
            if tiers is not None:
                cname = rec["name"].split("|")[0]
                if cname in tiers:
                    rec["tier"] = tiers[cname]
            chunk_recs.append(rec)
        if select == "consistency" and valid > 1:
            agree = np.asarray(agree_fn(Y_b), np.float64)
            for i in range(valid - 1):
                if names[lo + i].split("|")[0] \
                        != names[lo + i + 1].split("|")[0]:
                    continue
                c = round(_best_perm_mean(agree[i]), 4)
                for r in (chunk_recs[i], chunk_recs[i + 1]):
                    r["consistency"] = max(r.get("consistency", -1.0), c)
        for i, rec in enumerate(chunk_recs):
            records.append(rec)
            key = key_fn(rec)
            if verbose:
                cons = rec.get("consistency")
                print(f"reverb: {rec['name']}: ll {rec['final_ll']:.1f} "
                      f"envcorr {rec['envcorr']:.3f} min_share "
                      f"{rec['min_share']:.3f}"
                      + (f" consistency {cons:.3f}"
                         if cons is not None else "")
                      + ("  [vetoed]" if key[0] else ""))
            if distinct:
                # at most one kept run per CANDIDATE (topk > 1 is used to
                # ladder diverse hypotheses, not spectral-seed twins)
                cname = rec["name"].split("|")[0]
                same = [b for b in bests
                        if b["name"].split("|")[0] == cname]
                if same:
                    if key >= key_fn(same[0]):
                        continue
                    bests.remove(same[0])
            if len(bests) < topk or key < key_fn(bests[-1]):
                kept = dict(rec)
                kept["Y"] = Y_b[i]
                kept["params"] = jax.tree.map(lambda x: x[i], params_b)
                bests.append(kept)
                bests.sort(key=key_fn)
                del bests[topk:]
    return records, bests


def blind_reverb_separate(
        X: np.ndarray, J: int, *, iters: int = 400, em_seeds: int = 2,
        reseed_rounds: int = 2, nmf_comps: int = 6, rank: int = 2,
        chunk: int = 24, spatial_hold_frac: float = 0.3,
        env_thr: float = 0.6, share_floor: float = 0.02,
        n_seeds: int = 8, verbose: bool = False, topk: int = 1,
        env_transform: Optional[str] = None,
        realign_reseeds: bool = False, n_devices: int = 1,
        band_em: Optional[int] = None, noalign: bool = False,
        select: Optional[str] = None, reseed_select: Optional[str] = None,
        keep_pool_sep: bool = False, learned: bool = False,
        learned_params=None,
) -> Tuple[np.ndarray, dict]:
    """Blind separation of a reverberant mixture STFT.

    X (F, N, I) complex; returns (Y (J, F, N, I) complex separated source
    images on host, info dict: winning candidate name, per-stage records,
    blind statistics of the winner).

    See module docstring for the recipe. All EM runs are batched device
    programs; the pool costs ~(n_candidates * em_seeds / chunk + 1) chunk
    executions of the configs[4] executable plus `reseed_rounds` singles.

    n_devices shards the pool over a device mesh (the pool is the most
    expensive workload in the library and is embarrassingly DP across
    (candidate, seed) runs; chunks pad to a multiple of the mesh's dp
    axis). Selection is device-count invariant: every run's statistics
    are scored on host through the same selection_key.

    env_transform selects the node-envelope transform of the permutation
    alignment (spatial_init._ENV_TRANSFORM): None keeps the module
    default (log1p -- best on smooth/sustained sources, every configs[2]
    number); 'rank' (Spearman envelopes) measured better INIT alignment
    on sparse switching material (speech syllables, beat-locked stems)
    but end-to-end either transform can win a given draw (basin entry is
    chaotic); 'both' builds the candidate pool under BOTH transforms and
    lets the at-convergence selection pick per draw -- roughly double
    pool cost. See tools/env_transform_lab.py and docs/design.md.

    band_em (band width in bins, e.g. 32) adds a `bandem` candidate to
    the pool: per-bin votes pooled from band-local full-EM probes
    (spatial_init.band_em_votes) -- the round-4 per-bin feature family
    measured to raise fine-grid vote accuracy where the covariance
    features saturate (music consensus 0.56 -> ~0.63, speech
    0.62 -> 0.87 on one draw; docs/design.md §6g). noalign adds a
    `noalign` candidate: consensus votes that SKIP the spectral
    permutation alignment, measured better on the image-method family
    where the envelope graph is too noisy to align (§6f). Both extend
    the pool; the tiered at-convergence selection arbitrates.

    select (None | "envcorr" | "consistency" | "learned") picks the
    within-tier ordering of unvetoed runs (selection_key).
    "consistency" orders by cross-seed reproducibility of the converged
    separation (needs em_seeds >= 2) and is the measured better rule on
    speech-like material and the family-1 reverb regime AT ITS MEASURED
    OPERATING POINT -- with band-EM candidates in the pool (configs[2]
    gate 8.02/8.73/11.44 vs envcorr's 6.64/8.47/11.14, design.md §6g).
    On the BARE pool the round-5 gate re-run measured it collapsing
    draw 102 to 0.31 dB (a degenerate merge/split candidate reproduces
    across seeds), so None (the default) resolves to "consistency" only
    when em_seeds >= 2 AND band_em is set, and to "envcorr" otherwise.
    "envcorr" is the measured better rule on beat-locked music, where
    degenerate basins are MORE seed-stable than correct ones -- the
    multiscale ladder (the music entry point) resolves its own None to
    "envcorr".

    reseed_select (None | "envcorr") guards RESEED acceptance under a
    different key than the pool selection. A reseed is a warm restart
    from the winner's own votes, so its spectral seeds converge
    near-identically and its cross-seed consistency is structurally
    inflated (~1); under select="consistency" reseeds therefore always
    out-rank the pool, and on material where a reseed can collapse
    (speech 121/122: 1.43 -> -0.22, 0.74 -> -0.38 dB) the acceptance is
    too eager. reseed_select="envcorr" accepts a reseed only when it
    improves the envelope-correlation key (the round-3 guarded rule,
    immune to the inflation). None keeps acceptance under `select`
    (measured the better choice on the configs[2] family, where
    consistency-accepted reseeds exceed even the pool-oracle ceiling).

    keep_pool_sep=True additionally returns the POOL-stage winner's
    separation in info["pool_Y"] (host) / info["pool_picked"], for labs
    that score stages independently.

    learned=True adds a `learned` candidate to the pool: the per-bin
    vote plane of the trained deep-clustering embedding
    (models/binfeat.learned_votes; weights from
    pyfasst_jax/data/binfeat.npz or `learned_params`). Globally aligned
    by construction -- the per-frequency permutation step every
    hand-crafted family loses accuracy to never arises.
    select="learned" (also valid for reseed_select) instead/additionally
    uses the learned votes as the pool JUDGE: runs are ordered by the
    power-weighted best-permutation agreement between their converged
    stem-dominance planes and the learned votes (rec["learned"]).
    """
    from pyfasst_jax.models.spatial_init import (
        band_em_votes, candidate_votes, consensus_votes,
        direction_split_candidates, realign_votes, tf_covariance_features,
    )

    if select is None:
        # auto rule, gate-measured (round 5): consistency's §6g win over
        # envcorr was measured WITH band-EM candidates in the pool (the
        # preset operating point). On the BARE pool it collapses gate
        # draw 102 to 0.31 dB (vs envcorr's 6.64 worst) -- a degenerate
        # merge/split candidate reproduces across seeds -- while with
        # band_em the same rule measures 8.02/8.73/11.44. So consistency
        # is the default only in the regime it was measured in.
        select = "consistency" if (em_seeds >= 2 and band_em is not None) \
            else "envcorr"
    lv = None
    if learned or select == "learned" or reseed_select == "learned":
        # learned per-bin votes (models/binfeat): one embedding call plus
        # a global spherical k-means -- used as a pool CANDIDATE
        # (learned=True) and/or the selection JUDGE (select="learned")
        from pyfasst_jax.models.binfeat import learned_votes

        lv = learned_votes(X, J, params=learned_params)
    feat, w, pw, xx = tf_covariance_features(X)
    transforms = [env_transform] if env_transform != "both" \
        else ["log1p", "rank"]
    cands = []
    votes0 = None
    for ti, tr in enumerate(transforms):
        votes = consensus_votes(X, J, n_seeds=n_seeds, env_transform=tr)
        if ti == 0:
            votes0 = votes
        pre = "" if ti == 0 else f"{tr}:"
        cands += [(pre + name, v) for name, v in candidate_votes(votes, pw)]
        cands.append((pre + "realign",
                      realign_votes(votes, pw, J, env_transform=tr)))
    if noalign:
        cands.append(("noalign",
                      consensus_votes(X, J, n_seeds=n_seeds, align="none")))
    if band_em:
        tr0 = None if env_transform == "both" else env_transform
        bv = band_em_votes(
            X, J, band_width=int(band_em), votes_init=votes0,
            n_seeds=n_seeds, env_transform=tr0, band_align="both",
            n_devices=n_devices, verbose=verbose)
        # two candidates from the SAME band probes: envelope-reclustered
        # (can fix global init errors) and init-anchored (immune to
        # envelope noise); selection arbitrates (design.md §6g)
        cands.append(("bandem", bv["envelope"]))
        cands.append(("bandem-a", bv["init"]))
    if learned:
        cands.append(("learned", lv))
    if J > 2:
        cands += direction_split_candidates(X, J, pw, n_seeds=n_seeds)

    return _pool_and_reseed(
        X, cands, J, iters=iters, em_seeds=em_seeds,
        reseed_rounds=reseed_rounds, nmf_comps=nmf_comps, rank=rank,
        chunk=chunk, spatial_hold_frac=spatial_hold_frac, env_thr=env_thr,
        share_floor=share_floor, verbose=verbose, topk=topk,
        env_transform=env_transform, realign_reseeds=realign_reseeds,
        n_devices=n_devices, select=select, reseed_select=reseed_select,
        keep_pool_sep=keep_pool_sep,
        judge_votes=lv if (select == "learned"
                           or reseed_select == "learned") else None)


def _pool_and_reseed(X, cands, J, *, iters, em_seeds, reseed_rounds,
                     nmf_comps, rank, chunk, spatial_hold_frac, env_thr,
                     share_floor, verbose, topk: int = 1, tiers=None,
                     env_transform: Optional[str] = None,
                     realign_reseeds: bool = False, n_devices: int = 1,
                     select: str = "envcorr",
                     reseed_select: Optional[str] = None,
                     keep_pool_sep: bool = False, judge_votes=None):
    """Run a candidate pool to convergence, select by `selection_key`,
    apply guarded EM reseeding; shared by the single-grid pipeline and
    the multiscale ladder's stages. topk > 1 keeps the best run of each
    of the top-k CANDIDATES alive (info['tops'] carries their device
    separations for the ladder); reseeding always restarts from the
    overall winner.

    reseed_select (see blind_reverb_separate): when set and different
    from `select`, reseed rounds are scored in a SEPARATE pool and
    accepted only if they improve the `reseed_select` key over the
    current best — immunizing acceptance against the structurally
    inflated cross-seed consistency of warm restarts. An accepted
    reseed takes the winner slot (and tops[0] when topk > 1).

    realign_reseeds adds a second hypothesis per reseed round: the
    winner's dominance votes re-passed through the spectral permutation
    alignment (realign_votes). EM converges WITH whatever global
    permutation errors its init had -- a band locked onto the wrong
    source is a local optimum the likelihood cannot leave -- so the
    realigned reseed is the only stage that can still repair them; the
    guarded selection vetoes it when the re-alignment hurts instead."""
    from pyfasst_jax.models.spatial_init import tf_covariance_features
    from pyfasst_jax.ops.gem import annealing_endpoints
    from pyfasst_jax.parallel.sharding import make_mesh
    from pyfasst_jax.utils.config import GEMConfig
    import jax.numpy as jnp

    feat, w, pw, xx = tf_covariance_features(X)
    scale = float(np.sqrt(np.mean(np.abs(X) ** 2)))
    X_d = jnp.asarray(np.ascontiguousarray(X)) / scale
    cfg = GEMConfig(niter=iters, spatial_hold_frac=spatial_hold_frac)
    mesh = make_mesh(n_devices)
    _, sigma1 = annealing_endpoints(X_d, cfg)

    records, bests = _run_candidates(
        X_d, cands, pw, xx, None, cfg, mesh, sigma1, em_seeds, nmf_comps,
        rank, chunk, env_thr=env_thr, share_floor=share_floor,
        verbose=verbose, topk=topk, tiers=tiers, distinct=topk > 1,
        select=select, judge_votes=judge_votes)
    best = bests[0]
    history = [{"stage": "pool", "picked": best["name"],
                "envcorr": best["envcorr"], "min_share": best["min_share"],
                "pool": len(records)}]
    pool_stage = None
    if keep_pool_sep:
        pool_stage = {"name": best["name"],
                      "Y": np.asarray(best["Y"]) * scale}

    guarded = reseed_select is not None and reseed_select != select
    for r in range(reseed_rounds):
        rs = _hard_votes_from_sep(best["Y"], J)
        prev_name = best["name"]
        cands_r = [(f"reseed{r + 1}", rs)]
        if realign_reseeds:
            from pyfasst_jax.models.spatial_init import realign_votes
            # under 'both' the reseed realign keeps the module default
            tr = None if env_transform == "both" else env_transform
            cands_r.append((f"reseed{r + 1}r",
                            realign_votes(rs, pw, J, env_transform=tr)))
            if tiers is not None:
                tiers.setdefault(f"reseed{r + 1}r", 0)
        if guarded:
            # reseeds compete in their own pool under the guard key,
            # then must BEAT the current best on that key to be kept
            recs_r, bests_r = _run_candidates(
                X_d, cands_r, pw, xx, None, cfg, mesh,
                sigma1, em_seeds, nmf_comps, rank, chunk, bests=None,
                env_thr=env_thr, share_floor=share_floor, verbose=verbose,
                topk=1, tiers=tiers, select=reseed_select,
                judge_votes=judge_votes)
            gkey = lambda rec: selection_key(rec, env_thr, share_floor,
                                             reseed_select)
            cand_r = bests_r[0]
            accepted = gkey(cand_r) < gkey(best)
            if accepted:
                best = cand_r
                bests = [cand_r] + [b for b in bests
                                    if b is not cand_r][:max(topk - 1, 0)]
            history.append({"stage": f"reseed{r + 1}",
                            "picked": best["name"],
                            "candidate": cand_r["name"],
                            "accepted": accepted,
                            "envcorr": best["envcorr"],
                            "min_share": best["min_share"]})
            if not accepted:               # guard key did not improve
                break
            continue
        recs_r, bests = _run_candidates(
            X_d, cands_r, pw, xx, None, cfg, mesh,
            sigma1, em_seeds, nmf_comps, rank, chunk, bests=bests,
            env_thr=env_thr, share_floor=share_floor, verbose=verbose,
            topk=topk, tiers=tiers, distinct=topk > 1, select=select,
            judge_votes=judge_votes)
        best = bests[0]
        history.append({"stage": f"reseed{r + 1}", "picked": best["name"],
                        "envcorr": best["envcorr"],
                        "min_share": best["min_share"]})
        if best["name"] == prev_name:      # rule did not improve: stop
            break

    Y = np.asarray(best["Y"]) * scale
    info = {"picked": best["name"], "envcorr": best["envcorr"],
            "min_share": best["min_share"], "final_ll": best["final_ll"],
            "select": select, "history": history, "params": best["params"]}
    if "consistency" in best:
        info["consistency"] = best["consistency"]
    if pool_stage is not None:
        info["pool_picked"] = pool_stage["name"]
        info["pool_Y"] = pool_stage["Y"]
    if topk > 1:
        info["tops"] = bests
    return Y, info


def blind_reverb_separate_multiscale(
        x: np.ndarray, J: int, *, fs: int, wlen_fine: int = 2048,
        wlen_coarse: int = 8192, iters: int = 400, em_seeds: int = 2,
        reseed_rounds: int = 2, nmf_comps: int = 6, rank: int = 2,
        chunk: int = 24, spatial_hold_frac: float = 0.3,
        env_thr: float = 0.6, share_floor: float = 0.02,
        n_seeds: int = 8, verbose: bool = False, topk: int = 3,
        transform_fine=None, transform_coarse=None,
        env_transform: Optional[str] = None,
        realign_reseeds: bool = False, n_devices: int = 1,
        band_em: Optional[int] = None, noalign: bool = False,
        select: Optional[str] = None, reseed_select: Optional[str] = None,
        learned: bool = False, learned_params=None,
) -> Tuple[np.ndarray, dict]:
    """Multiscale blind separation for material whose permutation-alignment
    evidence lives at a finer time scale than the best model grid.

    select=None resolves to "envcorr" here (NOT blind_reverb_separate's
    consistency default): the ladder's regime is beat-locked music,
    where cross-seed consistency is the measured WORSE rule -- stable
    degenerate basins reproduce across seeds (design.md §6g).

    Measured motivation (tools/ladder_lab.py, music 3-stem T60=0.12 s,
    44.1 kHz): the envelope-correlation alignment signal is DEAD at
    >= 93 ms analysis windows (scrambled-oracle recovery 0.45-0.47, i.e.
    chance) yet alive at 46 ms (0.75) -- window smearing erases the
    distinguishing envelope detail of beat-locked stems -- while the EM's
    own quality ceiling runs the other way (oracle-init min SDR 13.1 dB at
    wlen 8192 vs 7.1 at 2048: long windows fit the reverberant narrowband
    model better). No single grid gets both. Cross-grid alignment signals
    fail too: hop-oversampled coarse envelopes 0.47, band-projected fine
    envelopes 0.51, spatial centroids ~0.52 (reverberant signatures
    decorrelate within ~2 bins at 0 dB direct-to-reverb).

    The LADDER transports alignment information through the model itself:

    1. full blind pipeline (pool + tiered selection + guarded reseeds) on
       the FINE grid, where envelope alignment works;
    2. the winning separation's time-domain images re-analyzed on the
       COARSE grid -> per-bin dominance votes (measured: vote accuracy
       rises 0.56 -> 0.71 through rung 1's EM + remap, because the EM
       cleans LOCAL errors while the fine grid's alignment fixed the
       GLOBAL permutation structure the coarse grid cannot see);
    3. coarse-grid EM from those votes (em_seeds spectral restarts,
       log-likelihood tiebreak within the single candidate), plus the
       same guarded reseed rounds (accepted only when `selection_key`
       improves -- unguarded coarse reseeds plateau: 2.0 -> 2.3 dB,
       then dip).

    Measured end-to-end on the music 3-stem fixture: min SDR ~0 dB
    (single-grid pipeline at either wlen) -> 2.0-2.3 dB blind; the rung
    ceilings are 5.3 (perfect fine alignment) and 8.1 dB (perfect coarse
    alignment of real clusters), so the residual gap remains alignment
    quality at the fine grid, not EM capacity.

    x: time-domain mixture (nsamples, I); returns (Y (J, F_coarse,
    N_coarse, I), info) with info["fine"] holding the fine-stage info and
    info["transform"] the coarse STFT for inversion.
    """
    from pyfasst_jax.tf.stft import STFT

    if select is None:
        select = "envcorr"
    x = np.asarray(x)
    if x.ndim != 2:
        raise ValueError("x must be (nsamples, I) time-domain audio")
    n = x.shape[0]
    tft_f = transform_fine or STFT(wlen=wlen_fine, fs=fs)
    tft_c = transform_coarse or STFT(wlen=wlen_coarse, fs=fs)
    XF = np.asarray(tft_f.computeTransform(x.astype(np.float32)))

    YF, info_f = blind_reverb_separate(
        XF, J, iters=iters, em_seeds=em_seeds, reseed_rounds=reseed_rounds,
        nmf_comps=nmf_comps, rank=rank, chunk=chunk,
        spatial_hold_frac=spatial_hold_frac, env_thr=env_thr,
        share_floor=share_floor, n_seeds=n_seeds, verbose=verbose,
        topk=topk, env_transform=env_transform,
        realign_reseeds=realign_reseeds, n_devices=n_devices,
        band_em=band_em, noalign=noalign, select=select,
        reseed_select=reseed_select, learned=learned,
        learned_params=learned_params)

    # rung 2: each kept fine run's images -> coarse-grid dominance votes.
    # Laddering the top-k DISTINCT fine candidates (not just the winner)
    # de-risks the fine-stage selection: a degenerate fine pick that
    # collapses at the coarse grid gets vetoed there and the next fine
    # candidate takes over -- but ranking stays with the FINE stage
    # (tier = fine rank), because coarse-grid envelope statistics cannot
    # order candidates on onset-locked material (see selection caveat in
    # docs/design.md section 6e).
    tops = info_f.pop("tops", None) or [{"name": info_f["picked"],
                                         "Y": None}]
    cands_c, tiers = [], {}
    for rank_i, rec in enumerate(tops):
        Yf = np.asarray(rec["Y"]) if rec.get("Y") is not None else YF
        P = []
        for j in range(J):
            yj = np.asarray(tft_f.invertTransform(Yf[j], nsamples=n))
            Yj = np.asarray(tft_c.computeTransform(
                np.ascontiguousarray(yj).astype(np.float32)))
            P.append((np.abs(Yj) ** 2).sum(-1))
        lab = np.argmax(np.stack(P), axis=0)
        name = f"ladder{rank_i}[{rec['name'].split('|')[0]}]"
        cands_c.append((name, np.eye(J)[lab]))
        tiers[name] = rank_i
    for r in range(reseed_rounds):
        # coarse reseeds inherit the tier of whatever run they reseed
        # from; conservatively pin them to the best tier so the guarded
        # acceptance (selection_key improves) stays the only gate
        tiers[f"reseed{r + 1}"] = 0

    XC = np.asarray(tft_c.computeTransform(x.astype(np.float32)))
    Y, info = _pool_and_reseed(
        XC, cands_c, J, iters=iters, em_seeds=em_seeds,
        reseed_rounds=reseed_rounds, nmf_comps=nmf_comps, rank=rank,
        chunk=chunk, spatial_hold_frac=spatial_hold_frac, env_thr=env_thr,
        share_floor=share_floor, verbose=verbose, tiers=tiers,
        env_transform=env_transform, realign_reseeds=realign_reseeds,
        n_devices=n_devices, select=select, reseed_select=reseed_select)
    info["fine"] = {k: v for k, v in info_f.items() if k != "params"}
    info["transform"] = tft_c
    return Y, info
