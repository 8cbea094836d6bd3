"""configs[2] robustness study: the reverberant full-rank scenario across
fixture draws and EM seeds.

The blind spatial-cluster init (models/spatial_init.py) is the sensitive
stage -- VERDICT round 1 flagged that one bad draw can leave a source
unseparated (min SDR < 1 dB). This sweep quantifies the spread: for each
fixture rng seed it builds the SAME reverberant 4-source mixture family as
tools/validate_hw.py::scenario_reverb, runs the full blind pipeline
(consensus votes -> repair -> full-rank EM), and prints one JSON line per
draw plus a summary. Run on the GPU (or CPU with --iters lowered).

Usage: python tools/reverb_robustness.py [--draws 5] [--iters 400]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def run_draw(fixture_seed: int, em_seed: int, iters: int,
             repair="select", mode="pipeline", family="filters",
             mic_type="ortf", band_em=None, noalign=False,
             select=None, learned=False):
    from tools.validate_hw import FS, WLEN, _best_perm_sdr, _sources
    from pyfasst_jax.models.spatial_init import apply_profiles, full_rank_init
    from pyfasst_jax.models.variants import MultiChanNMFConv
    from pyfasst_jax.tf.stft import STFT

    rng = np.random.default_rng(fixture_seed)
    n = int(FS * 6.0)
    if family == "image":
        # second, independently-constructed family (threshold-transfer
        # validation, VERDICT r3 item 4): image-method RIRs, Sabine T60
        # law, speech-modulated sources -- tools/fixtures2.py
        from tools.fixtures2 import make_image_fixture
        mix, ys_true, _meta = make_image_fixture(fixture_seed, fs=FS,
                                                 dur=6.0, J=4,
                                                 mic_type=mic_type)
    else:
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

    t0 = time.perf_counter()
    if mode == "pipeline":
        # the full production recipe: pooled candidates at full
        # convergence, degeneracy-statistics selection, EM reseeding
        from pyfasst_jax.models.reverb import blind_reverb_separate
        Y, info = blind_reverb_separate(X, J=4, iters=iters,
                                        em_seeds=max(2, em_seed + 1),
                                        band_em=band_em, noalign=noalign,
                                        select=select, learned=learned)
        ys = np.stack([np.asarray(tft.invertTransform(Y[j], nsamples=n))
                       for j in range(4)])
        wall = time.perf_counter() - t0
        mn, mean = _best_perm_sdr(ys, ys_true)
        return {"fixture_seed": fixture_seed, "em_seed": em_seed,
                "min_sdr_db": round(float(mn), 2),
                "mean_sdr_db": round(float(mean), 2),
                "picked": info["picked"],
                "stages": [h["picked"] for h in info["history"]],
                "wall_s": round(wall, 1)}
    A0, tw_prof, fb_prof = full_rank_init(X, J=4, repair=repair)
    model = MultiChanNMFConv(mix, fs=FS, nbComps=4, nbNMFComps=6,
                             spatial_rank=2, init_mixing=A0,
                             wlen=WLEN, iter_num=iters,
                             spatial_hold_frac=0.3, seed=em_seed)
    model.params = apply_profiles(model.params, tw_prof, fb_prof)
    model.estim_param_a_posteriori()
    ys = model.separated_images()
    wall = time.perf_counter() - t0
    mn, mean = _best_perm_sdr(ys, ys_true)
    return {"fixture_seed": fixture_seed, "em_seed": em_seed,
            "min_sdr_db": round(float(mn), 2),
            "mean_sdr_db": round(float(mean), 2),
            "repair": str(repair), "wall_s": round(wall, 1)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--draws", type=int, default=5)
    ap.add_argument("--em-seeds", type=int, default=1)
    ap.add_argument("--iters", type=int, default=400)
    ap.add_argument("--base-seed", type=int, default=102,
                    help="first fixture seed (102 = validate_hw's draw)")
    ap.add_argument("--repair", default="select",
                    choices=("select", "heuristic", "off"))
    ap.add_argument("--mode", default="pipeline",
                    choices=("pipeline", "init"),
                    help="pipeline: models/reverb.py full recipe; "
                         "init: legacy full_rank_init + single EM")
    ap.add_argument("--env-transform", default=None,
                    help="override spatial_init._ENV_TRANSFORM "
                         "(log1p | rank)")
    ap.add_argument("--family", default="filters",
                    choices=("filters", "image"),
                    help="fixture family: 'filters' = the original "
                         "exponential-decay random-FIR family; 'image' = "
                         "image-method RIRs + speech-modulated sources "
                         "(tools/fixtures2.py, threshold-transfer check)")
    ap.add_argument("--mic-type", default="ortf",
                    choices=("ortf", "omni"),
                    help="image family mic pair: ortf = cardioid "
                         "(standard stereo recording; level+time cues); "
                         "omni = time-only cues (the measured-hard "
                         "boundary variant)")
    ap.add_argument("--band-em", type=int, default=None,
                    help="add band-local-EM vote candidate (band width)")
    ap.add_argument("--noalign", action="store_true",
                    help="add alignment-free consensus candidate")
    ap.add_argument("--learned", action="store_true",
                    help="add the learned-vote candidate "
                         "(models/binfeat; needs trained weights)")
    ap.add_argument("--select", default=None,
                    choices=("envcorr", "consistency", "learned"),
                    help="within-tier pool selection rule; default None = "
                         "the pipeline's auto rule (consistency when "
                         "em_seeds >= 2; design.md §6g)")
    args = ap.parse_args()
    if args.env_transform:
        import pyfasst_jax.models.spatial_init as si
        si._ENV_TRANSFORM = args.env_transform

    recs = []
    for d in range(args.draws):
        for e in range(args.em_seeds):
            repair = {"select": "select", "heuristic": True,
                      "off": False}[args.repair]
            rec = run_draw(args.base_seed + d, em_seed=e, iters=args.iters,
                           repair=repair, mode=args.mode,
                           family=args.family, mic_type=args.mic_type,
                           band_em=args.band_em, noalign=args.noalign,
                           select=args.select, learned=args.learned)
            rec["family"] = args.family
            if args.family == "image":
                rec["mic_type"] = args.mic_type
            recs.append(rec)
            print(json.dumps(rec), flush=True)
    mins = [r["min_sdr_db"] for r in recs]
    means = [r["mean_sdr_db"] for r in recs]
    print(json.dumps({
        "summary": "configs[2] robustness",
        "draws": len(recs), "iters": args.iters,
        "min_sdr": {"worst": min(mins), "median": float(np.median(mins)),
                    "best": max(mins)},
        "mean_sdr": {"worst": min(means), "median": float(np.median(means)),
                     "best": max(means)},
    }), flush=True)


if __name__ == "__main__":
    main()
