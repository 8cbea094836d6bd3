"""Image-family diagnostic: where does the transfer failure live?

reverb_robustness --family image measured the blind pipeline at min-SDR
median ~0 dB on the image-method fixtures (vs 8.26 on the original
family). This tool splits that gap per draw:

  oracle-em -- EM from ORACLE dominance votes (the pipeline's inner fit
               from perfect bin labels): the model-capacity ceiling on
               this family. If THIS is low, the fixtures sit at the
               documented capability boundary (D/R < 0 at 1-1.8 m
               source distance) and no init can fix it; if it is high,
               the gap is init (vote) quality and the feature lab's
               numbers say whether WPE/onset features close it.

Usage: python tools/image_diag.py [--seeds 202,...] [--iters 400]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from fixtures2 import make_image_fixture                 # noqa: E402
from music_lab import _oracle_votes, _run_from_votes     # noqa: E402
from validate_hw import _best_perm_sdr                   # noqa: E402

FS, WLEN = 16000, 1024


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="202,203,204,205,206")
    ap.add_argument("--iters", type=int, default=400)
    ap.add_argument("--modes", default="oracle-em")
    args = ap.parse_args()

    from pyfasst_jax.tf.stft import STFT

    modes = args.modes.split(",")
    for seed in (int(s) for s in args.seeds.split(",")):
        mix, ys_true, meta = make_image_fixture(seed, fs=FS, dur=6.0, J=4)
        n = mix.shape[0]
        J = ys_true.shape[0]
        tft = STFT(wlen=WLEN, fs=FS)
        X = np.asarray(tft.computeTransform(mix.astype(np.float32)))
        votes = _oracle_votes(tft, np.ascontiguousarray(ys_true), J)
        for mode in modes:
            t0 = time.perf_counter()
            Y, ll = _run_from_votes(X, votes, J, args.iters)
            ys = np.stack([np.asarray(tft.invertTransform(Y[j],
                                                          nsamples=n))
                           for j in range(J)])
            mn, mean = _best_perm_sdr(ys, ys_true)
            print(json.dumps({
                "seed": seed, "mode": mode, "t60": meta["t60"],
                "min_sdr_db": round(float(mn), 2),
                "mean_sdr_db": round(float(mean), 2),
                "wall_s": round(time.perf_counter() - t0, 1)}),
                flush=True)


if __name__ == "__main__":
    main()
