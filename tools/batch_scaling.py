"""Batched-path throughput scaling on one chip: aggregated xRT vs batch
size (the configs[4] device path: batched GEM + sharded Wiener separate).

Usage: python tools/batch_scaling.py [--batches 8 16 32] [--iters 300]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, nargs="+", default=[8, 16, 32])
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--dur", type=float, default=6.0,
                    help="seconds of audio per clip")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from tools.validate_hw import FS, WLEN, _sources
    from pyfasst_jax.models.components import (
        FasstParams, SpatialComp, init_inst_mixing, init_nmf_comp)
    from pyfasst_jax.ops.gem import endpoints_from_power
    from pyfasst_jax.parallel.sharding import (
        batch_params, batched_run_gem, make_mesh, sharded_batch_separate)
    from pyfasst_jax.tf.stft import STFT
    from pyfasst_jax.utils.config import GEMConfig
    import jax.numpy as jnp

    tft = STFT(wlen=WLEN, fs=FS)
    n = int(FS * args.dur)
    rng = np.random.default_rng(0)
    cfg = GEMConfig(niter=args.iters)
    mesh = make_mesh(1)

    for B in args.batches:
        Xs = []
        for i in range(B):
            s1, s2 = _sources(np.random.default_rng(i), n,
                              ["harm", "noise_hi"])
            mix = np.outer(s1, [0.95, 0.31]) + np.outer(s2, [0.31, 0.95])
            Xs.append(np.asarray(
                tft.computeTransform(mix.astype(np.float32))))
        F, N = Xs[0].shape[:2]
        X_b = jnp.asarray(np.stack(Xs))

        def mk(i):
            key = jax.random.PRNGKey(i)
            spat = tuple(SpatialComp(A=a)
                         for a in init_inst_mixing(None, 2, 1, 2))
            spec = tuple(init_nmf_comp(k, F, N, 8, spat_ind=j)
                         for j, k in enumerate(jax.random.split(key, 2)))
            return FasstParams(spat=spat, spec=spec)

        params_b = batch_params([mk(i) for i in range(B)])
        Pm = jnp.asarray(np.stack([
            np.mean(np.abs(np.asarray(x)) ** 2, axis=(1, 2))
            for x in Xs]).astype(np.float32))
        se = jax.vmap(lambda p: endpoints_from_power(p, cfg))(Pm)

        def device_path():
            pb, ll = batched_run_gem(params_b, X_b, cfg, mesh,
                                     sigma_endpoints_b=tuple(se))
            Y = sharded_batch_separate(pb, X_b, se[1], mesh)
            np.asarray(ll[-1, -1])
            np.asarray(jnp.real(Y[0, 0, 0, 0]))      # force completion

        device_path()                                 # compile + warm
        t0 = time.perf_counter()
        device_path()
        wall = time.perf_counter() - t0
        total_audio = B * args.dur
        print(json.dumps({
            "batch": B, "iters": args.iters,
            "audio_s": total_audio, "wall_s": round(wall, 3),
            "aggregated_xrt": round(total_audio / wall, 1),
        }), flush=True)


if __name__ == "__main__":
    main()
