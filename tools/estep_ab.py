"""A/B of the fused E-step kernel against XLA's E-step on one GPU.

    python tools/estep_ab.py [--rounds 2] [--micro-only]
                             [--micro-ranks 11r 22 ...]

Times bench.py's flagship pipeline (STFT -> 500-iteration GEM -> Wiener
-> ISTFT, 10 s stereo 44.1 kHz, J = 2, K = 8) for one clip and for the
vmapped batch of 8, with GEMConfig.use_pallas off (xla) and on (kernel),
in turns within one process: xla, kernel, kernel, xla per round. Each
timing is bench._timed's best of three dispatches after a compile, and
every run must pass bench's SDR gate. Prints one JSON line per timing and
a summary line with the medians.

First, the E-step alone: the kernel and estep.compute_suff_stats at the
flagship plane for several source counts and ranks (some outside
pallas_estep.kernel_covers, to check its limit), single clip and vmapped
batch of 8, as 100 E-steps inside one jitted loop, so the time is the
device's and not the dispatch's; in turns, best of two.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp

import bench
from pyfasst_jax.tf.stft import sine_window
from pyfasst_jax.utils.compile_cache import enable_compile_cache
from pyfasst_jax.utils.config import GEMConfig


def _estep_inputs(ranks, real, batch):
    """Random E-step operands at the flagship plane (F, N) = (513, 863);
    real=True gives real-valued (instantaneous) mixing."""
    import numpy as np
    F, N = bench.WLEN // 2 + 1, 863
    rng = np.random.default_rng(0)
    lead = (batch,) if batch else ()
    X = jnp.asarray(rng.standard_normal(lead + (F, N, 2))
                    + 1j * rng.standard_normal(lead + (F, N, 2)),
                    jnp.complex64)
    v = jnp.asarray(0.1 + rng.random(lead + (len(ranks), F, N)),
                    jnp.float32)
    A = tuple(jnp.asarray(0.5 * (np.abs(rng.standard_normal(
        lead + (F, 2, r))) if real else rng.standard_normal(
        lead + (F, 2, r)) + 1j * rng.standard_normal(lead + (F, 2, r))),
        jnp.complex64) for r in ranks)
    sigma = jnp.asarray(0.01 + 0.01 * rng.random(lead + (F,)), jnp.float32)
    return X, v, A, sigma


def estep_micro(specs, reps=100):
    """Device time of one E-step, kernel and XLA: `reps` E-steps in one
    jitted fori_loop (each on a slightly different sigma, so nothing is
    hoisted), timed after a compile. specs are rank strings such as "22"
    or "11r" (r: real mixing). Returns {name: us per E-step}."""
    import time
    from pyfasst_jax.ops import herm
    from pyfasst_jax.ops.estep import compute_suff_stats
    from pyfasst_jax.ops.pallas_estep import pack_x4, pallas_suff_stats

    def looped(use_kernel, ranks, real):
        def run(X, v, A, sigma):
            x4 = pack_x4(X)
            Rj = jnp.stack([herm.herm_from_mixing(a) for a in A])

            def body(i, acc):
                s = sigma * (1.0 + 1e-7 * i)
                st = (pallas_suff_stats(None, v, None, s, ranks, A, x4=x4,
                                        real_cov=real) if use_kernel else
                      compute_suff_stats(X, v, Rj, s, ranks, A_conv=A))
                # consume every statistic: XLA would otherwise drop the
                # unused ones from its E-step and time only the loglik
                return acc + sum(jnp.sum(jnp.real(leaf))
                                 for leaf in jax.tree_util.tree_leaves(st))
            return jax.lax.fori_loop(0, reps, body, jnp.float32(0.0))
        return run

    out = {}
    for spec in specs:
        ranks = tuple(int(c) for c in spec.rstrip("r"))
        real = spec.endswith("r")
        for batch in (0, 8):
            args = _estep_inputs(ranks, real, batch)
            fns = {}
            for name in ("xla", "kernel"):
                g = looped(name == "kernel", ranks, real)
                fns[name] = jax.jit(jax.vmap(g) if batch else g)
                jax.block_until_ready(fns[name](*args))
            for name in ("xla", "kernel", "kernel", "xla"):
                t0 = time.perf_counter()
                jax.block_until_ready(fns[name](*args))
                us = (time.perf_counter() - t0) / reps * 1e6
                out.setdefault(f"{name}/ranks{spec}/b{batch}", []).append(us)
    return {k: min(v) for k, v in out.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--micro-only", action="store_true")
    ap.add_argument("--micro-ranks", nargs="+",
                    default=["11r", "22", "1111", "222", "2222"])
    args = ap.parse_args()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"estep_ab: needs a GPU, JAX found {dev}")
    enable_compile_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}; device {dev.device_kind}")
    with jax.default_matmul_precision("highest"):
        micro = estep_micro(args.micro_ranks)
    for k, us in sorted(micro.items()):
        print(json.dumps({"estep": k, "us": round(us, 1)}), flush=True)
    if args.micro_only:
        return
    nsamples = int(bench.FS * bench.DUR)
    window = jnp.asarray(sine_window(bench.WLEN), jnp.float32)
    cfg = GEMConfig(niter=bench.NITER)
    paths = {"xla": dataclasses.replace(cfg, use_pallas=False),
             "kernel": cfg}
    shapes = {"single": 0, "batch8": 8}
    cases = {(p, s): bench.flagship_case(paths[p], window, nsamples, b)
             for p in paths for s, b in shapes.items()}
    xrt = {k: [] for k in cases}
    for r in range(args.rounds):
        for path in ("xla", "kernel", "kernel", "xla"):
            for shape, b in shapes.items():
                x = bench.run_case(None, window, nsamples, b,
                                   case=cases[(path, shape)])
                xrt[(path, shape)].append(x)
                print(json.dumps({"round": r, "path": path, "shape": shape,
                                  "xrt": x}), flush=True)
    print(json.dumps({"card": card, "device_kind": dev.device_kind,
                      "median_xrt": {f"{p}/{s}": statistics.median(v)
                                     for (p, s), v in xrt.items()}}))


if __name__ == "__main__":
    main()
