"""Benchmark: xRT (audio-seconds separated per second per card).

Separates 10 s stereo 44.1 kHz mixtures with 500 EM iterations and prints
ONE JSON line:
    {"metric": "xRT", "value": N, "unit": "audio-sec/sec/chip", "vs_baseline": N}
vs_baseline is xRT / 50, the target set in BASELINE.json (the reference
publishes no numbers -- BASELINE.md).

The headline runs BATCH distinct clips through one vmapped program (STFT
-> 500-iteration GEM fori_loop -> Wiener separation -> ISTFT); every
clip's separation must pass the SDR quality gate. WAV I/O and compilation
are excluded (compile is once per shape; the metric is steady-state
throughput). Times end in block_until_ready. Without a GPU, or when any
path fails, the script fails: it has no fallback.
"""
from __future__ import annotations

import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from pyfasst_jax.models.components import (
    FasstParams, SpectralComp, SpatialComp, init_inst_mixing,
)
from pyfasst_jax.ops.gem import annealing_endpoints, run_gem
from pyfasst_jax.ops.wiener import separate_sources
from pyfasst_jax.tf.stft import _stft_core, _istft_core, sine_window
from pyfasst_jax.utils.config import GEMConfig

FS = 44100
DUR = 10.0
WLEN = 1024
HOP = 512
NITER = 500
J, K = 2, 8
TARGET_XRT = 50.0
BATCH = 8           # clips per vmapped dispatch
NITER_ERB = 200     # extra erblet row (its subband plane is ~10x the STFT's)


def make_mixture(fs=FS, dur=DUR, seed=0, return_sources=False):
    rng = np.random.default_rng(seed)
    n = int(fs * dur)
    t = np.arange(n) / fs
    f0 = 180.0 + 20.0 * (seed % 5)          # distinct mixtures per clip
    s1 = (0.4 * np.sin(2 * np.pi * (f0 * t
                                    + 3 * np.sin(2 * np.pi * 0.5 * t)))
          + 0.2 * np.sin(2 * np.pi * 2 * f0 * t)
          + 0.1 * np.sin(2 * np.pi * 3 * f0 * t))
    env = (np.sin(2 * np.pi * (1.0 + 0.1 * (seed % 7)) * t) > 0)
    s2 = 0.3 * rng.standard_normal(n) * env.astype(np.float64)
    a1, a2 = np.array([0.95, 0.31]), np.array([0.31, 0.95])
    y1 = s1[:, None] * a1
    y2 = s2[:, None] * a2
    mix = y1 + y2
    scale = np.max(np.abs(mix))
    if return_sources:
        return ((mix / scale).astype(np.float32),
                (y1 / scale).astype(np.float32),
                (y2 / scale).astype(np.float32))
    return (mix / scale).astype(np.float32)


def build_params(F, N, seed=0):
    rng = np.random.default_rng(seed)
    spat = tuple(SpatialComp(A=a) for a in init_inst_mixing(None, 2, 1, J))
    spec = tuple(SpectralComp(
        FB=jnp.asarray(0.5 + rng.random((F, K)), jnp.float32),
        TW=jnp.asarray(0.5 + rng.random((K, N)), jnp.float32),
        spat_ind=j) for j in range(J))
    return FasstParams(spat=spat, spec=spec)


def pipeline(mix, params, cfg, window, nsamples):
    """Full device pipeline for one clip (vmapped over the batch)."""
    X = _stft_core(mix, window, WLEN, HOP, "fft")        # (F, N, 2)
    params, logliks = run_gem(params, X, cfg)
    _, sigma1 = annealing_endpoints(X, cfg)
    Y = separate_sources(params, X, sigma1)               # (J, F, N, 2)
    ys = [_istft_core(Y[j], window, WLEN, HOP, nsamples) for j in range(J)]
    return jnp.stack(ys), logliks


def _timed(run, args, label, reps=3):
    """Warm-up (compile) + the best of `reps` steady-state dispatches,
    each ended by block_until_ready."""
    jax.block_until_ready(run(*args))
    times = []
    for _rep in range(reps):
        t0 = time.perf_counter()
        ys, logliks = jax.block_until_ready(run(*args))
        times.append(time.perf_counter() - t0)
    ll = np.asarray(logliks, np.float64)
    if not np.all(np.isfinite(ll[..., -1])):
        raise FloatingPointError("non-finite loglik")
    print(f"bench: {label} per-dispatch {min(times):.3f}s", file=sys.stderr)
    return min(times), ys


def _sdr_gate_batch(ys_b, y_true):
    """Per-clip permutation-best min source SDR, computed on device (the
    images are ~100 MB; only (B,) scalars come back)."""
    yt = jnp.asarray(np.stack(y_true))                    # (B, J, T, 2)

    def clip_min_sdr(ys, yt1):
        def sdr(e, r):
            return 10.0 * jnp.log10(jnp.sum(r ** 2)
                                    / jnp.maximum(jnp.sum((e - r) ** 2),
                                                  1e-12))
        p0 = jnp.minimum(sdr(ys[0], yt1[0]), sdr(ys[1], yt1[1]))
        p1 = jnp.minimum(sdr(ys[1], yt1[0]), sdr(ys[0], yt1[1]))
        return jnp.maximum(p0, p1)

    return np.asarray(jax.jit(jax.vmap(clip_min_sdr))(ys_b, yt))


def flagship_case(cfg, window, nsamples, batch):
    """(run, args, true images) for `batch` distinct flagship clips through
    one vmapped jitted pipeline; batch=0 is the single clip, unvmapped."""
    import functools
    n = max(batch, 1)
    mixes, y1s, y2s = zip(*(make_mixture(seed=b, return_sources=True)
                            for b in range(n)))
    X0 = _stft_core(jnp.asarray(mixes[0]), window, WLEN, HOP, "fft")
    F, N = int(X0.shape[0]), int(X0.shape[1])
    params = [build_params(F, N, seed=b) for b in range(n)]
    run = functools.partial(pipeline, cfg=cfg, window=window,
                            nsamples=nsamples)
    if batch:
        args = (jnp.asarray(np.stack(mixes)),
                jax.tree.map(lambda *xs: jnp.stack(xs), *params))
        run = jax.vmap(run)
    else:
        args = (jnp.asarray(mixes[0]), params[0])
    y_true = [np.stack([y1s[b], y2s[b]]) for b in range(n)]
    return jax.jit(run), args, y_true


def run_case(cfg, window, nsamples, batch, case=None):
    """Time one flagship case and gate every clip's SDR; returns xRT.
    `case` reuses a flagship_case result (and its compiled program)."""
    run, args, y_true = case or flagship_case(cfg, window, nsamples, batch)
    label = f"batch-{batch}" if batch else "single"
    elapsed, ys = _timed(run, args, label)
    sdrs = _sdr_gate_batch(ys if batch else ys[None], y_true)
    print(f"bench: {label} per-clip min SDR "
          + " ".join(f"{s:.1f}" for s in sdrs), file=sys.stderr)
    assert float(sdrs.min()) > 60.0, \
        f"benchmark separation quality regressed: {sdrs.min():.2f} dB"
    return max(batch, 1) * DUR / elapsed


def _extra_row_erblet():
    """stderr-only breadth row: the ERBlet front-end through the same
    GEM + Wiener pipeline (the headline is stereo-STFT-only). 200 iters (the uniform-hop ERBlet plane is ~10x
    the STFT's bins; the row is a throughput diagnostic, not the
    headline metric)."""
    from pyfasst_jax.tf.erblet import ERBLetTransform

    iters = NITER_ERB
    mix = make_mixture()
    tft = ERBLetTransform(fs=FS, n_bands=48)
    cfg = GEMConfig(niter=iters)
    # analysis once, eagerly (computeTransform hosts its geometry build);
    # the timed region is GEM + Wiener + inverse on the subband plane --
    # the transform itself is a handful of FFT-sized ops, negligible
    # against `iters` EM iterations.
    X = tft.computeTransform(mix)
    F, N = int(X.shape[0]), int(X.shape[1])
    params = build_params(F, N)

    def run(X, params):
        params, logliks = run_gem(params, X, cfg)
        _, sigma1 = annealing_endpoints(X, cfg)
        Y = separate_sources(params, X, sigma1)
        ys = jnp.stack([tft.invertTransform(Y[j], nsamples=mix.shape[0])
                        for j in range(J)])
        return ys, logliks

    run = jax.jit(run)
    elapsed, _ = _timed(run, (X, params), "erblet-single")
    print(f"bench: extra-row erblet48 F={F} N={N} iters={iters} "
          f"xRT={DUR / elapsed:.1f}", file=sys.stderr)


def _extra_row_general_i():
    """stderr-only breadth row: the I=3 square-root general engine
    (ops/engine_general.py) at flagship shapes, 500 iters."""
    rng = np.random.default_rng(3)
    n = int(FS * DUR)
    t = np.arange(n) / FS
    s1 = np.sin(2 * np.pi * (200 * t + 3 * np.sin(2 * np.pi * 0.5 * t)))
    s2 = rng.standard_normal(n) * (np.sin(2 * np.pi * 1.3 * t) > 0)
    mix = (np.outer(s1, [0.9, 0.5, 0.2])
           + np.outer(s2, [0.2, 0.6, 0.95])).astype(np.float32)
    mix /= np.max(np.abs(mix))
    window = jnp.asarray(sine_window(WLEN), jnp.float32)
    cfg = GEMConfig(niter=NITER)
    X0 = _stft_core(jnp.asarray(mix), window, WLEN, HOP, "fft")
    F, N = int(X0.shape[0]), int(X0.shape[1])
    rngp = np.random.default_rng(0)
    spat = tuple(SpatialComp(A=jnp.asarray(
        0.4 + np.abs(rngp.standard_normal((3, 1))), jnp.float32))
        for _ in range(J))
    spec = tuple(SpectralComp(
        FB=jnp.asarray(0.5 + rngp.random((F, K)), jnp.float32),
        TW=jnp.asarray(0.5 + rngp.random((K, N)), jnp.float32),
        spat_ind=j) for j in range(J))
    params = FasstParams(spat=spat, spec=spec)

    def run(mix_d, params):
        X = _stft_core(mix_d, window, WLEN, HOP, "fft")
        params, logliks = run_gem(params, X, cfg)
        _, sigma1 = annealing_endpoints(X, cfg)
        Y = separate_sources(params, X, sigma1)
        ys = jnp.stack([_istft_core(Y[j], window, WLEN, HOP, mix.shape[0])
                        for j in range(J)])
        return ys, logliks

    run = jax.jit(run)
    elapsed, _ = _timed(run, (jax.device_put(jnp.asarray(mix)), params),
                        "general-I3-single")
    print(f"bench: extra-row general-I3 F={F} N={N} iters={NITER} "
          f"xRT={DUR / elapsed:.1f}", file=sys.stderr)


def main():
    if jax.devices()[0].platform != "gpu":
        raise SystemExit(f"bench: needs a GPU, JAX found {jax.devices()}")
    from pyfasst_jax.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    nsamples = int(FS * DUR)
    window = jnp.asarray(sine_window(WLEN), jnp.float32)
    xrt = run_case(GEMConfig(niter=NITER), window, nsamples, BATCH)
    # stderr-only breadth rows
    _extra_row_erblet()
    _extra_row_general_i()
    print(f"bench: batch-{BATCH} xRT={xrt:.1f} on "
          f"{jax.devices()[0].device_kind}", file=sys.stderr)
    print(json.dumps({
        "metric": "xRT",
        "value": round(float(xrt), 3),
        "unit": "audio-sec/sec/chip",
        "vs_baseline": round(float(xrt / TARGET_XRT), 4),
    }))


if __name__ == "__main__":
    main()
