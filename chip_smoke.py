"""Smoke test of the flagship separation path on one GPU.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --devices 4   # four cards: the multi-card phase only

The flagship model is MultiChanNMFInst_FASST on a 10 s 44.1 kHz stereo
mixture (wlen 1024, hop 512: an (F, N) plane of 513 x 863), J = 2
sources, K = 8 NMF components, 500 GEM iterations, random initial
parameters from fixed seeds. Phases, all in this one process:

  1. card: device as JAX reports it, card name and power limit
     (nvidia-smi, a child process that stays off JAX);
  2. api: FASST.estim_param_a_posteriori -> separate_spat_comps;
  3. cli: `separate` through pyfasst_jax.__main__.main(argv);
  4. batch: parallel.batch.batch_separate of 8 distinct clips on a
     1-device mesh;
  5. kernel: the compiled fused E-step kernel against the XLA E-step
     (estep.compute_suff_stats) at F = 513, N = 863;
  6. cpu: 50 GEM iterations on the GPU against the same program on the
     host CPU backend.

Every clip must end with a finite, late-monotone log-likelihood and a
permutation-best min SDR above 60 dB. With --devices 4 the script runs
batch_separate of the 8 clips on make_mesh(4) against the 1-device run
(per-clip log-likelihood and SDR), and the blind reverberant pipeline
with n_devices=4 against n_devices=1 on the configs[2] mixture (4
sources, 16 kHz, 6 s, seed 102), which must pick the same candidate.

Without a GPU the script exits non-zero and prints no result; any failed
phase raises. The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

NITER = 500
NITER_CPU = 50
N_CLIPS = 8
MIN_SDR_DB = 60.0
# Late-monotone: over the last half of the run no iteration may lower the
# log-likelihood by more than this fraction of its final magnitude.
LATE_DROP = 1e-6
# Kernel vs XLA E-step: max |kernel - xla| / max |xla| per statistic. The
# two sum the 863 frames in different orders (128-frame tiles plus a
# cross-tile sum, against XLA's reduction tree), and the rank-2 posterior
# inverses round differently; on an H100 (700 W) the largest error was
# 1.3e-5 (rank-2 xi and T4), the rank-1 ones below 1e-6.
KERNEL_RTOL = 1e-4
# 50 GEM iterations, GPU vs host CPU: relative difference of each
# log-likelihood. EM feeds each step's rounding into the next, so the
# trajectories drift apart slowly; 1e-4 leaves room for that drift but
# not for a wrong step.
TRAJ_RTOL = 1e-4
# 4 cards against 1, 500 iterations: the 1-card run uses the fused kernel,
# the 4-card run XLA's E-step partitioned over the fp axis, so every step
# rounds differently and the difference compounds along the annealed
# trajectory (measured on four H100s: up to 2.2e-4 of the log-likelihood,
# min SDRs within 0.2 dB). A mis-sharded reduction moves the
# log-likelihood by whole percents.
MULTI_RTOL = 1e-3
MULTI_SDR_DB = 0.5


def card_line() -> str:
    """Card name and power limit, read by nvidia-smi in a child process."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def require_gpu(count: int):
    """The first `count` GPU devices; exit non-zero without them."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < count:
        sys.exit(f"chip_smoke: needs {count} GPU device(s), JAX found "
                 f"{[d.platform for d in devs]}")
    return devs[:count]


# -- checks -------------------------------------------------------------------

def min_sdr(ys, ys_true) -> float:
    """Permutation-best min source SDR (dB) of estimated images ys
    (J, T, I) against ys_true (J, T, I)."""
    import itertools

    def sdr(e, r):
        return 10 * np.log10(np.sum(r ** 2)
                             / max(np.sum((e - r) ** 2), 1e-30))
    T = min(ys.shape[1], ys_true.shape[1])
    J = ys_true.shape[0]
    return max(min(sdr(ys[p[j], :T], ys_true[j, :T]) for j in range(J))
               for p in itertools.permutations(range(J)))


def late_drop(ll) -> float:
    """Largest late-iteration decrease relative to |final loglik|."""
    ll = np.asarray(ll, np.float64)
    d = np.diff(ll[len(ll) // 2:])
    return float(max(0.0, -d.min()) / abs(ll[-1])) if d.size else 0.0


def check_clip(name, ll, sdr, min_sdr_db=MIN_SDR_DB):
    ll = np.asarray(ll, np.float64)
    drop = late_drop(ll)
    print(f"{name}: final loglik {ll[-1]:.6g}, late drop {drop:.3g}, "
          f"min SDR {sdr:.2f} dB")
    if not np.all(np.isfinite(ll)):
        raise AssertionError(f"{name}: non-finite log-likelihood")
    if drop > LATE_DROP:
        raise AssertionError(f"{name}: log-likelihood falls late ({drop})")
    if not sdr > min_sdr_db:
        raise AssertionError(f"{name}: min SDR {sdr:.2f} dB "
                             f"<= {min_sdr_db}")


# -- fixtures -----------------------------------------------------------------

def flagship_clip(seed=0, dur=None):
    """(mix (T, 2), true images (2, T, 2)) of the bench fixture at a
    -6 dBFS mixture peak: a source image may peak above its mixture, and
    at full scale the WAV writer would rescale such a stem."""
    import bench
    mix, y1, y2 = bench.make_mixture(seed=seed, dur=dur or bench.DUR,
                                     return_sources=True)
    return 0.5 * mix, 0.5 * np.stack([y1, y2])


def flagship_plane(seed=0, dur=None):
    """Unit-power mixture STFT (F, N, 2) of one flagship clip, and its
    scale."""
    import bench
    from pyfasst_jax.tf.stft import STFT
    mix, _ = flagship_clip(seed, dur)
    X = np.asarray(STFT(wlen=bench.WLEN, hop=bench.HOP, fs=bench.FS)
                   .computeTransform(mix))
    scale = float(np.sqrt(np.mean(np.abs(X) ** 2)))
    return X / scale, scale


# -- phases -------------------------------------------------------------------

def phase_api(workdir, niter=NITER, dur=None):
    """FASST.estim_param_a_posteriori -> separate_spat_comps on a WAV."""
    import bench
    from pyfasst_jax import MultiChanNMFInst_FASST
    from pyfasst_jax.audio import AudioObject, wavread
    mix, ys_true = flagship_clip(0, dur)
    wav = AudioObject(data=mix, samplerate=bench.FS)._write(
        os.path.join(workdir, "mix.wav"))
    model = MultiChanNMFInst_FASST(wav, nbComps=bench.J,
                                   nbNMFComps=bench.K, wlen=bench.WLEN,
                                   iter_num=niter)
    ll = model.estim_param_a_posteriori()
    paths = model.separate_spat_comps(os.path.join(workdir, "api"))
    ys = np.stack([wavread(p)[0] for p in paths])
    return {"plane": (model.F, model.N), "loglik": ll,
            "sdr": min_sdr(ys, ys_true)}


def phase_cli(workdir, niter=NITER, dur=None):
    """`separate` through the CLI's main(argv), in this process."""
    import bench
    from pyfasst_jax.__main__ import main
    from pyfasst_jax.audio import AudioObject, wavread
    mix, ys_true = flagship_clip(0, dur)
    wav = AudioObject(data=mix, samplerate=bench.FS)._write(
        os.path.join(workdir, "cli_mix.wav"))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(["separate", wav, "-o", os.path.join(workdir, "cli"),
                   "--iters", str(niter), "--nmf-comps", str(bench.K),
                   "--wlen", str(bench.WLEN), "--sources", str(bench.J),
                   "-q"])
    if rc != 0:
        raise AssertionError(f"cli: separate exited {rc}")
    report = json.loads(out.getvalue().strip().splitlines()[-1])
    ys = np.stack([wavread(p)[0] for p in report["files"]])
    return {"final_loglik": report["final_loglik"],
            "sdr": min_sdr(ys, ys_true)}


def phase_batch(mesh=None, n_clips=N_CLIPS, niter=NITER, dur=None):
    """batch_separate of n_clips distinct flagship clips on `mesh`
    (default: a 1-device mesh)."""
    import bench
    from pyfasst_jax.parallel import make_mesh
    from pyfasst_jax.parallel.batch import batch_separate
    from pyfasst_jax.tf.stft import STFT
    from pyfasst_jax.utils.config import GEMConfig
    tft = STFT(wlen=bench.WLEN, hop=bench.HOP, fs=bench.FS)
    Xs, scales, truths = [], [], []
    for b in range(n_clips):
        X, scale = flagship_plane(b, dur)
        Xs.append(X)
        scales.append(scale)
        truths.append(flagship_clip(b, dur))
    imgs, lls = batch_separate(
        Xs, lambda F, Npad, i: bench.build_params(F, Npad, seed=i),
        GEMConfig(niter=niter), mesh=mesh or make_mesh(1))
    sdrs = []
    for Y, scale, (mix, ys_true) in zip(imgs, scales, truths):
        ys = np.stack([np.asarray(tft.invertTransform(
            Y[j], nsamples=mix.shape[0])) for j in range(Y.shape[0])])
        sdrs.append(min_sdr(ys * scale, ys_true))
    return {"loglik": lls, "sdr": sdrs}


def _stat_errors(got, want):
    """max |got - want| / max |want| for every SuffStats array."""
    import jax
    errs = {}
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree_util.tree_leaves(want)):
        g, w = np.asarray(g), np.asarray(w)
        errs[jax.tree_util.keystr(path)] = float(
            np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))
    return errs


def phase_kernel(interpret=False, dur=None, n_batch=N_CLIPS):
    """Compiled fused E-step vs the XLA E-step on the flagship plane:
    ranks (1, 1) real mixing, ranks (2, 2) complex with and without
    noise injection, and the vmapped batch of n_batch (1, 1) clips."""
    import jax
    import jax.numpy as jnp
    import bench
    from pyfasst_jax.models.components import SpatialComp
    from pyfasst_jax.ops.estep import compute_suff_stats
    from pyfasst_jax.ops.gem import annealing_endpoints, spatial_covs
    from pyfasst_jax.ops.mstep import _as_conv_A
    from pyfasst_jax.ops.pallas_estep import pallas_suff_stats
    from pyfasst_jax.utils.config import GEMConfig

    def inputs(seed, rank2):
        X, _ = flagship_plane(seed, dur)
        F, N = X.shape[:2]
        params = bench.build_params(F, N, seed=seed)
        if rank2:
            rng = np.random.default_rng(seed)
            params = params.replace(spat=tuple(SpatialComp(
                A=jnp.asarray(0.5 * (rng.standard_normal((F, 2, 2))
                                     + 1j * rng.standard_normal((F, 2, 2))),
                              jnp.complex64), mix_type="conv")
                for _ in params.spat))
        X = jnp.asarray(X, jnp.complex64)
        sigma, _ = annealing_endpoints(X, GEMConfig())
        A_conv = tuple(_as_conv_A(c, F) for c in params.spat)
        return (X, params.all_source_powers(), spatial_covs(params, F),
                sigma, tuple(c.rank for c in params.spat), A_conv)

    def both(X, v, Rj, sigma, ranks, A_conv, ns_inj, real_cov):
        want = compute_suff_stats(X, v, Rj, sigma, ranks,
                                  noise_inject=ns_inj, A_conv=A_conv)
        got = pallas_suff_stats(X, v, Rj, sigma, ranks, A_conv,
                                noise_inject=ns_inj, interpret=interpret,
                                real_cov=real_cov)
        return got, want

    results = {}
    with jax.default_matmul_precision("highest"):
        for name, rank2, ns_inj in (("ranks11_real", False, False),
                                    ("ranks22_complex", True, False),
                                    ("ranks22_complex_ns_inj", True, True)):
            X, v, Rj, sigma, ranks, A_conv = inputs(0, rank2)
            fn = jax.jit(lambda *a, ns=ns_inj, rc=not rank2, r=ranks:
                         both(*a[:4], r, a[4], ns, rc))
            got, want = fn(X, v, Rj, sigma, A_conv)
            results[name] = _stat_errors(got, want)
        batch = [inputs(b, False) for b in range(n_batch)]
        ranks = batch[0][4]
        stacked = [jnp.stack([b[i] for b in batch]) for i in range(4)]
        A_b = tuple(jnp.stack([b[5][j] for b in batch])
                    for j in range(len(ranks)))
        fn = jax.jit(jax.vmap(lambda X, v, Rj, s, A:
                              both(X, v, Rj, s, ranks, A, False, True)))
        got, want = fn(*stacked, A_b)
        results[f"batch{n_batch}_ranks11_real"] = _stat_errors(got, want)
    return results


def phase_cpu(niter=NITER_CPU, dur=None):
    """The flagship GEM run on the default device and on the host CPU
    backend, same inputs: relative log-likelihood difference per
    iteration."""
    import jax
    import jax.numpy as jnp
    import bench
    from pyfasst_jax.ops.gem import run_gem
    from pyfasst_jax.utils.config import GEMConfig
    X, _ = flagship_plane(0, dur)
    params = bench.build_params(X.shape[0], X.shape[1])
    cfg = GEMConfig(niter=niter)
    X = jnp.asarray(X, jnp.complex64)
    _, ll_dev = run_gem(params, X, cfg)
    cpu = jax.devices("cpu")[0]
    _, ll_cpu = run_gem(jax.device_put(params, cpu), jax.device_put(X, cpu),
                        cfg)
    ll_dev = np.asarray(ll_dev, np.float64)
    ll_cpu = np.asarray(ll_cpu, np.float64)
    return {"loglik_dev": ll_dev, "loglik_cpu": ll_cpu,
            "rel": float(np.max(np.abs(ll_dev - ll_cpu)
                                / np.abs(ll_cpu)))}


def phase_multi(n_devices, niter=NITER, dur=None, reverb_iters=100):
    """batch_separate on make_mesh(n_devices) vs one device, and the blind
    reverberant pipeline with n_devices vs 1 on the configs[2] mixture."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from pyfasst_jax.models.reverb import blind_reverb_separate
    from pyfasst_jax.parallel import make_mesh
    from pyfasst_jax.tf.stft import STFT
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from validate_hw import FS, WLEN, reverb_mixture

    mesh = make_mesh(n_devices)
    placed = jax.device_put(np.zeros((2 * mesh.shape["dp"], 8), np.float32),
                            NamedSharding(mesh, P("dp", "fp")))
    cards = {s.device.id for s in placed.addressable_shards}
    print(f"multi: mesh {dict(mesh.shape)} places shards on cards "
          f"{sorted(cards)}")
    if len(cards) != n_devices:
        raise AssertionError("multi: mesh does not span every card")
    one = phase_batch(make_mesh(1), niter=niter, dur=dur)
    many = phase_batch(mesh, niter=niter, dur=dur)
    rel = [float(np.max(np.abs(a - b) / np.abs(a)))
           for a, b in zip(one["loglik"], many["loglik"])]
    mix, _ = reverb_mixture(np.random.default_rng(102))
    X = np.asarray(STFT(wlen=WLEN, fs=FS).computeTransform(
        mix.astype(np.float32)))
    kw = dict(J=4, iters=reverb_iters, em_seeds=2, reseed_rounds=0)
    _, info1 = blind_reverb_separate(X, n_devices=1, **kw)
    _, infon = blind_reverb_separate(X, n_devices=n_devices, **kw)
    return {"one": one, "many": many, "loglik_rel": rel,
            "picked": (info1["picked"], infon["picked"])}


# -- main ---------------------------------------------------------------------

def _timed(name, fn, *args, **kw):
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s "
          "(compilation included)")
    return out


def run_single(workdir):
    api = _timed("api", phase_api, workdir)
    print(f"api: plane {api['plane']}")
    check_clip("api", api["loglik"], api["sdr"])
    cli = _timed("cli", phase_cli, workdir)
    print(f"cli: final loglik {cli['final_loglik']:.6g}, "
          f"min SDR {cli['sdr']:.2f} dB")
    if not (np.isfinite(cli["final_loglik"]) and cli["sdr"] > MIN_SDR_DB):
        raise AssertionError("cli: separation failed its gate")
    batch = _timed("batch", phase_batch)
    for b, (ll, sdr) in enumerate(zip(batch["loglik"], batch["sdr"])):
        check_clip(f"batch clip {b}", ll, sdr)
    kernel = _timed("kernel", phase_kernel)
    for name, errs in kernel.items():
        worst = max(errs, key=errs.get)
        print(f"kernel {name}: worst {worst} {errs[worst]:.3g} "
              f"(limit {KERNEL_RTOL})")
        if errs[worst] > KERNEL_RTOL:
            raise AssertionError(f"kernel {name}: {worst} off by "
                                 f"{errs[worst]:.3g}")
    cpu = _timed("cpu", phase_cpu)
    print(f"cpu: {NITER_CPU}-iteration loglik max relative difference "
          f"{cpu['rel']:.3g} (limit {TRAJ_RTOL})")
    if not cpu["rel"] <= TRAJ_RTOL:
        raise AssertionError("cpu: GPU and CPU trajectories disagree")


def run_multi(n_devices):
    """Every comparison is printed before the first failure is raised."""
    res = _timed("multi", phase_multi, n_devices)
    failures = []
    for b in range(N_CLIPS):
        sdr_gap = abs(res["one"]["sdr"][b] - res["many"]["sdr"][b])
        print(f"  1-card clip {b}: min SDR {res['one']['sdr'][b]:.2f} dB, "
              f"loglik max relative difference {res['loglik_rel'][b]:.3g} "
              f"(limit {MULTI_RTOL}), SDR gap {sdr_gap:.2f} dB "
              f"(limit {MULTI_SDR_DB})")
        try:
            check_clip(f"{n_devices}-card clip {b}",
                       res["many"]["loglik"][b], res["many"]["sdr"][b])
        except AssertionError as e:
            failures.append(str(e))
        if not (res["loglik_rel"][b] <= MULTI_RTOL
                and sdr_gap <= MULTI_SDR_DB):
            failures.append(f"multi: clip {b} differs from 1 card")
    print(f"multi: blind reverb picked {res['picked'][0]!r} on 1 card, "
          f"{res['picked'][1]!r} on {n_devices}")
    if res["picked"][0] != res["picked"][1]:
        failures.append("multi: device count changed the pick")
    if failures:
        raise AssertionError("; ".join(failures))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4: run only the multi-card phase")
    args = ap.parse_args(argv)
    devs = require_gpu(args.devices)
    from pyfasst_jax.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    print(f"device: {devs[0].platform} {devs[0].device_kind} "
          f"x{len(devs)}")
    print(f"card: {card_line()}")
    with tempfile.TemporaryDirectory() as workdir:
        if args.devices == 1:
            run_single(workdir)
        else:
            run_multi(args.devices)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
