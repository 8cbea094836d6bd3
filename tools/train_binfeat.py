"""Train/evaluate the learned per-bin embedding (models/binfeat.py).

VERDICT r4 item 1: the last untried evidence family behind the blind
music/image boundary is a LEARNED per-bin feature. This tool trains the
deep-clustering embedding of `pyfasst_jax.models.binfeat` on unlimited
draws from the repo's own fixture generators and scores it with the
exact power-weighted vote-accuracy metric every hand family was measured
with (tools/align_diag.py::_acc), on the exact held-out seeds the
measured numbers use (reverb gate 102-106, image 202-206, music3 100+,
speech 120-124).

Hygiene (mandated by VERDICT): training seeds are DISJOINT ranges
(reverb 2000+, image 3000+, music 5000+, speech 6000+); evaluation runs
on the untouched measured-seed fixtures; cross-family transfer is a
first-class eval (train family A only -> test family B + music).

Subcommands
-----------
  gen    CPU (run with JAX_PLATFORMS=cpu): draw fixtures, emit training crops
         (inputs f16, dominance labels i8, bin power f32) to one .npz
  train  default accelerator (--platform cpu for a CPU run):
         Adam on the power-weighted deep-clustering loss, holdout loss
         reported per epoch; saves weights (pyfasst_jax/data/binfeat.npz
         is the production path models/binfeat.load_params() reads)
  eval   CPU or GPU: vote-accuracy table on a scenario's held-out seeds,
         learned votes vs the production consensus baseline

Usage
-----
  JAX_PLATFORMS=cpu python tools/train_binfeat.py gen --family reverb \
      --n 100 --out data_binfeat/reverb.npz
  python tools/train_binfeat.py train --data data_binfeat/reverb.npz \
      data_binfeat/image.npz --steps 3000 --out pyfasst_jax/data/binfeat.npz
  JAX_PLATFORMS=cpu python tools/train_binfeat.py eval \
      --params pyfasst_jax/data/binfeat.npz --scenario image \
      --seeds 202 203 204 205 206
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.dirname(__file__))

F_CROP = 513          # training plane height (16 kHz wlen-1024 full F)
N_CROP = 160          # training frames (> 3x the net's 48-frame field)
J_MAX = 4

# ---------------------------------------------------------------------------
# fixture draws (training families; seed ranges disjoint from all eval seeds)
# ---------------------------------------------------------------------------

_KIND_CATALOG = ["harm", "noise_lo", "noise_hi", "clicks", "tone_switch"]


def _draw_reverb(seed: int):
    """Domain-randomized family 1 (validate_hw exp-decay-FIR rooms):
    random J, source kinds, filter length/decay, direction gains, levels.
    The eval fixtures (reverb_lab.make_fixture, seeds 102-106) stay the
    untouched fixed-parameter generator."""
    from tools.validate_hw import FS, _sources

    rng = np.random.default_rng(seed)
    n = int(FS * 6.0)
    J = int(rng.integers(3, 5))
    kinds = list(rng.permutation(_KIND_CATALOG))[:J]
    if rng.uniform() < 0.5:  # sometimes a random bandpass stem
        lo = rng.uniform(0.02, 0.5)           # normalized band edges
        hi = min(lo + rng.uniform(0.1, 0.5), 0.95)
        kinds[rng.integers(0, J)] = f"band:{lo:.3f}-{hi:.3f}"
    srcs = _sources(rng, n, kinds)
    taps = int(rng.integers(60, 141))
    tau = rng.uniform(10.0, 30.0)
    g_dir = rng.uniform(1.2, 1.8)
    g_x = rng.uniform(0.3, 0.5)
    ys = []
    for j, s in enumerate(srcs):
        d = int(rng.integers(0, 2)) if rng.uniform() < 0.3 else (j % 2)
        lev = 10 ** (rng.uniform(-3, 3) / 20)
        chs = []
        for ch in range(2):
            h = rng.standard_normal(taps) * np.exp(-np.arange(taps) / tau)
            h[0] += g_dir if ch == d else g_x
            chs.append(np.convolve(s, h, "same") * lev)
        ys.append(np.stack(chs, 1))
    ys = np.stack(ys)
    return ys.sum(0), ys, FS, 1024


def _draw_image(seed: int):
    from tools.fixtures2 import make_image_fixture

    rng = np.random.default_rng(seed)
    J = int(rng.integers(3, 5))
    mic = "ortf" if rng.uniform() < 0.7 else "omni"
    mix, ys, _meta = make_image_fixture(seed, J=J, mic_type=mic)
    return mix, ys, 16000, 1024


def _draw_music(seed: int):
    from tools.music_lab import FS, _fixture

    rng = np.random.default_rng(seed)
    stems = int(rng.integers(3, 5))
    t60 = float(rng.uniform(0.08, 0.3))
    mix, ys, _n = _fixture(stems, t60, seed)
    return mix, ys, FS, 2048


def _draw_speech(seed: int):
    from tools.speech_lab import FS, _fixture

    rng = np.random.default_rng(seed)
    n_spk = int(rng.integers(2, 4))
    t60 = float(rng.uniform(0.15, 0.35))
    mix, ys, _n = _fixture(n_spk, t60, seed)
    return mix, ys, FS, 2048


_FAMILIES = {"reverb": (_draw_reverb, 2000), "image": (_draw_image, 3000),
             "music": (_draw_music, 5000), "speech": (_draw_speech, 6000)}


def _plane(mix, ys_true, fs, wlen):
    """mix (n, 2), ys_true (J, n, 2) -> (inp (F,N,5), lab (F,N), pw)."""
    from pyfasst_jax.models.binfeat import bin_inputs
    from pyfasst_jax.tf.stft import STFT

    tft = STFT(wlen=wlen, fs=fs)
    X = np.asarray(tft.computeTransform(mix.astype(np.float32)))
    inp, pw = bin_inputs(X)
    P = []
    for j in range(ys_true.shape[0]):
        Yj = np.asarray(tft.computeTransform(
            np.ascontiguousarray(ys_true[j]).astype(np.float32)))
        P.append((np.abs(Yj) ** 2).sum(-1))
    lab = np.argmax(np.stack(P), axis=0).astype(np.int8)
    return inp, lab, pw


def _crops(inp, lab, pw, rng, n_crops):
    """Full plane -> list of fixed-size crops. 16 kHz planes (F=513) keep
    the whole frequency axis; F=1025 planes take random frequency crops
    (the net is translation-equivariant in f -- it never sees absolute
    frequency -- so f-crops are legitimate training patches)."""
    F, N = pw.shape
    if N < N_CROP:  # short plane: zero-pad frames (pw=0 -> no loss weight)
        pad = N_CROP - N
        inp = np.pad(inp, ((0, 0), (0, pad), (0, 0)))
        lab = np.pad(lab, ((0, 0), (0, pad)))
        pw = np.pad(pw, ((0, 0), (0, pad)))
        N = N_CROP
    out = []
    for c in range(n_crops):
        f0 = 0 if F <= F_CROP else (0 if c == 0 else
                                    int(rng.integers(0, F - F_CROP + 1)))
        n0 = int(rng.integers(0, N - N_CROP + 1))
        sl = (slice(f0, f0 + F_CROP), slice(n0, n0 + N_CROP))
        if inp[sl].shape[:2] != (F_CROP, N_CROP):
            continue  # plane too short in frequency; skip
        out.append((inp[sl].astype(np.float16), lab[sl],
                    pw[sl].astype(np.float32)))
    return out


def cmd_gen(args):
    draw, seed0 = _FAMILIES[args.family]
    seed0 = args.seed0 if args.seed0 is not None else seed0
    X, L, W, js, seeds = [], [], [], [], []
    t0 = time.time()
    for i in range(args.n):
        seed = seed0 + i
        rng = np.random.default_rng(seed + 10 ** 6)
        mix, ys, fs, wlen = draw(seed)
        inp, lab, pw = _plane(mix, ys, fs, wlen)
        for c in _crops(inp, lab, pw, rng, args.crops):
            X.append(c[0]); L.append(c[1]); W.append(c[2])
            js.append(ys.shape[0]); seeds.append(seed)
        if (i + 1) % 10 == 0:
            print(f"gen {args.family}: {i + 1}/{args.n} draws, "
                  f"{len(X)} crops, {time.time() - t0:.0f}s",
                  file=sys.stderr, flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez_compressed(
        args.out, inp=np.stack(X), lab=np.stack(L), pw=np.stack(W),
        J=np.array(js, np.int8), seed=np.array(seeds, np.int32),
        family=args.family)
    print(json.dumps({"family": args.family, "crops": len(X),
                      "out": args.out,
                      "secs": round(time.time() - t0, 1)}), flush=True)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _force_platform(platform):
    if platform == "cpu":
        import jax
        jax.config.update("jax_platforms", "cpu")


def cmd_train(args):
    _force_platform(args.platform)
    import jax
    import jax.numpy as jnp
    import optax

    from pyfasst_jax.models import binfeat

    rng = np.random.default_rng(args.shuffle_seed)
    inp, lab, pw, fams = [], [], [], []
    for path in args.data:
        z = np.load(path)
        inp.append(z["inp"]); lab.append(z["lab"]); pw.append(z["pw"])
        fams.append(f"{z['family']}:{len(z['lab'])}")
    inp = np.concatenate(inp); lab = np.concatenate(lab)
    pw = np.concatenate(pw)
    M = len(inp)
    perm = rng.permutation(M)
    inp, lab, pw = inp[perm], lab[perm], pw[perm]
    n_hold = args.holdout
    print(f"train: {M} crops ({', '.join(fams)}), holdout {n_hold}, "
          f"platform {jax.devices()[0].platform}", file=sys.stderr,
          flush=True)

    # datasets live on device: f16 inputs (upcast per batch), i8 labels
    d_inp = jnp.asarray(inp[n_hold:])
    d_lab = jnp.asarray(lab[n_hold:])
    d_pw = jnp.asarray(pw[n_hold:])
    h_inp = jnp.asarray(inp[:n_hold]); h_lab = jnp.asarray(lab[:n_hold])
    h_pw = jnp.asarray(pw[:n_hold])

    if args.init_from:
        params = binfeat.load_params(args.init_from)
    else:
        params = binfeat.init_params(seed=args.init_seed)
    meta = params.pop("_meta")
    params = {k: jnp.asarray(v) for k, v in params.items()}

    sched = optax.cosine_decay_schedule(args.lr, args.steps, alpha=0.05)
    opt = optax.adam(sched)
    opt_state = opt.init(params)

    def loss_of(p, binp, blab, bpw):
        with jax.default_matmul_precision("highest"):
            V = binfeat.embed({**p, "_meta": meta}, binp.astype(jnp.float32))
        Y = jax.nn.one_hot(blab, J_MAX, dtype=jnp.float32)
        wb = bpw / jnp.maximum(
            bpw.sum(axis=(1, 2), keepdims=True), 1e-20)
        return binfeat.dc_loss(V, Y, wb)

    # NOTE: the dataset arrays are ARGUMENTS, not closure captures -- a
    # captured array is embedded in the compiled program as a constant.
    @jax.jit
    def run_chunk(p, s, idx, di, dl, dp):
        def step(carry, ix):
            p, s = carry
            loss, g = jax.value_and_grad(loss_of)(
                p, jnp.take(di, ix, 0), jnp.take(dl, ix, 0),
                jnp.take(dp, ix, 0))
            upd, s = opt.update(g, s, p)
            return (optax.apply_updates(p, upd), s), loss
        (p, s), losses = jax.lax.scan(step, (p, s), idx)
        return p, s, losses.mean()

    @jax.jit
    def hold_loss(p, hi, hl, hp):
        return loss_of(p, hi, hl, hp)

    n_train = M - n_hold
    chunk = args.log_every
    t0 = time.time()
    for c0 in range(0, args.steps, chunk):
        k = min(chunk, args.steps - c0)
        idx = rng.integers(0, n_train, size=(k, args.batch))
        params, opt_state, tr = run_chunk(params, opt_state,
                                          jnp.asarray(idx),
                                          d_inp, d_lab, d_pw)
        hl = float(hold_loss(params, h_inp, h_lab, h_pw)) \
            if n_hold else float("nan")
        print(json.dumps({"step": c0 + k, "train_loss": round(float(tr), 4),
                          "holdout_loss": round(hl, 4),
                          "secs": round(time.time() - t0, 1)}),
              file=sys.stderr, flush=True)
    out = binfeat.save_params(
        {**{k: np.asarray(v) for k, v in params.items()}, "_meta": meta},
        args.out)
    print(json.dumps({"saved": out, "steps": args.steps,
                      "final_holdout_loss":
                      round(float(hold_loss(params, h_inp, h_lab, h_pw)), 4)
                      if n_hold else None}), flush=True)


# ---------------------------------------------------------------------------
# evaluation: vote accuracy on the measured held-out fixtures
# ---------------------------------------------------------------------------

def _eval_fixture(scenario: str, seed: int):
    """The EXACT fixture constructions the measured numbers used."""
    from pyfasst_jax.tf.stft import STFT

    if scenario == "reverb":
        from tools.reverb_lab import make_fixture
        X, _Yt, ys_true, _mix, tft, _n = make_fixture(seed)
        return X, ys_true, tft, 4
    if scenario == "image":
        from tools.fixtures2 import make_image_fixture
        mix, ys_true, _meta = make_image_fixture(seed)
        tft = STFT(wlen=1024, fs=16000)
        X = np.asarray(tft.computeTransform(mix.astype(np.float32)))
        return X, ys_true, tft, 4
    if scenario in ("music3", "music4"):
        from tools.music_lab import FS, _fixture
        J = 3 if scenario == "music3" else 4
        mix, ys_true, _n = _fixture(J, 0.12 if J == 3 else 0.25, seed)
        tft = STFT(wlen=2048, fs=FS)
        X = np.asarray(tft.computeTransform(mix.astype(np.float32)))
        return X, ys_true, tft, J
    if scenario == "speech":
        from tools.speech_lab import FS, _fixture
        mix, ys_true, _n = _fixture(3, 0.25, seed)
        tft = STFT(wlen=2048, fs=FS)
        X = np.asarray(tft.computeTransform(mix.astype(np.float32)))
        return X, ys_true, tft, 3
    raise ValueError(scenario)


def _acc(lab, oracle_lab, pw, J):
    from itertools import permutations
    best = 0.0
    for p in permutations(range(J)):
        m = np.take(np.array(p), lab) == oracle_lab
        best = max(best, float((m * pw).sum() / pw.sum()))
    return best


def cmd_eval(args):
    from pyfasst_jax.models import binfeat

    params = binfeat.load_params(args.params)
    rows = []
    for seed in args.seeds:
        X, ys_true, tft, J = _eval_fixture(args.scenario, seed)
        P = []
        for j in range(J):
            Yj = np.asarray(tft.computeTransform(
                np.ascontiguousarray(ys_true[j]).astype(np.float32)))
            P.append((np.abs(Yj) ** 2).sum(-1))
        olab = np.argmax(np.stack(P), axis=0)
        from pyfasst_jax.models.spatial_init import tf_covariance_features
        _f, _w, pw, _xx = tf_covariance_features(X)

        votes = binfeat.learned_votes(X, J, params=params,
                                      platform=args.platform)
        acc = _acc(np.argmax(votes, -1), olab, pw, J)
        row = {"scenario": args.scenario, "seed": seed,
               "learned_acc": round(acc, 4)}
        if args.baseline:
            from pyfasst_jax.models.spatial_init import consensus_votes
            vb = consensus_votes(X, J)
            row["consensus_acc"] = round(
                _acc(np.argmax(vb, -1), olab, pw, J), 4)
        rows.append(row)
        print(json.dumps(row), flush=True)
    la = [r["learned_acc"] for r in rows]
    summ = {"scenario": args.scenario, "n": len(rows),
            "learned_min/med/max": [round(float(np.min(la)), 4),
                                    round(float(np.median(la)), 4),
                                    round(float(np.max(la)), 4)]}
    if args.baseline:
        ca = [r["consensus_acc"] for r in rows]
        summ["consensus_min/med/max"] = [round(float(np.min(ca)), 4),
                                         round(float(np.median(ca)), 4),
                                         round(float(np.max(ca)), 4)]
    print(json.dumps(summ), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("gen")
    g.add_argument("--family", choices=sorted(_FAMILIES), required=True)
    g.add_argument("--n", type=int, default=80)
    g.add_argument("--crops", type=int, default=2)
    g.add_argument("--seed0", type=int, default=None)
    g.add_argument("--out", required=True)
    g.set_defaults(fn=cmd_gen)

    t = sub.add_parser("train")
    t.add_argument("--data", nargs="+", required=True)
    t.add_argument("--steps", type=int, default=3000)
    t.add_argument("--batch", type=int, default=8)
    t.add_argument("--lr", type=float, default=1e-3)
    t.add_argument("--holdout", type=int, default=12)
    t.add_argument("--log-every", type=int, default=100)
    t.add_argument("--init-seed", type=int, default=0)
    t.add_argument("--init-from", default=None,
                   help="warm-start from an existing weights .npz")
    t.add_argument("--shuffle-seed", type=int, default=7)
    t.add_argument("--platform", default=None, choices=(None, "cpu", "gpu"))
    t.add_argument("--out", default=None)
    t.set_defaults(fn=cmd_train)

    e = sub.add_parser("eval")
    e.add_argument("--params", default=None)
    e.add_argument("--scenario", required=True,
                   choices=("reverb", "image", "music3", "music4", "speech"))
    e.add_argument("--seeds", type=int, nargs="+", required=True)
    e.add_argument("--baseline", action="store_true")
    e.add_argument("--platform", default=None)
    e.set_defaults(fn=cmd_eval)

    args = ap.parse_args()
    args.fn(args)


if __name__ == "__main__":
    main()
