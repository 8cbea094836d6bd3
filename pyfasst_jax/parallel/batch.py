"""High-level batch separation over many clips (BASELINE.json configs[4]).

Batch separation of a full SiSEC dev set, vmapped over clips/segments
across the cards of a mesh: clips of different lengths are padded into frame
BUCKETS (one compiled executable per bucket -- SURVEY.md §7's answer to
dynamic shapes), each bucket runs through the sharded batched GEM + Wiener
path, and per-clip results are cropped back.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pyfasst_jax.models.components import FasstParams
from pyfasst_jax.parallel.sharding import (
    batch_params, batched_run_gem, make_mesh, sharded_batch_separate,
)
from pyfasst_jax.ops.gem import endpoints_from_power
from pyfasst_jax.utils.config import GEMConfig


def frame_buckets(n_frames: Sequence[int], granularity: int = 128
                  ) -> Dict[int, List[int]]:
    """Group clip indices by padded frame count (multiples of granularity).

    One bucket = one compiled executable; padding waste is bounded by
    granularity/bucket_size.
    """
    buckets: Dict[int, List[int]] = {}
    for i, n in enumerate(n_frames):
        b = max(granularity, int(math.ceil(n / granularity)) * granularity)
        buckets.setdefault(b, []).append(i)
    return buckets


def _pad_frames(X: np.ndarray, n_target: int) -> np.ndarray:
    F, N, I = X.shape
    return np.pad(X, ((0, 0), (0, n_target - N), (0, 0)))


def _bucket_ckpt_path(checkpoint_dir: str, Npad: int) -> str:
    import os
    return os.path.join(checkpoint_dir, f"bucket_{Npad}.npz")


def batch_separate(
    Xs: Sequence[np.ndarray],
    make_params: Callable[[int, int, int], FasstParams],
    cfg: GEMConfig,
    mesh=None,
    granularity: int = 128,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 0,
    on_checkpoint: Optional[Callable[[int, int], None]] = None,
) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Estimate + separate a set of clips.

    Xs: list of complex STFTs (F, N_i, 2), same F (same transform), varying
    N_i. make_params(F, N_padded, clip_index) builds the initial pytree for
    one clip. Returns (images, logliks) per clip, cropped to true lengths;
    images are (J, F, N_i, 2).

    Zero-padded trailing frames are cropped from the outputs, and the
    annealing endpoints are computed from the UNPADDED frames of each clip
    (padding would dilute the per-frequency mean power and shrink the noise
    floor for heavily padded clips).

    checkpoint_dir + checkpoint_every=K persist each bucket's stacked
    params every K iterations (one .npz per frame bucket; same compiled
    executable across chunks -- the loop bounds are traced). A killed run
    re-invoked with the same arguments resumes each unfinished bucket from
    its last chunk boundary; the chunked trajectory is exactly the
    uninterrupted one (the annealing schedule is a pure function of the
    iteration index). A checkpoint whose clip membership or total
    iteration count disagrees with the current call is ignored (fresh
    start), not trusted. Completed buckets delete their checkpoint file.
    on_checkpoint(Npad, iteration), if given, is called after each chunk's
    save (progress reporting / test kill-switch).
    """
    import os

    mesh = mesh or make_mesh()
    dp = mesh.shape["dp"]
    F = Xs[0].shape[0]
    n_frames = [x.shape[1] for x in Xs]
    out_imgs: List[Optional[np.ndarray]] = [None] * len(Xs)
    out_lls: List[Optional[np.ndarray]] = [None] * len(Xs)
    every = int(checkpoint_every or 0)
    if every and not checkpoint_dir:
        raise ValueError("checkpoint_every requires checkpoint_dir")
    if checkpoint_dir:
        os.makedirs(checkpoint_dir, exist_ok=True)

    for Npad, idxs in sorted(frame_buckets(n_frames, granularity).items()):
        # round the batch up to a multiple of the dp axis with repeats
        batch_idx = list(idxs)
        while len(batch_idx) % dp != 0:
            batch_idx.append(idxs[-1])
        X_b = jnp.asarray(np.stack([
            _pad_frames(np.asarray(Xs[i], np.complex64), Npad)
            for i in batch_idx]))
        params_b = batch_params([make_params(F, Npad, i) for i in batch_idx])
        # per-clip endpoints from the true (pre-padding) frame counts;
        # host-side real power, so no complex upload is involved
        Pm_true = jnp.asarray(np.stack([
            np.mean(np.abs(np.asarray(Xs[i])) ** 2, axis=(1, 2))
            for i in batch_idx]).astype(np.float32))
        sig0_b, sig1_b = jax.vmap(
            lambda p: endpoints_from_power(p, cfg))(Pm_true)

        start, lls_acc = 0, np.zeros((len(batch_idx), cfg.niter), np.float32)
        ckpt = (_bucket_ckpt_path(checkpoint_dir, Npad)
                if checkpoint_dir else None)
        bucket_id = {"clips": list(map(int, batch_idx)),
                     "niter": int(cfg.niter)}
        if ckpt and os.path.exists(ckpt):
            from pyfasst_jax.utils.checkpoint import load_params
            saved, it, extra = load_params(ckpt)
            if extra.get("clips") == bucket_id["clips"] \
                    and extra.get("niter") == bucket_id["niter"]:
                params_b, start = saved, int(it)
                lls_acc = np.asarray(extra["logliks"], np.float32)

        while start < cfg.niter:
            end = min(start + every, cfg.niter) if every else cfg.niter
            params_b, lls = batched_run_gem(
                params_b, X_b, cfg, mesh,
                sigma_endpoints_b=(sig0_b, sig1_b), bounds=(start, end))
            lls_acc[:, start:end] = np.asarray(lls)[:, start:end]
            start = end
            if ckpt and (every and start < cfg.niter):
                from pyfasst_jax.utils.checkpoint import save_params
                save_params(ckpt, params_b, iteration=start,
                            extra=bucket_id,
                            extra_arrays={"logliks": lls_acc})
                if on_checkpoint is not None:
                    on_checkpoint(Npad, start)
        if ckpt and os.path.exists(ckpt):
            os.remove(ckpt)

        Y_b = sharded_batch_separate(params_b, X_b, sig1_b, mesh)
        Y_b = np.asarray(Y_b)
        for slot, i in enumerate(batch_idx[:len(idxs)]):
            out_imgs[i] = Y_b[slot][:, :, :n_frames[i], :]
            out_lls[i] = lls_acc[slot]
    return out_imgs, out_lls


def batch_separate_files(
    paths: Sequence[str],
    out_dir: str,
    nbComps: int = 2,
    nbNMFComps: int = 4,
    wlen: int = 1024,
    iters: int = 200,
    freq_basis: Optional[str] = None,
    n_bands: int = 40,
    seed: int = 0,
    granularity: int = 128,
    mesh=None,
) -> Dict[str, Dict]:
    """Batch-separate a directory's worth of WAV files (configs[4] user
    story, reachable from the CLI: `separate --batch dir/`).

    Variable-length clips ride the bucketed batch_separate path
    (instantaneous multichannel NMF model per clip, per-clip seeds); each
    clip's stems are written as <out_dir>/<stem>_est_<j>.wav. Returns a
    per-clip report {stem: {"files": [...], "final_loglik": float}}.
    """
    import os

    import jax

    from pyfasst_jax.audio import AudioObject
    from pyfasst_jax.models.components import (
        FasstParams, SpatialComp, init_inst_mixing, init_nmf_comp,
    )
    from pyfasst_jax.tf.filterbank import spectral_basis
    from pyfasst_jax.tf.stft import STFT

    objs = [AudioObject(p) for p in paths]
    n_ch = {o.channels for o in objs}
    if len(n_ch) != 1:
        raise ValueError("one batch must share a channel count (one "
                         f"compiled executable per shape); got {sorted(n_ch)}"
                         " -- split the directory by channel count")
    I = n_ch.pop()
    tfts = [STFT(wlen=wlen, fs=o.samplerate) for o in objs]
    Xs, scales = [], []
    for o, tft in zip(objs, tfts):
        X = tft.computeTransform(o.data.astype(np.float32))
        mean_pow = float(jnp.mean(jnp.abs(X) ** 2))
        scales.append(float(np.sqrt(max(mean_pow, 1e-30))))
        Xs.append(np.asarray(X) / scales[-1])
    F = wlen // 2 + 1

    fixed_FBs = [
        spectral_basis(freq_basis, n_bands, F, o.samplerate, wlen)
        if freq_basis in ("erb", "mel") else None for o in objs]

    def make_params(F_, Npad, i):
        keys = list(jax.random.split(jax.random.PRNGKey(seed + i), nbComps))
        spat = tuple(SpatialComp(A=a) for a in
                     init_inst_mixing(None, I, 1, nbComps))
        spec = tuple(
            init_nmf_comp(keys[j], F_, Npad, nbNMFComps, spat_ind=j,
                          fixed_FB=fixed_FBs[i])
            for j in range(nbComps))
        return FasstParams(spat=spat, spec=spec)

    cfg = GEMConfig(niter=int(iters))
    images, lls = batch_separate(Xs, make_params, cfg, mesh=mesh,
                                 granularity=granularity)

    os.makedirs(out_dir, exist_ok=True)
    report: Dict[str, Dict] = {}
    for p, o, tft, Y, ll, sc in zip(paths, objs, tfts, images, lls, scales):
        stem = os.path.splitext(os.path.basename(p))[0]
        files = []
        for j in range(Y.shape[0]):
            y = np.asarray(tft.invertTransform(
                Y[j], nsamples=o.nsamples)) * sc
            peak = np.max(np.abs(y))
            out = os.path.join(out_dir, f"{stem}_est_{j}.wav")
            AudioObject(data=y / peak if peak > 1.0 else y,
                        samplerate=o.samplerate)._write(out)
            files.append(out)
        report[stem] = {"files": files, "final_loglik": float(ll[-1])}
    return report
