"""Bounded-memory streaming separation of long recordings.

Capability parity with the FASST lineage's online variant (PAPERS.md
arXiv:1112.6178; SURVEY.md §5 long-context row), packaged as a pipeline:
the reference holds the whole (F, N) plane in memory (pyfasst has no
streaming path at all -- UNVERIFIED, mount empty); here estimation,
separation, AND synthesis run block-by-block so device memory stays
O(F x block_frames) regardless of recording length:

  pass 1   STFT.stream_blocks (native codec seek+read off disk) ->
           ops.online.online_block: exponential-forgetting GEM learns the
           frequency-side parameters (mixing A_j(f) -- rank-1 columns or,
           with spatial_rank=I, a full-rank spatial covariance
           R_j = A_j A_j^H re-estimated every block -- and spectral
           patterns FB_j).
  pass 2   re-stream; per block re-estimate the time weights TW under the
           FROZEN final parameters (the streaming-inference operating
           mode), Wiener-separate through the production
           ops.wiener.separate_sources path (cancellation-free masks),
           and emit time samples through tf.stft.StreamingSynthesis
           (exact WOLA with an overlap carry).

Host memory is O(output samples) only because the separated stems are
returned/written as whole arrays. Quality operating point (measured,
tools/validate_hw.py long-form row): blind online EM trails batch EM --
~6.7 dB exact-image min SDR / ~11 dB BSS-Eval-512 on a 120 s stereo
dense-band mixture. Any channel count: I == 2 rides the packed 2x2
fast path, other I the square-root general engine (ops/engine_general),
dispatched at trace time like the batch engine.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

__all__ = ["separate_streaming"]


def _save_stream_state(path: str, state, sigma, next_block: int, lls,
                       config: dict):
    """Atomic .npz checkpoint of the online state mid-stream (every
    leaf stored with its own dtype: `t4` is real in the rank-1 state and
    complex (R, R) blocks in the full-rank state).

    `config` records the run configuration (J/K/wlen/frames_per_block/
    spatial_rank/seed/forgetting + a file geometry fingerprint) so a
    resume with mismatched settings is REFUSED instead of silently
    corrupting the state (the batched path's paranoia,
    parallel/batch.py)."""
    import json

    arrays = {"next_block": np.asarray(next_block),
              "lls": np.asarray(lls, np.float64),
              "sigma": np.asarray(sigma),
              "config_json": np.asarray(json.dumps(config, sort_keys=True))}
    for name, val in state._asdict().items():
        arrays[name] = np.asarray(val)
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, **arrays)
    os.replace(tmp, path)


def _load_stream_state(path: str, expect_config: dict):
    """-> (OnlineState, sigma, next_block, lls list).

    Refuses to resume if the checkpoint's recorded configuration differs
    from `expect_config` (a stale / pre-config checkpoint also refuses:
    it cannot be validated). Mismatches are listed by key in the error."""
    import json

    import jax.numpy as jnp

    from pyfasst_jax.ops.online import OnlineState

    with np.load(path) as z:
        if "config_json" not in z:
            raise ValueError(
                f"streaming checkpoint {path!r} predates configuration "
                "stamping and cannot be validated for resume; delete it "
                "to restart estimation from scratch")
        saved = json.loads(str(z["config_json"]))
        diffs = [f"{k}: checkpoint={saved.get(k)!r} run={v!r}"
                 for k, v in expect_config.items() if saved.get(k) != v]
        if diffs:
            raise ValueError(
                f"streaming checkpoint {path!r} was written by a run with "
                "different configuration -- resuming would silently corrupt "
                "the online state. Mismatches: " + "; ".join(diffs)
                + ". Delete the checkpoint to restart, or rerun with the "
                "original settings.")
        fields = {}
        for name in OnlineState._fields:
            arr = z[name]
            fields[name] = jnp.asarray(arr)
        return (OnlineState(**fields), jnp.asarray(z["sigma"]),
                int(z["next_block"]), [float(v) for v in z["lls"]])


def _blind_prefix_init(tft, filename, Nb: int, J: int, K: int, R: int,
                       channels: int, init_seconds: float, fs: int,
                       seed: int, verbose: int):
    """Blind init from a bounded prefix of the recording (VERDICT r4
    item 9: compose streaming with the round-4 blind machinery).

    Reads ceil(init_seconds*fs / hop) frames of blocks (memory stays
    O(prefix)), then seeds the online state: stereo -> DEMIX anechoic
    direction estimates (global direction-space clustering; see inline
    comment for why the consensus-vote machinery is the WRONG tool here);
    mono -> mixture IS-NMF + envelope clustering
    (models/mono.nmf_cluster_init). Returns (A0_host or None, FB0 (J,F,K)
    np or None, valid (J,F) bool or None) -- None keeps the caller's
    random/default init for that part. All decision-feeding computation
    runs on HOST float64 (CLAUDE.md, "Precision")."""

    hop = tft.wlen // 2
    need_frames = max(int(np.ceil(init_seconds * fs / hop)), Nb)
    blocks = []
    got = 0
    for Xb in tft.stream_blocks(filename, Nb):
        blocks.append(np.asarray(Xb))
        got += blocks[-1].shape[1]
        if got >= need_frames:
            break
    X = np.concatenate(blocks, axis=1)                    # (F, Np, I)
    if verbose:
        print(f"blind prefix init: {X.shape[1]} frames "
              f"({X.shape[1] * hop / fs:.1f} s)")
    from pyfasst_jax.models.mono import nmf_cluster_init

    if channels == 1:
        groups = nmf_cluster_init(X[..., 0], J, K, seed=seed)
        FB0 = np.stack([g[0] * np.maximum(g[1].mean(1), 1e-12)
                        for g in groups])                  # scale into FB
        return None, FB0, None
    if channels != 2:
        # no DEMIX for I != 2: keep the caller's default init entirely
        return None, None, None

    # DEMIX on the prefix: GLOBAL clustering in direction space. The
    # consensus-vote machinery was measured to fail here -- its
    # per-frequency permutation alignment is envelope-based, and on
    # stationary material (dense-band noise, the long-form regime's
    # fixture) envelopes are flat, the alignment is coin-flip per f, and
    # the pooled per-source directions collapse onto the mixture's global
    # principal direction (-0.3 to -32 dB vs the default init; the TRUE
    # directions through the same plumbing score +39.7). DEMIX clusters
    # local directions over ALL bins at once, so no alignment exists to
    # fail, and stationarity is irrelevant.
    from pyfasst_jax.models.demix import DEMIX

    dmx = DEMIX(X=X)
    dmx.comp_pcafeatures()
    dmx.comp_parameters(J)
    Afull = dmx.mixing(X.shape[0])                    # (J, F, 2, 1) complex
    Acols = Afull[..., 0]                             # (J, F, 2)
    Acols = Acols / np.maximum(
        np.linalg.norm(Acols, axis=-1, keepdims=True), 1e-12)
    if R > 1:
        # rank expansion: orthogonal complement column at 0.2 scale
        # (variants.py recipe), per (j, f)
        orth = np.stack([-np.conj(Acols[..., 1]),
                         np.conj(Acols[..., 0])], -1)
        A = np.stack([Acols, 0.2 * orth], -1)         # (J, F, 2, 2)
    else:
        A = Acols[..., None]                          # (J, F, 2, 1)

    # SPECTRAL side: keep the random FB. Direction-masked IS-NMF
    # dictionaries were measured to TRAP the online spectral update on
    # the dense-band fixture (A-only 37.4 dB, A+FB 15.1, FB-only 3.0 vs
    # random-init 5.6): a structured-but-imperfect dictionary is harder
    # for the forgetting EM to reshape than a flat random start, while
    # the direction seed alone leaves the spectral side fully plastic.
    # (Mono has no direction evidence, so its nmf_cluster_init FB seed
    # stays -- measured +8 dB there, models/mono.py.)
    valid = np.ones((J, X.shape[0]), bool)
    return (A if R > 1 else A[..., 0]), None, valid


def separate_streaming(filename, J: int = 2, K: int = 8, wlen: int = 1024,
                       frames_per_block: int = 64, forgetting: float = 0.95,
                       inner_iters: int = 6, noise_rel: float = 1e-3,
                       seed: int = 0, out_dir: Optional[str] = None,
                       checkpoint_path: Optional[str] = None,
                       checkpoint_every: int = 0,
                       estimate_blocks: Optional[int] = None,
                       spatial_rank: int = 1,
                       init: str = "random", init_seconds: float = 12.0,
                       verbose: int = 1):
    """Two-pass blind streaming separation of a WAV on disk (any I).

    spatial_rank=1 (default) learns rank-1 mixing columns A_j(f) -- the
    low-latency point-source model. spatial_rank=I (or -1 for "the
    channel count, whatever the probe finds") learns a FULL-RANK
    spatial covariance per source (Duong model, R_j = A_j A_j^H
    re-estimated every block from the exponentially-forgotten statistics,
    ops/online.py rank-R path) -- the reverberant/diffuse streaming mode.
    The extra columns are seeded as small orthogonal perturbations of the
    rank-1 direction (same rank-expansion recipe as the batch variants) so
    they grow only if the data asks for them.

    Returns (ys (J, nsamples, I) float32 source images, info dict with
    block log-likelihoods and geometry). If out_dir is given, also writes
    stream_src_<j>.wav per source and puts the paths in info["files"].

    noise_rel sets the fixed noise-PSD floor relative to the first
    block's mean bin power (streaming has no global annealing schedule).

    checkpoint_path + checkpoint_every=K persist the online state every
    K estimation blocks (atomic .npz); if the file already exists the
    estimation RESUMES from it (skipped blocks are never read off disk
    -- stream_blocks(start_block=...)), so a preempted multi-hour
    estimation pass loses at most K blocks. The checkpoint stamps the
    run configuration (J/K/wlen/frames_per_block/spatial_rank/seed/
    forgetting + the file's frames/channels/samplerate); a resume whose
    settings differ RAISES instead of silently corrupting the state.
    estimate_blocks caps pass 1
    (learn from the first N blocks, then separate the WHOLE recording
    with the frozen parameters -- also the test hook for interruption).

    init="blind" seeds the online state from the first `init_seconds` of
    the recording before any online EM runs (stereo: DEMIX anechoic
    direction estimates -- measured +31.8 dB over the default-direction
    init on the dense-band streaming fixture; mono: mixture IS-NMF +
    envelope clustering spectral seed, models/mono.py). Memory stays
    bounded: only the prefix plane is materialized. init="random"
    (default) keeps the round-3 behavior. I >= 3 recordings keep the
    default init (DEMIX is a stereo estimator).
    """
    import jax.numpy as jnp

    from pyfasst_jax.audio import wavwrite
    from pyfasst_jax.models.components import (
        CONV, FasstParams, SpatialComp, SpectralComp, init_inst_mixing,
    )
    from pyfasst_jax.native import wavio
    from pyfasst_jax.ops.online import online_block, online_init
    from pyfasst_jax.ops.wiener import separate_sources
    from pyfasst_jax.tf.stft import STFT

    native = wavio()
    if native is not None:                    # header-only probe: do NOT
        wi = native.info(os.fspath(filename))  # load the whole recording
        fs, nsamples, channels = wi["samplerate"], wi["frames"], \
            wi["channels"]
    else:
        from pyfasst_jax.audio import wavread
        data, fs = wavread(filename)
        nsamples, channels = data.shape[0], data.shape[1]
        del data
    tft = STFT(wlen=wlen, fs=fs)
    F, Nb = tft.F, int(frames_per_block)

    R = int(spatial_rank)
    if R == -1:                          # "full": resolve after the probe
        R = channels
    if R not in (1, channels):
        raise ValueError(f"spatial_rank must be 1 (point sources), "
                         f"{channels} (= channels, full-rank Duong "
                         f"model), or -1 (full, any I), got {R}")
    dirs = [np.asarray(a)[:, 0].astype(np.float64)
            for a in init_inst_mixing(None, channels, 1, J)]
    if R == 1:
        A0 = jnp.stack([jnp.broadcast_to(
            jnp.asarray(d, jnp.float32).astype(jnp.complex64),
            (F, channels)) for d in dirs])
    else:
        # rank expansion: per source, Gram-Schmidt random columns
        # orthogonal to the seed direction, scaled 0.2 (variants.py recipe)
        # -- real-valued host init, uploaded as float then cast on device.
        rngA = np.random.default_rng(seed + 1)
        mats = []
        for d in dirs:
            basis = [d / np.linalg.norm(d)]
            cols = [d]
            for _ in range(R - 1):
                q = rngA.standard_normal(channels)
                for b in basis:
                    q = q - (b @ q) * b
                q = q / max(np.linalg.norm(q), 1e-12)
                basis.append(q)
                cols.append(0.2 * np.linalg.norm(d) * q)
            mats.append(np.stack(cols, axis=-1))          # (I, R)
        A0 = jnp.stack([jnp.broadcast_to(
            jnp.asarray(m, jnp.float32), (F, channels, R)
        ).astype(jnp.complex64) for m in mats])           # (J, F, I, R)
    rng = np.random.default_rng(seed)
    FB0 = jnp.asarray(0.5 + rng.random((J, F, K)), jnp.float32)
    TW0 = jnp.asarray(0.5 + rng.random((J, K, Nb)), jnp.float32)

    if init not in ("random", "blind"):
        raise ValueError(f"init must be 'random' or 'blind', got {init!r}")
    if init == "blind":
        import jax.numpy as jnp

        A_h, FB_h, valid = _blind_prefix_init(tft, filename, Nb, J, K, R,
                                              channels, init_seconds, fs,
                                              seed, verbose)
        if A_h is not None:
            # no-vote-mass frequencies keep the default direction
            seeds_h = mats if R > 1 else dirs     # (I, R) / (I,) per source
            A_default = np.stack([np.broadcast_to(
                np.asarray(s, np.complex64), A_h.shape[1:])
                for s in seeds_h])
            vmask = valid[:, :, None] if R == 1 \
                else valid[:, :, None, None]
            A_h = np.where(vmask, A_h, A_default)
            A0 = jnp.asarray(np.ascontiguousarray(A_h, np.complex64))
        if FB_h is not None:
            FB0 = jnp.asarray(np.maximum(FB_h, 1e-8), jnp.float32)

    # configuration fingerprint stamped into checkpoints; resume refuses a
    # mismatch (file identity = geometry: frames/channels/samplerate)
    ckpt_cfg = {"J": int(J), "K": int(K), "wlen": int(wlen),
                "frames_per_block": int(Nb), "spatial_rank": int(R),
                "init": str(init),
                "seed": int(seed), "forgetting": float(forgetting),
                "file_frames": int(nsamples), "file_channels": int(channels),
                "file_samplerate": int(fs)}

    state = online_init(A0, FB0)
    sigma = None
    lls_done = []
    start_block = 0
    if checkpoint_path is not None and os.path.exists(checkpoint_path):
        state, sigma, start_block, lls_done = \
            _load_stream_state(checkpoint_path, ckpt_cfg)
        if verbose:
            print(f"resumed streaming estimation at block {start_block}")
    lls = []
    n_full = start_block
    for Xb in tft.stream_blocks(filename, Nb,       # pass 1: learn A, FB
                                start_block=start_block):
        if sigma is None:
            sigma = jnp.full((F,), noise_rel * float(
                jnp.mean(jnp.abs(Xb) ** 2)), jnp.float32)
        if Xb.shape[1] < Nb:                         # ragged tail: skip in
            break                                    # estimation only
        state, (_, ll) = online_block(state, Xb, TW0, sigma,
                                      forgetting=forgetting,
                                      inner_iters=inner_iters)
        lls.append(ll)
        n_full += 1
        if checkpoint_path is not None and checkpoint_every \
                and (n_full - start_block) % checkpoint_every == 0:
            _save_stream_state(
                checkpoint_path, state, sigma, n_full,
                lls_done + [float(v) for v in np.asarray(jnp.stack(lls))],
                ckpt_cfg)
        if estimate_blocks is not None and n_full >= estimate_blocks:
            break
    if not (lls or lls_done):
        raise ValueError("recording shorter than one block; use the "
                         "batch path")
    if lls:                                          # one host fetch
        lls = [float(v) for v in np.asarray(jnp.stack(lls))]
    lls = lls_done + lls

    def sep_block(TWb, Xb):
        spat = tuple(SpatialComp(
            A=state.A[j][..., None] if state.A.ndim == 3 else state.A[j],
            mix_type=CONV) for j in range(J))
        spec = tuple(SpectralComp(FB=state.FB[j], TW=TWb[j], spat_ind=j)
                     for j in range(J))
        return separate_sources(FasstParams(spat=spat, spec=spec),
                                Xb, sigma)

    syns = [tft.synthesis_stream(nsamples) for _ in range(J)]
    ys = np.zeros((J, nsamples, channels), np.float32)
    pos = [0] * J
    for Xb in tft.stream_blocks(filename, Nb):       # pass 2: frozen params
        nb = Xb.shape[1]
        if nb < Nb:                                  # pad the ragged tail
            import jax.numpy as jnp
            Xb = jnp.concatenate(
                [Xb, jnp.zeros((F, Nb - nb, channels), Xb.dtype)], axis=1)
        _, (TWb, _) = online_block(state, Xb, TW0, sigma,
                                   forgetting=forgetting,
                                   inner_iters=inner_iters)
        Y = sep_block(TWb, Xb)[:, :, :nb]
        for j in range(J):
            chunk = syns[j].push(Y[j])
            ys[j, pos[j]:pos[j] + chunk.shape[0]] = chunk
            pos[j] += chunk.shape[0]
    for j in range(J):
        chunk = syns[j].flush()
        ys[j, pos[j]:pos[j] + chunk.shape[0]] = chunk
        pos[j] += chunk.shape[0]

    out = {"fs": fs, "nsamples": nsamples, "blocks": n_full,
           "block_frames": Nb, "logliks": lls, "resumed_at": start_block,
           "spatial_rank": R}
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        paths = []
        for j in range(J):
            p = os.path.join(out_dir, f"stream_src_{j}.wav")
            wavwrite(ys[j], fs, p)
            paths.append(p)
        out["files"] = paths
    if verbose:
        print(f"streamed {n_full} blocks of {Nb} frames; "
              f"loglik {lls[0]:.1f} -> {lls[-1]:.1f}")
    return ys, out
