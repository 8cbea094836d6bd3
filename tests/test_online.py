"""Online / streaming GEM tests (PAPERS.md arXiv:1112.6178 capability)."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from pyfasst_jax.ops.online import run_gem_online


def _panned_problem(rng, F=49, N=160, J=2):
    bands = [(3, 16), (26, 42)]
    dirs = [np.array([0.95, 0.31]), np.array([0.31, 0.95])]
    Y_true, X = [], 0.0
    for j in range(J):
        lo, hi = bands[j]
        s = np.zeros((F, N), complex)
        s[lo:hi] = (rng.standard_normal((hi - lo, N))
                    + 1j * rng.standard_normal((hi - lo, N)))
        img = dirs[j][None, None, :] * s[..., None]
        Y_true.append(img)
        X = X + img
    return jnp.asarray(X, jnp.complex64), np.stack(Y_true), dirs


def test_online_gem_runs_and_learns_directions(rng):
    X, Y_true, dirs = _panned_problem(rng)
    F, N = X.shape[:2]
    J, K = 2, 3
    n_blocks, Nb = 8, N // 8
    A0 = jnp.asarray(np.stack([
        np.array([[0.87], [0.49]]) @ np.ones((1, 1)),
        np.array([[0.52], [0.91]]) @ np.ones((1, 1))])[..., 0],
        jnp.complex64)                                    # (J, F?) fix below
    A0 = jnp.broadcast_to(A0[:, None, :], (J, F, 2)).astype(jnp.complex64)
    FB0 = jnp.asarray(0.5 + rng.random((J, F, K)), jnp.float32)
    TW0 = jnp.asarray(0.5 + rng.random((J, K, Nb)), jnp.float32)
    sigma = jnp.full((F,), 1e-3, jnp.float32)

    A, FB, TW_all, logliks = jax.block_until_ready(run_gem_online(
        A0, FB0, TW0, X, sigma, n_blocks=n_blocks, forgetting=0.9,
        inner_iters=6))
    logliks = np.asarray(logliks)
    assert np.all(np.isfinite(logliks))
    assert TW_all.shape == (J, K, N)
    # later blocks should fit better than the first (params adapt)
    assert logliks[-1] > logliks[0]

    # learned directions align with the true panning (up to scale/phase)
    A = np.asarray(A)
    for j in range(2):
        a = A[j].mean(axis=0)
        a = np.abs(a) / np.linalg.norm(a)
        cors = [abs(a @ (d / np.linalg.norm(d))) for d in dirs]
        assert max(cors) > 0.95, (j, a, cors)


def test_online_gated_narrowband_stays_finite(rng):
    """Round-4 regression: a gated noise source mixed with a narrowband
    harmonic tone diverged the rank-1 online EM (the gain degeneracy
    |A|^2 v drifted across blocks with no inter-factor renormalization:
    A hit 7e13 by block ~22, the FB accumulators overflowed, everything
    NaNed). 30+ blocks must stay finite and keep |A_j(f)| = 1."""
    fs, n = 16000, 16000 * 8
    t = np.arange(n) / fs
    s1 = (0.4 * np.sin(2 * np.pi * (200 * t + 3 * np.sin(2 * np.pi * 0.5 * t)))
          + 0.2 * np.sin(2 * np.pi * 400 * t))
    env = (np.sin(2 * np.pi * 1.3 * t) > 0).astype(np.float64)
    s2 = 0.3 * rng.standard_normal(n) * env
    mix = np.outer(s1, [0.95, 0.31]) + np.outer(s2, [0.31, 0.95])
    mix = (mix / (np.max(np.abs(mix)) * 1.05)).astype(np.float32)

    from pyfasst_jax.tf.stft import _stft_core, sine_window
    wlen, hop = 512, 256
    window = jnp.asarray(sine_window(wlen), jnp.float32)
    X = _stft_core(jnp.asarray(mix), window, wlen, hop, "fft")
    F = X.shape[0]
    J, K, Nb = 2, 4, 16
    n_blocks = int(X.shape[1]) // Nb
    assert n_blocks >= 30
    dirs = [np.array([0.95, 0.31]), np.array([0.31, 0.95])]
    A0 = jnp.stack([jnp.broadcast_to(
        jnp.asarray(d, jnp.float32).astype(jnp.complex64), (F, 2))
        for d in dirs])
    FB0 = jnp.asarray(0.5 + rng.random((J, F, K)), jnp.float32)
    TW0 = jnp.asarray(0.5 + rng.random((J, K, Nb)), jnp.float32)
    sigma = jnp.full((F,), 1e-3 * float(jnp.mean(jnp.abs(X) ** 2)),
                     jnp.float32)
    A, FB, TW_all, logliks = jax.block_until_ready(run_gem_online(
        A0, FB0, TW0, X[:, :n_blocks * Nb], sigma, n_blocks=n_blocks,
        forgetting=0.95, inner_iters=6))
    assert np.all(np.isfinite(np.asarray(logliks)))
    assert np.all(np.isfinite(np.asarray(jnp.abs(A))))
    assert np.all(np.isfinite(np.asarray(FB))) and float(jnp.min(FB)) > 0
    # inter-factor renormalization holds the column norms at 1
    norms = np.asarray(jnp.sum(jnp.abs(A) ** 2, axis=-1))
    np.testing.assert_allclose(norms, 1.0, atol=1e-3)


def test_online_spectral_patterns_localize(rng):
    X, Y_true, dirs = _panned_problem(rng)
    F, N = X.shape[:2]
    J, K = 2, 3
    n_blocks, Nb = 8, N // 8
    A0 = jnp.broadcast_to(jnp.asarray(
        np.stack([[0.87, 0.49], [0.52, 0.91]]), jnp.complex64)[:, None, :],
        (J, F, 2))
    FB0 = jnp.asarray(0.5 + rng.random((J, F, K)), jnp.float32)
    TW0 = jnp.asarray(0.5 + rng.random((J, K, Nb)), jnp.float32)
    sigma = jnp.full((F,), 1e-3, jnp.float32)
    A, FB, TW_all, ll = jax.block_until_ready(run_gem_online(
        A0, FB0, TW0, X, sigma, n_blocks=n_blocks, inner_iters=6))
    FB = np.asarray(FB)
    # each source's learned spectral energy should concentrate in its band
    e0_band0 = FB[0, 3:16].sum() / FB[0].sum()
    e1_band1 = FB[1, 26:42].sum() / FB[1].sum()
    # permutation-tolerant check
    e0_band1 = FB[0, 26:42].sum() / FB[0].sum()
    e1_band0 = FB[1, 3:16].sum() / FB[1].sum()
    straight = min(e0_band0, e1_band1)
    flipped = min(e0_band1, e1_band0)
    assert max(straight, flipped) > 0.6, (straight, flipped)


def test_stream_blocks_bit_identical_to_full_stft(rng, tmp_path):
    """STFT.stream_blocks must reproduce the whole-file transform exactly
    (same framing/window/DFT code path, block-paged reads)."""
    from pyfasst_jax.audio import wavwrite
    from pyfasst_jax.tf.stft import STFT

    fs, n = 8000, 8000 + 123          # deliberately not frame-aligned
    mix = np.clip(0.4 * rng.standard_normal((n, 2)), -1, 1)
    p = str(tmp_path / "long.wav")
    wavwrite(mix, fs, p)

    st = STFT(wlen=256, fs=fs)
    from pyfasst_jax.audio import wavread
    full = st.computeTransform(wavread(p)[0].astype(np.float32))
    blocks = list(st.stream_blocks(p, frames_per_block=7))
    streamed = jnp.concatenate(blocks, axis=1)
    assert streamed.shape == full.shape
    np.testing.assert_array_equal(np.asarray(jnp.real(streamed)),
                                  np.asarray(jnp.real(full)))
    np.testing.assert_array_equal(np.asarray(jnp.imag(streamed)),
                                  np.asarray(jnp.imag(full)))


def test_streaming_synthesis_matches_istft(rng):
    """StreamingSynthesis (block-wise WOLA with overlap carries) must
    reproduce the whole-plane inverse to float rounding, for mono and
    stereo, including a ragged final block."""
    from pyfasst_jax.tf.stft import STFT

    # default hop (k=2 overlap), k=4 overlap, and single-frame blocks
    # (blocks shorter than the overlap depth roll through the carry)
    for shape, wlen, hop, bs in [((3 * 8000 + 321, 2), 256, None, 7),
                                 ((5000,), 512, None, 16),
                                 ((9000, 2), 256, 64, 5),
                                 ((9000,), 512, 128, 1)]:
        n = shape[0]
        st = STFT(wlen=wlen, hop=hop, fs=8000)
        x = rng.standard_normal(shape).astype(np.float32)
        X = st.computeTransform(x)
        ref = np.asarray(st.invertTransform(X, nsamples=n))
        syn = st.synthesis_stream(n)
        outs = [syn.push(X[:, m0:m0 + bs])
                for m0 in range(0, X.shape[1], bs)]
        outs.append(syn.flush())
        y = np.concatenate([o for o in outs if o.size], axis=0)
        assert y.shape == ref.shape
        np.testing.assert_allclose(y, ref, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(y, x, rtol=1e-4, atol=1e-4)


def test_separate_streaming_end_to_end(rng, tmp_path):
    """The full bounded-memory pipeline (models/streaming.py): WAV on
    disk -> block-paged online GEM -> frozen-params per-block Wiener ->
    streamed synthesis -> stems. Fully blind; must clearly beat the
    mixture-as-estimate baseline (0 dB) on a dense-band stereo mixture."""
    from scipy.signal import butter, lfilter

    from pyfasst_jax.audio import wavwrite
    from pyfasst_jax.models.streaming import separate_streaming

    fs, dur = 8000, 16.0
    n = int(fs * dur)

    def band(lo, hi):
        b, a = butter(4, [lo, hi], btype="band")
        s = lfilter(b, a, rng.standard_normal(n))
        return s / (np.std(s) + 1e-9)

    s1, s2 = band(0.02, 0.3), band(0.25, 0.8)
    A = np.array([[0.95, 0.31], [0.31, 0.95]])
    ys_true = np.stack([np.outer(s1, A[:, 0]), np.outer(s2, A[:, 1])])
    mix = ys_true.sum(0)
    sc = np.max(np.abs(mix)) * 1.05
    mix, ys_true = mix / sc, ys_true / sc
    p = str(tmp_path / "long.wav")
    wavwrite(mix, fs, p)

    ys, info = separate_streaming(p, J=2, K=6, wlen=512,
                                  frames_per_block=32, verbose=0,
                                  out_dir=str(tmp_path / "out"))
    assert ys.shape == (2, n, 2) and np.all(np.isfinite(ys))
    assert info["blocks"] >= 10
    assert all(np.isfinite(v) for v in info["logliks"])
    import os
    assert all(os.path.exists(f) for f in info["files"])

    def sdr(a, b):
        return 10 * np.log10(np.sum(b ** 2)
                             / max(np.sum((a - b) ** 2), 1e-12))

    best = max(min(sdr(ys[0], ys_true[0]), sdr(ys[1], ys_true[1])),
               min(sdr(ys[1], ys_true[0]), sdr(ys[0], ys_true[1])))
    assert best > 3.0, best          # measured ~5.7 on this fixture
    # conservation: Wiener images + noise floor ~= mixture
    assert np.max(np.abs(ys.sum(0) - mix)) < 0.05


def test_separate_streaming_checkpoint_resume(rng, tmp_path):
    """A preempted streaming estimation resumes from its checkpoint to
    the same result as an uninterrupted run (state round-trips through
    the atomic .npz exactly; skipped blocks are never re-read)."""
    import os

    from scipy.signal import butter, lfilter

    from pyfasst_jax.audio import wavwrite
    from pyfasst_jax.models.streaming import separate_streaming

    fs, n = 8000, 8000 * 10
    b, a = butter(4, [0.02, 0.3], btype="band")
    s1 = lfilter(b, a, rng.standard_normal(n))
    b, a = butter(4, [0.25, 0.8], btype="band")
    s2 = lfilter(b, a, rng.standard_normal(n))
    mix = np.outer(s1, [0.95, 0.31]) + np.outer(s2, [0.31, 0.95])
    mix /= np.max(np.abs(mix)) * 1.05
    p = str(tmp_path / "ck.wav")
    wavwrite(mix, fs, p)
    kw = dict(J=2, K=4, wlen=512, frames_per_block=16, verbose=0)

    ys_c, info_c = separate_streaming(p, **kw)       # uninterrupted
    ck = str(tmp_path / "stream_ck.npz")
    _, info_i = separate_streaming(p, checkpoint_path=ck,
                                   checkpoint_every=5, estimate_blocks=5,
                                   **kw)             # "preempted" at 5
    assert os.path.exists(ck) and info_i["blocks"] == 5
    ys_r, info_r = separate_streaming(p, checkpoint_path=ck,
                                      checkpoint_every=5, **kw)
    assert info_r["resumed_at"] == 5
    assert info_r["blocks"] == info_c["blocks"]
    np.testing.assert_allclose(info_r["logliks"], info_c["logliks"],
                               rtol=1e-5)
    np.testing.assert_allclose(ys_r, ys_c, rtol=1e-4, atol=1e-5)


def test_separate_streaming_resume_config_mismatch(rng, tmp_path):
    """A resume with configuration different from the one that wrote the
    checkpoint must RAISE naming the mismatched keys (silent corruption
    guard, matching parallel/batch.py's membership validation), and a
    checkpoint without a config stamp must refuse too."""
    import pytest
    from scipy.signal import butter, lfilter

    from pyfasst_jax.audio import wavwrite
    from pyfasst_jax.models.streaming import separate_streaming

    fs, n = 8000, 8000 * 6
    b, a = butter(4, [0.02, 0.3], btype="band")
    s1 = lfilter(b, a, rng.standard_normal(n))
    b, a = butter(4, [0.25, 0.8], btype="band")
    s2 = lfilter(b, a, rng.standard_normal(n))
    mix = np.outer(s1, [0.95, 0.31]) + np.outer(s2, [0.31, 0.95])
    mix /= np.max(np.abs(mix)) * 1.05
    p = str(tmp_path / "cfg.wav")
    wavwrite(mix, fs, p)
    ck = str(tmp_path / "stream_cfg.npz")
    separate_streaming(p, J=2, K=4, wlen=512, frames_per_block=16,
                       checkpoint_path=ck, checkpoint_every=3,
                       estimate_blocks=3, verbose=0)

    # wlen mismatch
    with pytest.raises(ValueError, match="wlen"):
        separate_streaming(p, J=2, K=4, wlen=1024, frames_per_block=16,
                           checkpoint_path=ck, verbose=0)
    # frames_per_block mismatch
    with pytest.raises(ValueError, match="frames_per_block"):
        separate_streaming(p, J=2, K=4, wlen=512, frames_per_block=32,
                           checkpoint_path=ck, verbose=0)
    # spatial_rank mismatch
    with pytest.raises(ValueError, match="spatial_rank"):
        separate_streaming(p, J=2, K=4, wlen=512, frames_per_block=16,
                           spatial_rank=2, checkpoint_path=ck, verbose=0)
    # different file (geometry fingerprint): shorter recording
    p2 = str(tmp_path / "cfg2.wav")
    wavwrite(mix[: n // 2], fs, p2)
    with pytest.raises(ValueError, match="file_frames"):
        separate_streaming(p2, J=2, K=4, wlen=512, frames_per_block=16,
                           checkpoint_path=ck, verbose=0)
    # un-stamped (legacy) checkpoint refuses rather than guessing
    with np.load(ck) as z:
        legacy = {k: z[k] for k in z.files if k != "config_json"}
    ck2 = str(tmp_path / "legacy.npz")
    np.savez(ck2, **legacy)
    with pytest.raises(ValueError, match="cannot be validated"):
        separate_streaming(p, J=2, K=4, wlen=512, frames_per_block=16,
                           checkpoint_path=ck2, verbose=0)
    # and the matching configuration still resumes fine
    _, info = separate_streaming(p, J=2, K=4, wlen=512,
                                 frames_per_block=16,
                                 checkpoint_path=ck, verbose=0)
    assert info["resumed_at"] == 3


def test_separate_streaming_three_channels(rng, tmp_path):
    """The streaming pipeline through the square-root general engine
    (I != 2 trace-time dispatch in ops/online._block_estep)."""
    from scipy.signal import butter, lfilter

    from pyfasst_jax.audio import wavwrite
    from pyfasst_jax.models.streaming import separate_streaming

    fs, dur = 8000, 12.0
    n = int(fs * dur)

    def band(lo, hi):
        b, a = butter(4, [lo, hi], btype="band")
        s = lfilter(b, a, rng.standard_normal(n))
        return s / (np.std(s) + 1e-9)

    s1, s2 = band(0.02, 0.3), band(0.25, 0.8)
    A = np.array([[0.9, 0.2], [0.45, 0.6], [0.2, 0.95]])   # (I=3, J=2)
    ys_true = np.stack([np.outer(s1, A[:, 0]), np.outer(s2, A[:, 1])])
    mix = ys_true.sum(0)
    sc = np.max(np.abs(mix)) * 1.05
    mix, ys_true = mix / sc, ys_true / sc
    p = str(tmp_path / "long3.wav")
    wavwrite(mix, fs, p)

    ys, info = separate_streaming(p, J=2, K=6, wlen=512,
                                  frames_per_block=32, verbose=0)
    assert ys.shape == (2, n, 3) and np.all(np.isfinite(ys))

    def sdr(a, b):
        return 10 * np.log10(np.sum(b ** 2)
                             / max(np.sum((a - b) ** 2), 1e-12))

    best = max(min(sdr(ys[0], ys_true[0]), sdr(ys[1], ys_true[1])),
               min(sdr(ys[1], ys_true[0]), sdr(ys[0], ys_true[1])))
    assert best > 3.0, best          # measured ~8.6 at 16 s on this family
    assert np.max(np.abs(ys.sum(0) - mix)) < 0.08


def test_online_block_matches_scanned_run(rng):
    """Host-driven online_block carries must equal run_gem_online's scan
    (shared body)."""
    from pyfasst_jax.ops.online import (
        online_block, online_init, run_gem_online,
    )

    J, F, K, Nb, nb = 2, 17, 3, 16, 4
    X = jnp.asarray(rng.standard_normal((F, nb * Nb, 2))
                    + 1j * rng.standard_normal((F, nb * Nb, 2)),
                    jnp.complex64)
    A0 = jnp.asarray(0.4 + rng.random((J, F, 2)), jnp.float32
                     ).astype(jnp.complex64)
    FB0 = jnp.asarray(0.5 + rng.random((J, F, K)), jnp.float32)
    TW0 = jnp.asarray(0.5 + rng.random((J, K, Nb)), jnp.float32)
    sigma = jnp.full((F,), 0.01, jnp.float32)

    A_ref, FB_ref, TW_ref, ll_ref = run_gem_online(A0, FB0, TW0, X, sigma,
                                                   n_blocks=nb)
    state = online_init(A0, FB0)
    tws, lls = [], []
    for b in range(nb):
        Xb = X[:, b * Nb:(b + 1) * Nb]
        state, (TWb, ll) = online_block(state, Xb, TW0, sigma)
        tws.append(TWb)
        lls.append(float(ll))
    np.testing.assert_allclose(np.asarray(state.A), np.asarray(A_ref),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(state.FB), np.asarray(FB_ref),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(
        np.asarray(jnp.concatenate(tws, axis=-1)), np.asarray(TW_ref),
        rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(lls, np.asarray(ll_ref), rtol=1e-5)


def test_online_block_matches_scanned_run_three_channels(rng):
    """Same equality through the general-engine dispatch (I != 2)."""
    from pyfasst_jax.ops.online import (
        online_block, online_init, run_gem_online,
    )

    J, F, K, Nb, nb, I = 2, 9, 3, 12, 3, 3
    X = jnp.asarray(rng.standard_normal((F, nb * Nb, I))
                    + 1j * rng.standard_normal((F, nb * Nb, I)),
                    jnp.complex64)
    A0 = jnp.asarray(0.4 + rng.random((J, F, I)), jnp.float32
                     ).astype(jnp.complex64)
    FB0 = jnp.asarray(0.5 + rng.random((J, F, K)), jnp.float32)
    TW0 = jnp.asarray(0.5 + rng.random((J, K, Nb)), jnp.float32)
    sigma = jnp.full((F,), 0.01, jnp.float32)

    A_ref, FB_ref, TW_ref, ll_ref = run_gem_online(A0, FB0, TW0, X, sigma,
                                                   n_blocks=nb)
    assert np.all(np.isfinite(np.asarray(ll_ref)))
    state = online_init(A0, FB0)
    for b in range(nb):
        state, (TWb, ll) = online_block(state, X[:, b * Nb:(b + 1) * Nb],
                                        TW0, sigma)
    np.testing.assert_allclose(np.asarray(state.A), np.asarray(A_ref),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(state.FB), np.asarray(FB_ref),
                               rtol=1e-4, atol=1e-6)


# -- full-rank (Duong) streaming path -----------------------------------------

def test_online_fullrank_covariance_recovery(rng):
    """A0 (J, F, I, I) dispatches the Duong covariance path
    (ops/online._fullrank_block_step): a single full-rank source's
    spatial covariance is recovered (the direct covariance M-step
    converges in O(1) blocks at the noise floor, unlike the sub-source
    A-form EM whose step size vanishes with sigma)."""
    from pyfasst_jax.ops.online import run_gem_online

    F, N, I, K = 17, 256, 2, 2
    M = rng.standard_normal((I, I)) + 1j * rng.standard_normal((I, I))
    q, _ = np.linalg.qr(M)
    Atrue = q @ np.diag([1.0, 0.5])
    s = (rng.standard_normal((F, N, I))
         + 1j * rng.standard_normal((F, N, I))) / np.sqrt(2)
    X = jnp.asarray(np.einsum("fna,ba->fnb", s, Atrue), jnp.complex64)
    Rtrue = Atrue @ Atrue.conj().T
    Rtrue = Rtrue / np.trace(Rtrue).real

    A0 = np.zeros((1, F, I, I), np.complex64)
    A0[0, :, :, 0] = np.array([0.8, 0.6])
    A0[0, :, :, 1] = 0.2 * np.array([-0.6, 0.8])
    FB0 = jnp.asarray(0.5 + rng.random((1, F, K)), jnp.float32)
    Nb = 16
    TW0 = jnp.asarray(0.5 + rng.random((1, K, Nb)), jnp.float32)
    sigma = jnp.full((F,), 1e-3, jnp.float32)

    A, FB, TW, lls = jax.block_until_ready(run_gem_online(
        jnp.asarray(A0), FB0, TW0, X, sigma, n_blocks=N // Nb,
        forgetting=0.9, inner_iters=6))
    assert np.all(np.isfinite(np.asarray(lls)))
    A = np.asarray(A)
    errs = []
    for f in range(F):
        Rhat = A[0, f] @ A[0, f].conj().T
        Rhat = Rhat / max(np.trace(Rhat).real, 1e-30)
        errs.append(np.abs(Rhat - Rtrue).max())
    assert np.mean(errs) < 0.1, np.mean(errs)   # measured ~0.027


def test_online_fullrank_block_matches_scanned_run(rng):
    """Host-driven online_block equals run_gem_online's scan on the
    full-rank path (shared _fullrank_block_step body)."""
    from pyfasst_jax.ops.online import (
        online_block, online_init, run_gem_online,
    )

    J, F, K, Nb, nb, I = 2, 9, 3, 12, 4, 2
    X = jnp.asarray(rng.standard_normal((F, nb * Nb, I))
                    + 1j * rng.standard_normal((F, nb * Nb, I)),
                    jnp.complex64)
    A0 = np.zeros((J, F, I, I), np.float32)
    A0[..., 0] = 0.4 + rng.random((J, F, I))
    A0[..., 1] = 0.1 * rng.random((J, F, I))
    A0 = jnp.asarray(A0).astype(jnp.complex64)
    FB0 = jnp.asarray(0.5 + rng.random((J, F, K)), jnp.float32)
    TW0 = jnp.asarray(0.5 + rng.random((J, K, Nb)), jnp.float32)
    sigma = jnp.full((F,), 0.01, jnp.float32)

    A_ref, FB_ref, TW_ref, ll_ref = run_gem_online(A0, FB0, TW0, X, sigma,
                                                   n_blocks=nb)
    assert np.all(np.isfinite(np.asarray(ll_ref)))
    state = online_init(A0, FB0)
    lls = []
    for b in range(nb):
        state, (TWb, ll) = online_block(state, X[:, b * Nb:(b + 1) * Nb],
                                        TW0, sigma)
        lls.append(float(ll))
    np.testing.assert_allclose(np.asarray(state.A), np.asarray(A_ref),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(state.FB), np.asarray(FB_ref),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(lls, np.asarray(ll_ref), rtol=1e-5)


def test_online_fullrank_rejects_nonsquare_rank(rng):
    from pyfasst_jax.ops.online import online_init

    A0 = jnp.asarray(np.ones((2, 5, 3, 2), np.complex64))
    FB0 = jnp.asarray(np.ones((2, 5, 4), np.float32))
    import pytest
    with pytest.raises(ValueError, match="R == I"):
        online_init(A0, FB0)


def test_online_fullrank_beats_rank1_on_diffuse(rng):
    """On a mixture of genuinely FULL-RANK sources (per-bin covariance of
    rank 2), the Duong streaming path must clearly beat the rank-1
    streaming model -- the capability the full-rank mode exists for."""
    import itertools

    from pyfasst_jax.models.components import (
        CONV, FasstParams, SpatialComp, SpectralComp,
    )
    from pyfasst_jax.ops.online import online_block, online_init, \
        run_gem_online
    from pyfasst_jax.ops.wiener import separate_sources

    F, N, J, K, I = 33, 256, 2, 3, 2
    As = []
    for j in range(J):
        M = rng.standard_normal((I, I)) + 1j * rng.standard_normal((I, I))
        q, _ = np.linalg.qr(M)
        As.append(q @ np.diag([1.0, 0.5]))
    bands = [(2, 14), (18, 30)]
    Y = np.zeros((J, F, N, I), complex)
    for j, (lo, hi) in enumerate(bands):
        s = (rng.standard_normal((F, N, I))
             + 1j * rng.standard_normal((F, N, I))) / np.sqrt(2)
        mask = np.zeros((F, 1, 1))
        mask[lo:hi] = 1.0
        Y[j] = mask * np.einsum("fna,ba->fnb", s, As[j])
    X = jnp.asarray(Y.sum(0), jnp.complex64)

    d0 = [np.array([0.9, 0.45]), np.array([0.45, 0.9])]
    FB0 = jnp.asarray(0.5 + rng.random((J, F, K)), jnp.float32)
    Nb = 16
    TW0 = jnp.asarray(0.5 + rng.random((J, K, Nb)), jnp.float32)
    sigma = jnp.full((F,), 1e-3, jnp.float32)

    def two_pass(A0):
        """Learn on pass 1, separate with frozen params on pass 2 --
        the separate_streaming operating mode, in-memory."""
        Agot, FBgot, _, _ = jax.block_until_ready(run_gem_online(
            A0, FB0, TW0, X, sigma, n_blocks=N // Nb, forgetting=0.92,
            inner_iters=6))
        state = online_init(Agot, FBgot)
        Yh = np.zeros((J, F, N, I), np.complex64)
        for b in range(N // Nb):
            Xb = X[:, b * Nb:(b + 1) * Nb]
            _, (TWb, _) = online_block(state, Xb, TW0, sigma,
                                       forgetting=0.92, inner_iters=6)
            spat = tuple(SpatialComp(
                A=Agot[j][..., None] if Agot.ndim == 3 else Agot[j],
                mix_type=CONV) for j in range(J))
            spec = tuple(SpectralComp(FB=FBgot[j], TW=TWb[j], spat_ind=j)
                         for j in range(J))
            Yh[:, :, b * Nb:(b + 1) * Nb] = np.asarray(separate_sources(
                FasstParams(spat=spat, spec=spec), Xb, sigma))
        return Yh

    def min_sdr(Yhat):
        best = None
        for p in itertools.permutations(range(J)):
            sdrs = [10 * np.log10(
                (np.abs(Y[j]) ** 2).sum()
                / max((np.abs(Yhat[p[j]] - Y[j]) ** 2).sum(), 1e-30))
                for j in range(J)]
            if best is None or min(sdrs) > best:
                best = min(sdrs)
        return best

    A0r1 = jnp.asarray(np.stack(
        [np.tile(d / np.linalg.norm(d), (F, 1)) for d in d0]),
        jnp.complex64)
    sdr_r1 = min_sdr(two_pass(A0r1))

    A0fr = np.zeros((J, F, I, I), np.complex64)
    for j in range(J):
        d = d0[j] / np.linalg.norm(d0[j])
        A0fr[j, :, :, 0] = d
        A0fr[j, :, :, 1] = 0.2 * np.array([-d[1], d[0]])
    sdr_fr = min_sdr(two_pass(jnp.asarray(A0fr)))

    # measured: rank-1 -2.8 dB, full-rank +1.3 dB on this fixture
    assert sdr_fr > sdr_r1 + 2.0, (sdr_r1, sdr_fr)
    assert sdr_fr > 0.0, sdr_fr


def test_separate_streaming_fullrank(rng, tmp_path):
    """End-to-end bounded-memory pipeline in full-rank mode
    (spatial_rank=2 / -1), on a time-domain mixture whose sources are
    rank-2 per bin (two decorrelated sub-channels each); includes a
    checkpoint/resume cycle of the full-rank state (complex Duong
    accumulator + real count round-trip through the dtype-driven .npz)."""
    import os

    from scipy.signal import butter, lfilter

    from pyfasst_jax.audio import wavwrite
    from pyfasst_jax.models.streaming import separate_streaming

    fs, dur = 8000, 12.0
    n = int(fs * dur)

    def band(lo, hi):
        b, a = butter(4, [lo, hi], btype="band")
        s = lfilter(b, a, rng.standard_normal(n))
        return s / (np.std(s) + 1e-9)

    # each source = two independent same-band signals with different
    # panning => per-bin spatial covariance of rank 2 (diffuse source)
    pans = [(np.array([0.95, 0.31]), np.array([0.6, -0.5])),
            (np.array([0.31, 0.95]), np.array([-0.5, 0.6]))]
    specs = [(0.02, 0.3), (0.25, 0.8)]
    ys_true = []
    for (a1, a2), (lo, hi) in zip(pans, specs):
        u1, u2 = band(lo, hi), band(lo, hi)
        ys_true.append(np.outer(u1, a1) + 0.6 * np.outer(u2, a2))
    ys_true = np.stack(ys_true)
    mix = ys_true.sum(0)
    sc = np.max(np.abs(mix)) * 1.05
    mix, ys_true = mix / sc, ys_true / sc
    p = str(tmp_path / "fr.wav")
    wavwrite(mix, fs, p)
    kw = dict(J=2, K=6, wlen=512, frames_per_block=32, verbose=0)

    ys, info = separate_streaming(p, spatial_rank=-1, **kw)
    assert info["spatial_rank"] == 2
    assert ys.shape == (2, n, 2) and np.all(np.isfinite(ys))

    def sdr(a, b):
        return 10 * np.log10(np.sum(b ** 2)
                             / max(np.sum((a - b) ** 2), 1e-12))

    best = max(min(sdr(ys[0], ys_true[0]), sdr(ys[1], ys_true[1])),
               min(sdr(ys[1], ys_true[0]), sdr(ys[0], ys_true[1])))
    ys_r1, _ = separate_streaming(p, spatial_rank=1, **kw)
    best_r1 = max(
        min(sdr(ys_r1[0], ys_true[0]), sdr(ys_r1[1], ys_true[1])),
        min(sdr(ys_r1[1], ys_true[0]), sdr(ys_r1[0], ys_true[1])))
    assert best > best_r1, (best, best_r1)
    assert best > 2.0, best
    assert np.max(np.abs(ys.sum(0) - mix)) < 0.08

    # checkpoint/resume equality in full-rank mode
    ck = str(tmp_path / "fr_ck.npz")
    _, info_i = separate_streaming(p, checkpoint_path=ck,
                                   checkpoint_every=4, estimate_blocks=4,
                                   spatial_rank=2, **kw)
    assert os.path.exists(ck) and info_i["blocks"] == 4
    ys_r, info_r = separate_streaming(p, checkpoint_path=ck,
                                      checkpoint_every=4, spatial_rank=2,
                                      **kw)
    assert info_r["resumed_at"] == 4
    np.testing.assert_allclose(info_r["logliks"], info["logliks"],
                               rtol=1e-5)
    np.testing.assert_allclose(ys_r, ys, rtol=1e-4, atol=1e-5)


def test_separate_streaming_blind_init(rng, tmp_path):
    """init='blind' (VERDICT r4 item 9): the prefix-estimated consensus
    spatial-cluster + vote-masked-NMF init must run end to end and not
    lose to the random init on a panned stereo mixture."""
    from scipy.signal import butter, lfilter

    from pyfasst_jax.audio import wavwrite
    from pyfasst_jax.models.streaming import separate_streaming

    fs, dur = 8000, 12.0
    n = int(fs * dur)

    def band(lo, hi):
        b, a = butter(4, [lo, hi], btype="band")
        s = lfilter(b, a, rng.standard_normal(n))
        return s / (np.std(s) + 1e-9)

    s1, s2 = band(0.02, 0.3), band(0.25, 0.8)
    A = np.array([[0.95, 0.31], [0.31, 0.95]])
    ys_true = np.stack([np.outer(s1, A[:, 0]), np.outer(s2, A[:, 1])])
    mix = ys_true.sum(0)
    sc = np.max(np.abs(mix)) * 1.05
    mix, ys_true = mix / sc, ys_true / sc
    p = str(tmp_path / "blind.wav")
    wavwrite(mix, fs, p)

    def run(init):
        ys, info = separate_streaming(p, J=2, K=6, wlen=512,
                                      frames_per_block=32, verbose=0,
                                      init=init, init_seconds=4.0)
        assert np.all(np.isfinite(ys))
        assert all(np.isfinite(v) for v in info["logliks"])

        def sdr(a, b):
            return 10 * np.log10(np.sum(b ** 2)
                                 / max(np.sum((a - b) ** 2), 1e-12))

        return max(min(sdr(ys[0], ys_true[0]), sdr(ys[1], ys_true[1])),
                   min(sdr(ys[1], ys_true[0]), sdr(ys[0], ys_true[1])))

    blind = run("blind")
    rand = run("random")
    assert blind > rand - 0.5, (blind, rand)
    assert blind > 3.0, blind


def test_separate_streaming_blind_init_mono(rng, tmp_path):
    """Mono + init='blind' routes through models/mono.nmf_cluster_init."""
    from pyfasst_jax.audio import wavwrite
    from pyfasst_jax.models.streaming import separate_streaming

    fs, dur = 8000, 10.0
    n = int(fs * dur)
    t = np.arange(n) / fs
    s1 = sum(np.sin(2 * np.pi * 220 * (k + 1) * t) / (k + 1)
             for k in range(4)) * (1 + 0.4 * np.sin(2 * np.pi * 1.5 * t))
    s2 = np.convolve(rng.standard_normal(n), np.ones(16) / 16,
                     "same") * (np.sin(2 * np.pi * 0.9 * t) > 0)
    mix = (s1 / s1.std() + s2 / s2.std())[:, None]
    mix = mix / (np.abs(mix).max() * 1.05)
    p = str(tmp_path / "mono.wav")
    wavwrite(mix, fs, p)

    ys, info = separate_streaming(p, J=2, K=6, wlen=512,
                                  frames_per_block=32, verbose=0,
                                  init="blind", init_seconds=4.0)
    assert ys.shape[0] == 2 and np.all(np.isfinite(ys))
    assert all(np.isfinite(v) for v in info["logliks"])


def test_separate_streaming_bad_init_raises(rng, tmp_path):
    from pyfasst_jax.audio import wavwrite
    from pyfasst_jax.models.streaming import separate_streaming

    mix = rng.standard_normal((8000, 2)).astype(np.float32) * 0.1
    p = str(tmp_path / "x.wav")
    wavwrite(mix, 8000, p)
    with pytest.raises(ValueError, match="init"):
        separate_streaming(p, J=2, K=4, wlen=512, frames_per_block=16,
                           init="bogus", verbose=0)
