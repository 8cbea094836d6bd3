"""STFT / inverse-STFT with weighted overlap-add (WOLA).

Reference parity: pyfasst/tftransforms/tft.py::STFT.computeTransform /
invertTransform (UNVERIFIED; mount empty -- see SURVEY.md). The reference uses
sinebell windows with hop = wlen/2 and a Python FFT loop; here analysis framing
is a single gather + batched rfft (or a GEMM-native matmul-DFT that maps the
whole transform onto matrix products, cf. PAPERS.md "MelT"), and synthesis is a single
scatter-add overlap-add, all jittable.

Reconstruction is exact (not just COLA-approximate): the inverse divides by the
per-sample window-energy sum sum_k w^2[t - k*hop], so any window/hop with full
coverage reconstructs to float precision when the spectrum is unmodified.

Conventions: signals are (nsamples,) or (nsamples, I); spectra are (F, N) or
(F, N, I) complex with F = wlen//2 + 1, N the frame count.
"""
from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


def sine_window(wlen: int, dtype=np.float64) -> np.ndarray:
    """Periodic sine window (sqrt-Hann); the reference's 'sinebell'."""
    return np.sin(np.pi * (np.arange(wlen, dtype=dtype) + 0.5) / wlen)


def _frame_geometry(nsamples: int, wlen: int, hop: int):
    """Padding and frame count so every input sample is window-interior."""
    pad_front = wlen - hop
    cover = nsamples + 2 * (wlen - hop)
    n_frames = max(1, int(np.ceil(max(cover - wlen, 0) / hop)) + 1)
    padded_len = (n_frames - 1) * hop + wlen
    pad_back = padded_len - nsamples - pad_front
    return pad_front, pad_back, n_frames, padded_len


def _frame_indices(n_frames: int, wlen: int, hop: int) -> np.ndarray:
    return (np.arange(n_frames)[:, None] * hop
            + np.arange(wlen)[None, :]).astype(np.int32)


def _ola_by_reshape(frames, n_frames: int, wlen: int, hop: int,
                    padded_len: int):
    """Overlap-add as k = wlen//hop shifted dense adds (no scatter).

    Scatter-adds serialize on the device; chunk i of every frame lands at
    offset (n + i) * hop, so OLA is the sum of k zero-padded reshapes.
    """
    k = wlen // hop
    tail = frames.shape[2:]
    out = None
    for i in range(k):
        chunk = frames[:, i * hop:(i + 1) * hop].reshape(
            (n_frames * hop,) + tail)
        padded = jnp.pad(chunk, ((i * hop, (k - 1 - i) * hop),)
                         + ((0, 0),) * len(tail))
        out = padded if out is None else out + padded
    return out


def _ola_norm(window, n_frames: int, wlen: int, hop: int, padded_len: int,
              idx=None):
    """Per-sample window-energy sum  sum_k w^2[t - k*hop]."""
    if wlen % hop == 0:
        w2 = jnp.broadcast_to(window[None, :] ** 2, (n_frames, wlen))
        wsum = _ola_by_reshape(w2, n_frames, wlen, hop, padded_len)
    else:
        w2 = jnp.broadcast_to(window[None, :] ** 2, idx.shape)
        wsum = jnp.zeros(padded_len, window.dtype).at[idx].add(w2)
    return jnp.maximum(wsum, 1e-12)


def _dft_matrices(wlen: int, dtype) -> tuple[np.ndarray, np.ndarray]:
    """Real/imag rfft matrices for the GEMM-native path: X = frames @ (C - iS)."""
    f = np.arange(wlen // 2 + 1)
    t = np.arange(wlen)
    ang = 2.0 * np.pi * np.outer(t, f) / wlen
    return np.cos(ang).astype(dtype), np.sin(ang).astype(dtype)


def _frame_by_reshape(xp, n_frames: int, wlen: int, hop: int):
    """Framing as k = wlen//hop static shifted reshapes (no gather).

    Gathers are slow on the device; for integer overlap factors the frame
    matrix is k interleaved dense reshapes of the padded signal:
    frames[:, i*hop:(i+1)*hop] = xp[i*hop:][: n_frames*hop].reshape(-1, hop).
    """
    k = wlen // hop
    parts = []
    for i in range(k):
        seg = jax.lax.dynamic_slice_in_dim(xp, i * hop, n_frames * hop,
                                           axis=0)
        parts.append(seg.reshape((n_frames, hop) + xp.shape[1:]))
    return jnp.concatenate(parts, axis=1)


def _spec_from_padded(xp, n_frames: int, window, wlen: int, hop: int,
                      method: str):
    """Windowed spectra of a PRE-PADDED signal: xp length must be exactly
    (n_frames - 1) * hop + wlen. Shared by the whole-signal core and the
    block-streaming path (identical math => bit-identical blocks)."""
    if wlen % hop == 0:
        frames = _frame_by_reshape(xp, n_frames, wlen, hop)
    else:
        idx = jnp.asarray(_frame_indices(n_frames, wlen, hop))
        frames = xp[idx]
    frames = frames * (window[:, None] if xp.ndim == 2 else window)[None]
    if method == "matmul":
        C, S = _dft_matrices(wlen, window.dtype)
        C, S = jnp.asarray(C), jnp.asarray(S)
        if xp.ndim == 2:
            re = jnp.einsum("nwi,wf->nfi", frames, C)
            im = jnp.einsum("nwi,wf->nfi", frames, S)
        else:
            re, im = frames @ C, frames @ S
        X = jax.lax.complex(re, -im)
    else:
        X = jnp.fft.rfft(frames, axis=1)  # (N, F[, I])
    return jnp.moveaxis(X, 0, 1)  # (F, N[, I])


@functools.partial(jax.jit, static_argnames=("wlen", "hop", "method"))
@jax.default_matmul_precision("highest")
def _stft_core(x, window, wlen: int, hop: int, method: str):
    nsamples = x.shape[0]
    pad_front, pad_back, n_frames, _ = _frame_geometry(nsamples, wlen, hop)
    xp = jnp.pad(x, ((pad_front, pad_back),) + ((0, 0),) * (x.ndim - 1))
    return _spec_from_padded(xp, n_frames, window, wlen, hop, method)


@functools.partial(jax.jit, static_argnames=("wlen", "hop", "nsamples"))
def _istft_core(X, window, wlen: int, hop: int, nsamples: int):
    pad_front, _, n_frames, padded_len = _frame_geometry(nsamples, wlen, hop)
    Xn = jnp.moveaxis(X, 1, 0)  # (N, F[, I])
    if Xn.shape[0] != n_frames:
        raise ValueError(f"expected {n_frames} frames, got {Xn.shape[0]}")
    frames = jnp.fft.irfft(Xn, n=wlen, axis=1)
    frames = frames * (window[:, None] if X.ndim == 3 else window)[None]
    if wlen % hop == 0:
        y = _ola_by_reshape(frames, n_frames, wlen, hop, padded_len)
        wsum = _ola_norm(window.astype(frames.dtype), n_frames, wlen, hop,
                         padded_len)
    else:
        idx = jnp.asarray(_frame_indices(n_frames, wlen, hop))
        out_shape = (padded_len,) + X.shape[2:]
        y = jnp.zeros(out_shape, frames.dtype).at[idx].add(frames)
        wsum = _ola_norm(window.astype(frames.dtype), n_frames, wlen, hop,
                         padded_len, idx=idx)
    y = y / (wsum[:, None] if X.ndim == 3 else wsum)
    return jax.lax.dynamic_slice_in_dim(y, pad_front, nsamples, axis=0)


def stft(x, wlen: int = 1024, hop: Optional[int] = None,
         window: Optional[np.ndarray] = None, method: str = "fft"):
    """Analysis: (nsamples[, I]) -> complex (F, N[, I]).

    method='fft' uses XLA's batched rfft; method='matmul' maps the DFT onto
    two real matmuls (an alternative for small wlen).
    """
    hop = hop or wlen // 2
    x = jnp.asarray(x)
    win = jnp.asarray(window if window is not None else sine_window(wlen),
                      dtype=x.dtype)
    return _stft_core(x, win, wlen, hop, method)


def istft(X, nsamples: int, wlen: int = 1024, hop: Optional[int] = None,
          window: Optional[np.ndarray] = None):
    """Synthesis: complex (F, N[, I]) -> (nsamples[, I]) via normalized WOLA."""
    hop = hop or wlen // 2
    X = jnp.asarray(X)
    win = jnp.asarray(window if window is not None else sine_window(wlen),
                      dtype=jnp.real(X).dtype)
    return _istft_core(X, win, wlen, hop, nsamples)


@functools.partial(jax.jit, static_argnames=("wlen", "hop"))
def _synth_block_core(Xb, window, carry_y, carry_w, wlen: int, hop: int):
    """One streaming-synthesis block.

    Xb (F, Nb[, I]) complex spectra; carry_y/carry_w the (wlen-hop[, I])
    unfinished overlap-add tails from the previous push. Returns
    (emitted_y, emitted_wsum, new_carry_y, new_carry_w) where the emitted
    region (Nb*hop samples) is COMPLETE: every frame that overlaps it has
    been pushed (frames arrive in time order; a sample at local offset
    p < Nb*hop is covered only by frames i*hop <= p < i*hop + wlen, all
    inside this block or the carry)."""
    Xn = jnp.moveaxis(Xb, 1, 0)                     # (Nb, F[, I])
    nb = Xn.shape[0]
    frames = jnp.fft.irfft(Xn, n=wlen, axis=1)
    frames = frames * (window[:, None] if Xb.ndim == 3 else window)[None]
    L = (nb - 1) * hop + wlen
    y = _ola_by_reshape(frames, nb, wlen, hop, L)   # (L[, I])
    w2 = jnp.broadcast_to((window ** 2)[None], (nb, wlen))
    w = _ola_by_reshape(w2.astype(frames.dtype), nb, wlen, hop, L)  # (L,)
    cl = wlen - hop
    y = y.at[:cl].add(carry_y)
    w = w.at[:cl].add(carry_w)
    emit = nb * hop
    return y[:emit], w[:emit], y[emit:], w[emit:]


class StreamingSynthesis:
    """Exact-WOLA inverse STFT, one block of frames at a time.

    The bounded-memory dual of ``STFT.stream_blocks``: push (F, Nb[, I])
    spectra blocks in time order; each ``push`` returns the newly
    COMPLETED time samples (WOLA-normalized), ``flush`` the final tail.
    Device memory stays O(Nb); the full (F, N) plane never exists.
    Agrees with ``istft`` on the concatenated spectra to float rounding
    (the overlap-add accumulation order differs across block boundaries,
    so agreement is ~1e-6 relative, not bit-level -- tested in
    tests/test_online.py). Requires wlen % hop == 0 (the reshape-OLA
    path; the default hop = wlen/2 qualifies).
    """

    def __init__(self, nsamples: int, wlen: int = 1024,
                 hop: Optional[int] = None,
                 window: Optional[np.ndarray] = None):
        self.wlen = int(wlen)
        self.hop = int(hop or wlen // 2)
        if self.wlen % self.hop:
            raise ValueError("StreamingSynthesis needs wlen % hop == 0")
        self.window = jnp.asarray(
            window if window is not None else sine_window(self.wlen),
            jnp.float32)
        pad_front, _, n_frames, _ = _frame_geometry(nsamples, self.wlen,
                                                    self.hop)
        self._skip = pad_front           # padded head samples to drop
        self._remaining = int(nsamples)  # output samples still to emit
        self.frames_expected = n_frames
        self._frames_seen = 0
        self._cy = None                  # carries allocated on first push
        self._cw = None

    def _trim(self, y):
        """Drop the padded head, stop after nsamples."""
        if self._skip:
            k = min(self._skip, y.shape[0])
            self._skip -= k
            y = y[k:]
        y = y[:max(self._remaining, 0)]
        self._remaining -= y.shape[0]
        return y

    def push(self, Xb) -> np.ndarray:
        """Consume one spectra block -> completed samples (m[, I]) f32."""
        cl = self.wlen - self.hop
        if self._cy is None:
            tail = Xb.shape[2:]
            self._cy = jnp.zeros((cl,) + tail, jnp.float32)
            self._cw = jnp.zeros((cl,), jnp.float32)
        ey, ew, self._cy, self._cw = _synth_block_core(
            Xb, self.window, self._cy, self._cw, self.wlen, self.hop)
        self._frames_seen += Xb.shape[1]
        ew = jnp.maximum(ew, 1e-12)
        out = ey / (ew[:, None] if ey.ndim == 2 else ew)
        return self._trim(np.asarray(out))

    def flush(self) -> np.ndarray:
        """Emit the final (wlen - hop) overlap tail after the last push."""
        if self._cy is None:
            return np.zeros((0,), np.float32)
        if self._frames_seen != self.frames_expected:
            raise ValueError(
                f"expected {self.frames_expected} frames, "
                f"saw {self._frames_seen}")
        cw = jnp.maximum(self._cw, 1e-12)
        out = self._cy / (cw[:, None] if self._cy.ndim == 2 else cw)
        self._cy = self._cw = None
        return self._trim(np.asarray(out))


class STFT:
    """Object front-end matching the reference TFTransform API.

    ``computeTransform(data)`` / ``invertTransform(X)`` mirror
    pyfasst/tftransforms/tft.py (UNVERIFIED names). Frequency axis first.
    """

    name = "stft"

    def __init__(self, wlen: int = 1024, hop: Optional[int] = None,
                 fs: int = 44100, method: str = "fft"):
        self.wlen = int(wlen)
        self.hop = int(hop or wlen // 2)
        self.fs = int(fs)
        self.method = method
        self.window = sine_window(self.wlen)
        self.F = self.wlen // 2 + 1
        self._nsamples: Optional[int] = None

    @property
    def freqs(self) -> np.ndarray:
        return np.arange(self.F) * self.fs / self.wlen

    def n_frames(self, nsamples: int) -> int:
        return _frame_geometry(nsamples, self.wlen, self.hop)[2]

    def computeTransform(self, data):
        self._nsamples = int(np.asarray(data).shape[0])
        return stft(data, self.wlen, self.hop, self.window, self.method)

    def invertTransform(self, X, nsamples: Optional[int] = None):
        n = nsamples if nsamples is not None else self._nsamples
        if n is None:
            raise ValueError("call computeTransform first or pass nsamples")
        return istft(X, n, self.wlen, self.hop, self.window)

    def stream_blocks(self, filename, frames_per_block: int,
                      start_block: int = 0):
        """Yield STFT blocks of a WAV file, reading only each block's
        samples (the long-context front-end: memory stays
        O(frames_per_block), served by the native codec's seek+read when
        built). Blocks are bit-identical to the corresponding slices of
        computeTransform on the whole file (shared _spec_from_padded), so

            jnp.concatenate(list(st.stream_blocks(p, Nb)), axis=1)
            == st.computeTransform(whole)

        Pairs with ops.online.online_block for bounded-memory streaming
        estimation of recordings whose (F, N) plane exceeds HBM.
        start_block skips ahead without reading the skipped samples
        (checkpoint resume of a long streaming estimation).
        """
        import os as _os
        from pyfasst_jax.audio import wavread_block
        from pyfasst_jax.native import wavio
        native = wavio()
        if native is not None:
            nsamples = native.info(_os.fspath(filename))["frames"]
        else:
            from pyfasst_jax.audio import wavread
            nsamples = wavread(filename)[0].shape[0]
        wlen, hop = self.wlen, self.hop
        pad_front, _, n_frames, _ = _frame_geometry(nsamples, wlen, hop)
        win = jnp.asarray(self.window, jnp.float32)
        for m0 in range(start_block * frames_per_block, n_frames,
                        frames_per_block):
            m1 = min(m0 + frames_per_block, n_frames)
            lo = m0 * hop - pad_front                    # may be < 0
            hi = (m1 - 1) * hop - pad_front + wlen       # may be > nsamples
            lo_c, hi_c = max(lo, 0), min(hi, nsamples)
            data, _ = wavread_block(filename, lo_c, hi_c - lo_c)
            chunk = np.pad(np.asarray(data, np.float32),
                           ((lo_c - lo, hi - hi_c),) + ((0, 0),)
                           * (data.ndim - 1))
            yield _spec_from_padded(jnp.asarray(chunk), m1 - m0, win,
                                    wlen, hop, self.method)

    def synthesis_stream(self, nsamples: int) -> StreamingSynthesis:
        """Bounded-memory inverse: the dual of stream_blocks (see
        StreamingSynthesis)."""
        return StreamingSynthesis(nsamples, self.wlen, self.hop,
                                  self.window)

    # snake_case aliases (idiomatic surface; same functions)
    forward = computeTransform
    inverse = invertTransform
