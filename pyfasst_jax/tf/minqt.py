"""Minimum-Q / constant-Q transform (log-frequency front-end).

Reference parity: pyfasst/tftransforms/minqt.py::MinQTransfo (UNVERIFIED;
mount empty, see SURVEY.md §2). The reference computes a hybrid transform
whose Q is constant above a minimum bandwidth and bounded ("min-Q") below.

Device design (GEMM-native NDFT, cf. PAPERS.md "MelT"): instead of
per-octave FFT kernels with ragged hop sizes (hostile to XLA's static
shapes), the whole analysis is ONE dense matmul per frame block:

    X_cqt[k, n] = sum_t  w_k(t - n H) exp(-2 pi i f_k (t - n H)) x(t)
                = (frames @ K)[n, k],     K (wlen, K_bins) complex kernel

with a shared frame length long enough for the lowest-frequency atom and a
fixed hop -- static shapes, one matmul, exactly the transform the model
consumes. Synthesis uses the least-squares dual (pinv), giving
reconstruction of the band-limited projection (the reference's inverse is
also approximate for min-Q).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from pyfasst_jax.tf.stft import _frame_geometry, _frame_by_reshape

import jax
import jax.numpy as jnp


def minqt_kernel(fs: int, wlen: int, n_bins: int, fmin: float, fmax: float,
                 Q: float = 17.0, min_bw_hz: Optional[float] = None
                 ) -> np.ndarray:
    """(wlen, n_bins) complex analysis kernel on a log-frequency grid.

    Q is capped so every atom's bandwidth is at least min_bw_hz (the
    'minimum-Q' behaviour: low frequencies would otherwise need unboundedly
    long windows).
    """
    min_bw_hz = min_bw_hz or 2.0 * fs / wlen
    freqs = np.geomspace(fmin, fmax, n_bins)
    t = np.arange(wlen) - wlen / 2
    K = np.zeros((wlen, n_bins), np.complex128)
    for k, fk in enumerate(freqs):
        bw = max(fk / Q, min_bw_hz)                 # Hz
        L = min(wlen, int(round(Q_eff_len(fs, bw))))
        win = np.zeros(wlen)
        h = np.hanning(L)
        start = (wlen - L) // 2
        win[start:start + L] = h / (h.sum() + 1e-12)
        K[:, k] = win * np.exp(-2j * np.pi * fk * t / fs)
    return K


def Q_eff_len(fs: int, bw_hz: float) -> float:
    """Hann main-lobe length (samples) for a target bandwidth."""
    return 4.0 * fs / bw_hz


class MinQTransfo:
    """Min-Q analysis/synthesis front-end (reference API:
    computeTransform / invertTransform)."""

    name = "minqt"

    def __init__(self, fs: int = 44100, wlen: int = 4096,
                 hop: Optional[int] = None, n_bins: int = 144,
                 fmin: float = 40.0, fmax: Optional[float] = None,
                 Q: float = 17.0):
        self.fs = int(fs)
        self.wlen = int(wlen)
        self.hop = int(hop or wlen // 4)
        if self.wlen % self.hop != 0:
            raise ValueError(
                f"MinQTransfo requires hop dividing wlen (got wlen={wlen}, "
                f"hop={self.hop}): the framing/OLA use the reshape fast path")
        fmax = fmax or 0.45 * fs
        self.freqs = np.geomspace(fmin, fmax, n_bins)
        self.K = minqt_kernel(fs, wlen, n_bins, fmin, fmax, Q)   # (wlen, B)
        # real least-squares dual: solve min_f || K^T f - c || over REAL
        # frames by stacking real/imag parts.
        M = np.concatenate([self.K.real.T, self.K.imag.T], axis=0)  # (2B, w)
        # neighbouring log-frequency atoms are highly correlated; truncate
        # small singular values or the dual amplifies float32 noise by 1e6+
        self.dual_real = np.linalg.pinv(M, rcond=1e-3)           # (wlen, 2B)
        self.F = n_bins
        self._nsamples: Optional[int] = None

    @jax.default_matmul_precision("highest")
    def computeTransform(self, data):
        """(nsamples[, I]) -> complex (B, N[, I]): one GEMM per channel."""
        x = jnp.asarray(np.asarray(data, np.float32))
        self._nsamples = int(x.shape[0])
        pad_front, pad_back, n_frames, _ = _frame_geometry(
            self._nsamples, self.wlen, self.hop)
        xp = jnp.pad(x, ((pad_front, pad_back),) + ((0, 0),) * (x.ndim - 1))
        frames = _frame_by_reshape(xp, n_frames, self.wlen, self.hop)
        Kr = jnp.asarray(self.K.real, jnp.float32)
        Ki = jnp.asarray(self.K.imag, jnp.float32)
        if x.ndim == 2:
            re = jnp.einsum("nwi,wb->nbi", frames, Kr)
            im = jnp.einsum("nwi,wb->nbi", frames, Ki)
        else:
            re, im = frames @ Kr, frames @ Ki
        return jnp.moveaxis(jax.lax.complex(re, im), 0, 1)       # (B, N[,I])

    @jax.default_matmul_precision("highest")
    def invertTransform(self, Xb, nsamples: Optional[int] = None):
        """Real least-squares dual synthesis (band-limited projection)."""
        n = nsamples if nsamples is not None else self._nsamples
        if n is None:
            raise ValueError("call computeTransform first or pass nsamples")
        Xb = jnp.asarray(Xb)
        Xn = jnp.moveaxis(Xb, 1, 0)                              # (N, B[,I])
        c = jnp.concatenate([jnp.real(Xn), jnp.imag(Xn)], axis=1)  # (N,2B[,I])
        D = jnp.asarray(self.dual_real.T, jnp.float32)           # (2B, wlen)
        if Xb.ndim == 3:
            frames = jnp.einsum("nbi,bw->nwi", c, D)
        else:
            frames = c @ D
        pad_front, _, n_frames, padded_len = _frame_geometry(
            n, self.wlen, self.hop)
        from pyfasst_jax.tf.stft import _ola_by_reshape
        # each frame's projection is accurate near the frame CENTER (the
        # atoms are Hann-windowed) -- weight contributions by a Hann taper
        # and normalize by the taper's own overlap-add.
        taper = jnp.asarray(np.hanning(self.wlen) + 1e-3, jnp.float32)
        frames = frames * (taper[:, None] if Xb.ndim == 3 else taper)[None]
        y = _ola_by_reshape(frames, n_frames, self.wlen, self.hop,
                            padded_len)
        tsum = _ola_by_reshape(
            jnp.broadcast_to(taper[None], (n_frames, self.wlen)),
            n_frames, self.wlen, self.hop, padded_len)
        y = y / (tsum[:, None] if Xb.ndim == 3 else tsum)
        return jax.lax.dynamic_slice_in_dim(y, pad_front, n, axis=0)

    forward = computeTransform
    inverse = invertTransform
