"""ERB / Mel filterbanks and the ERB-scale front-end.

Reference parity: pyfasst vendors Grill's NSGT (pyfasst/tftransforms/nsgt/,
UNVERIFIED) to get an ERBlet perfect-reconstruction transform as the ERB-scale
front-end. A device NSGT would force ragged, data-dependent block sizes --
hostile to XLA tiling. The rebuild keeps the (uniform, static-shape) STFT as
the covariance/Wiener domain and expresses ERB resolution the way FASST's own
model structure supports it: a *fixed* smooth filterbank matrix as the FB
spectral factor (F x B), with the free pattern weights living on the ERB grid.
That turns the ERB front-end into one matmul per update.

`ERBTransform` additionally offers an analysis/synthesis pair (filterbank +
least-squares dual) for users of the reference's transform API.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from pyfasst_jax.tf.stft import STFT


# -- frequency scales ---------------------------------------------------------

def hz_to_erb(f):
    """ERB-rate scale (Glasberg & Moore 1990)."""
    return 21.4 * np.log10(1.0 + 0.00437 * np.asarray(f, dtype=np.float64))


def erb_to_hz(e):
    return (10.0 ** (np.asarray(e, dtype=np.float64) / 21.4) - 1.0) / 0.00437


def hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


def _triangle_bank(freqs: np.ndarray, centers_hz: np.ndarray) -> np.ndarray:
    """Triangular filters on the given center grid; rows sum over all bands
    to ~1 EVERYWHERE: the first/last filters are shelves (flat outside
    their center), so frequencies below centers[1] and above centers[-2]
    are still covered.

    Full coverage is load-bearing, not cosmetic: a fixed FB whose columns
    leave any frequency row at ~0 makes those bins UNREPRESENTABLE by the
    model, and as the annealing noise floor shrinks, their residual power
    drives the log-likelihood to -|x|^2/sigma (observed at -4e8 on a
    broadband mixture) and wrecks the surrounding M-step updates."""
    B = len(centers_hz) - 2
    bank = np.zeros((B, len(freqs)), dtype=np.float64)
    for b in range(B):
        lo, c, hi = centers_hz[b], centers_hz[b + 1], centers_hz[b + 2]
        up = (freqs - lo) / max(c - lo, 1e-9)
        down = (hi - freqs) / max(hi - c, 1e-9)
        if b == 0:
            up = np.ones_like(freqs, dtype=np.float64)      # low shelf
        if b == B - 1:
            down = np.ones_like(freqs, dtype=np.float64)    # high shelf
        bank[b] = np.clip(np.minimum(up, down), 0.0, None)
    return bank


def _bank_on_scale(n_bands: int, freqs: np.ndarray, fmin: float, fmax: float,
                   fwd, inv) -> np.ndarray:
    lo, hi = fwd(max(fmin, 1e-3)), fwd(fmax)
    centers = inv(np.linspace(lo, hi, n_bands + 2))
    return _triangle_bank(freqs, centers)


def erb_filterbank(n_bands: int, F: int, fs: int, wlen: int,
                   fmin: float = 20.0, fmax: Optional[float] = None) -> np.ndarray:
    """(B, F) triangular filterbank with ERB-spaced centers."""
    fmax = fmax or fs / 2
    freqs = np.arange(F) * fs / wlen
    return _bank_on_scale(n_bands, freqs, fmin, fmax, hz_to_erb, erb_to_hz)


def mel_filterbank(n_bands: int, F: int, fs: int, wlen: int,
                   fmin: float = 20.0, fmax: Optional[float] = None) -> np.ndarray:
    """(B, F) triangular filterbank with Mel-spaced centers."""
    fmax = fmax or fs / 2
    freqs = np.arange(F) * fs / wlen
    return _bank_on_scale(n_bands, freqs, fmin, fmax, hz_to_mel, mel_to_hz)


def spectral_basis(kind: str, n_bands: int, F: int, fs: int, wlen: int,
                   **kw) -> np.ndarray:
    """(F, B) fixed FB factor: column b is band b's smooth spectral blob.

    Columns are L1-normalized so free FW weights carry the scale. Use as the
    fixed FB of a SpectralComp to get ERB/Mel-resolution spectral patterns.
    """
    if kind == "erb":
        bank = erb_filterbank(n_bands, F, fs, wlen, **kw)
    elif kind == "mel":
        bank = mel_filterbank(n_bands, F, fs, wlen, **kw)
    else:
        raise ValueError(f"unknown filterbank kind: {kind!r}")
    bank = bank / np.maximum(bank.sum(axis=1, keepdims=True), 1e-12)
    return bank.T.copy()  # (F, B)


class MelBank:
    """Thin object wrapper over mel_filterbank (kept for API discovery)."""

    def __init__(self, n_bands: int, F: int, fs: int, wlen: int, **kw):
        self.bank = mel_filterbank(n_bands, F, fs, wlen, **kw)

    def __call__(self, power_spec):
        return self.bank @ power_spec


class ERBTransform:
    """ERB-scale analysis front-end over an STFT core.

    API parity with the reference's transform objects (computeTransform /
    invertTransform). Analysis maps the STFT to B ERB bands via the
    filterbank; synthesis uses the least-squares dual (pinv), so
    invert(compute(x)) reconstructs the band-limited projection. For
    separation, prefer keeping the STFT domain and using `spectral_basis`
    inside the model (exact Wiener reconstruction).
    """

    name = "erb"

    def __init__(self, n_bands: int = 80, wlen: int = 1024,
                 hop: Optional[int] = None, fs: int = 44100,
                 fmin: float = 20.0, fmax: Optional[float] = None):
        self.stft = STFT(wlen=wlen, hop=hop, fs=fs)
        self.n_bands = int(n_bands)
        self.bank = erb_filterbank(n_bands, self.stft.F, fs, wlen,
                                   fmin=fmin, fmax=fmax)  # (B, F)
        self.dual = np.linalg.pinv(self.bank)             # (F, B)
        self.F = self.n_bands

    def computeTransform(self, data):
        X = np.asarray(self.stft.computeTransform(data))  # (F, N[, I])
        return np.tensordot(self.bank, X, axes=(1, 0))    # (B, N[, I])

    def invertTransform(self, Xb, nsamples: Optional[int] = None):
        X = np.tensordot(self.dual, np.asarray(Xb), axes=(1, 0))
        return self.stft.invertTransform(X, nsamples)

    forward = computeTransform
    inverse = invertTransform
