"""Signal-processing helpers.

Reference parity: pyfasst/tools/signalTools.py (UNVERIFIED; mount empty --
see SURVEY.md §2): median filtering, Itakura-Saito distance, spectral helper
functions. Device-friendly jnp implementations (usable inside jit).
"""
from __future__ import annotations

import jax.numpy as jnp


def median_filter(x: jnp.ndarray, size: int, axis: int = -1) -> jnp.ndarray:
    """Running median along `axis` (edge-replicated), odd `size`.

    Static window -> implemented as a stack of shifted slices + partition
    (no dynamic shapes; device friendly).
    """
    if size % 2 != 1:
        raise ValueError("size must be odd")
    half = size // 2
    x = jnp.moveaxis(x, axis, -1)
    pad = [(0, 0)] * (x.ndim - 1) + [(half, half)]
    xp = jnp.pad(x, pad, mode="edge")
    windows = jnp.stack([xp[..., i:i + x.shape[-1]] for i in range(size)],
                        axis=-1)
    med = jnp.median(windows, axis=-1)
    return jnp.moveaxis(med, -1, axis)


def is_distortion(P: jnp.ndarray, V: jnp.ndarray,
                  eps: float = 1e-30) -> jnp.ndarray:
    """Itakura-Saito divergence D_IS(P || V) = sum(P/V - log(P/V) - 1).

    Reference parity: tools.utils.ISDistortion (UNVERIFIED). The quantity
    the IS-NMF multiplicative updates monotonically non-increase.
    """
    r = jnp.maximum(P, eps) / jnp.maximum(V, eps)
    return jnp.sum(r - jnp.log(r) - 1.0)


def db(x, floor: float = 1e-30):
    """Power in decibels (device version of utils.misc.db)."""
    return 10.0 * jnp.log10(jnp.maximum(jnp.abs(x), floor))


def hwps_weight(freqs: jnp.ndarray, f0: float, width: float = 0.5):
    """Harmonic weighting helper: Gaussian bumps at multiples of f0."""
    h = jnp.round(freqs / f0)
    return jnp.exp(-0.5 * ((freqs - h * f0) / (width * f0)) ** 2) \
        * (h > 0)


def smooth_spectrum(P: jnp.ndarray, size: int = 5) -> jnp.ndarray:
    """Median-smoothed power spectrum along frequency (axis 0)."""
    return median_filter(P, size, axis=0)
