"""Small numeric helpers.

Reference parity: pyfasst/tools/utils.py::nextpow2/db/ident (UNVERIFIED symbol
names; the reference mount was empty -- see SURVEY.md). These are host-side
helpers; device math lives in pyfasst_jax.ops.
"""
from __future__ import annotations

import numpy as np


def nextpow2(n: float) -> int:
    """Smallest p such that 2**p >= n (returns the exponent, as in MATLAB)."""
    if n <= 1:
        return 0
    return int(np.ceil(np.log2(n)))


def db(x, floor: float = 1e-30):
    """Power ratio in decibels: 10*log10(|x|)."""
    return 10.0 * np.log10(np.maximum(np.abs(x), floor))


def ident(n: int, dtype=np.float64):
    """Identity matrix helper (kept for API parity with the reference tools)."""
    return np.eye(n, dtype=dtype)
