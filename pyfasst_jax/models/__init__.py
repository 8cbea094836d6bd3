"""Model families: the FASST base class and its pre-wired variants.

Reference parity: pyfasst/audioModel.py (UNVERIFIED; mount empty, SURVEY.md).
Lazy attribute loading keeps `ops` <-> `models.components` import order acyclic
(the compute layer imports components without pulling in the host API).
"""

import importlib

from pyfasst_jax.models.components import (  # noqa: F401
    FasstParams, SpatialComp, SpectralComp,
    INST, CONV, NMF, GMM, HMM,
)

_LAZY = {
    "FASST": "pyfasst_jax.models.fasst",
    "MultiChanNMFInst_FASST": "pyfasst_jax.models.variants",
    "MultiChanNMFConv": "pyfasst_jax.models.variants",
    "MultiChanHMM": "pyfasst_jax.models.variants",
    "multiChanSourceF0Filter": "pyfasst_jax.models.variants",
    "DEMIX": "pyfasst_jax.models.demix",
}

__all__ = [
    "FasstParams", "SpatialComp", "SpectralComp",
    "INST", "CONV", "NMF", "GMM", "HMM",
] + list(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module 'pyfasst_jax.models' has no attribute {name!r}")
