"""Checkpoint / resume for GEM runs.

The reference keeps parameters in in-memory dicts and persists only the
final WAVs (SURVEY.md §5); checkpoint/resume is new capability. Parameters
are a pytree (FasstParams), so a checkpoint is the flattened leaves + the
static treedef recipe. EM is trivially restartable: resume = load pytree +
continue the fori_loop from the saved iteration (the annealing schedule is a
pure function of the iteration index).

Plain .npz format (no orbax dependency at runtime; orbax remains usable by
passing pytrees directly to it if installed).
"""
from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import warnings

import jax
import numpy as np

from pyfasst_jax.models.components import (
    FasstParams, SpatialComp, SpectralComp,
)

_FACTORS = ("FB", "FW", "TW", "TB", "trans", "FB2", "TW2")


def save_params(path: str, params: FasstParams,
                iteration: int = 0, extra: Optional[dict] = None,
                extra_arrays: Optional[dict] = None) -> str:
    """Serialize a FasstParams pytree (+ static structure) to one .npz.

    The pytree leaves may carry a leading batch axis (the bucketed
    configs[4] path checkpoints a whole bucket's stacked params at once).
    extra: JSON-serializable sidecar metadata. extra_arrays: named numpy
    arrays stored alongside (e.g. accumulated logliks); load_params
    returns them merged into the extra dict.
    """
    arrays = {f"xtr_{k}": np.asarray(v)
              for k, v in (extra_arrays or {}).items()}
    meta = {"iteration": int(iteration), "n_spat": params.n_spat,
            "n_spec": len(params.spec), "spat": [], "spec": [],
            "extra": extra or {},
            "extra_array_names": sorted((extra_arrays or {}).keys())}
    for j, c in enumerate(params.spat):
        arrays[f"spat_{j}_A"] = np.asarray(c.A)
        meta["spat"].append({"mix_type": c.mix_type, "free": bool(c.free)})
    for k, c in enumerate(params.spec):
        present = []
        for name in _FACTORS:
            val = getattr(c, name)
            if val is not None:
                arrays[f"spec_{k}_{name}"] = np.asarray(val)
                present.append(name)
        meta["spec"].append({
            "spat_ind": c.spat_ind, "free": list(c.free),
            "free2": list(c.free2),
            "constraint": c.constraint, "decode": c.decode,
            "present": present,
        })
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, **arrays)
    os.replace(tmp, path)
    return path


def load_params(path: str) -> Tuple[FasstParams, int, dict]:
    """Load (params, iteration, extra) from a checkpoint written above."""
    import jax.numpy as jnp

    def up(arr):
        if (arr.dtype in (np.float64, np.complex128)
                and not jax.config.jax_enable_x64):
            warnings.warn(
                "loading a float64 checkpoint without jax_enable_x64: "
                "leaves are downcast to float32 (the x64 parity mode "
                "requires enabling x64 before load)", stacklevel=3)
        return jnp.asarray(arr)

    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        spat = []
        for j, m in enumerate(meta["spat"]):
            spat.append(SpatialComp(A=up(data[f"spat_{j}_A"]),
                                    mix_type=m["mix_type"], free=m["free"]))
        spec = []
        for k, m in enumerate(meta["spec"]):
            kw = {name: (up(data[f"spec_{k}_{name}"])
                         if name in m["present"] else None)
                  for name in _FACTORS}
            spec.append(SpectralComp(spat_ind=m["spat_ind"],
                                     free=tuple(m["free"]),
                                     free2=tuple(m.get("free2",
                                                       (False, True))),
                                     constraint=m["constraint"],
                                     decode=m.get("decode", "soft"), **kw))
        extra = meta.get("extra", {})
        for name in meta.get("extra_array_names", []):
            extra[name] = np.array(data[f"xtr_{name}"])
    return (FasstParams(spat=tuple(spat), spec=tuple(spec)),
            meta["iteration"], extra)
