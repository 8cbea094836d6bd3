"""Native (C++) runtime components, built on demand.

The compute path is JAX/XLA on the GPU; this package holds the
host-side native runtime around it. Currently: `_wavio`, the WAV codec /
streaming data loader (see wavio.cpp). The module is compiled lazily with
g++ on first use and cached next to its source; every consumer falls back
to a pure-Python path when the toolchain is unavailable, so nothing in the
framework hard-depends on the build.

Set PYFASST_JAX_NO_NATIVE=1 to disable native components entirely.
"""
from __future__ import annotations

import os
import subprocess
import sysconfig

_wavio_mod = None
_wavio_tried = False


def _build(name: str, source: str, out: str) -> None:
    import numpy as np
    cmd = [
        os.environ.get("CXX", "g++"), "-O3", "-shared", "-fPIC",
        "-std=c++17", "-fvisibility=hidden",
        f"-I{sysconfig.get_paths()['include']}",
        f"-I{np.get_include()}",
        source, "-o", out,
    ]
    subprocess.run(cmd, check=True, capture_output=True, text=True)


def wavio():
    """The native WAV codec module, or None if it cannot be built."""
    global _wavio_mod, _wavio_tried
    if _wavio_tried:
        return _wavio_mod
    _wavio_tried = True
    if os.environ.get("PYFASST_JAX_NO_NATIVE"):
        return None
    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(here, "wavio.cpp")
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    out = os.path.join(here, "_wavio" + suffix)
    try:
        if (not os.path.exists(out)
                or os.path.getmtime(out) < os.path.getmtime(src)):
            tmp = out + ".tmp"
            _build("_wavio", src, tmp)
            os.replace(tmp, out)
        import importlib.util
        spec = importlib.util.spec_from_file_location(
            "pyfasst_jax.native._wavio", out)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _wavio_mod = mod
    except Exception:  # toolchain/headers absent: stay on the scipy path
        _wavio_mod = None
    return _wavio_mod
