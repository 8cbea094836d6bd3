"""Typed configuration for the GEM engine.

The reference exposes these knobs as plain constructor kwargs on the FASST
class (`nbComps`, `nbNMFComps`, `spatial_rank`, `niter`, annealing mode in
{'ann','no_ann','ann_ns_inj'}; pyfasst/audioModel.py::FASST.__init__,
UNVERIFIED). Here they are frozen dataclasses so they can be closed over by
jitted functions as static configuration.
"""
from __future__ import annotations

import dataclasses
import enum


class AnnealingMode(str, enum.Enum):
    """Noise-PSD annealing schedule of the GEM loop.

    Reference parity: the `ann` / `no_ann` / `ann_ns_inj` modes of
    pyfasst/audioModel.py::FASST.estim_param_a_posteriori (UNVERIFIED).
    The annealed noise PSD is load-bearing for conditioning of the per-bin
    2x2 mixture covariance, not just for local-optima escape.
    """

    ANN = "ann"                 # anneal Sigma_b from sigma0 down to sigma1
    NO_ANN = "no_ann"           # keep Sigma_b fixed at sigma1
    ANN_NS_INJ = "ann_ns_inj"   # anneal + inject matching noise into Cx stats


@dataclasses.dataclass(frozen=True)
class GEMConfig:
    """Static configuration of one GEM run (hashable -> usable as jit static)."""

    niter: int = 200
    annealing: AnnealingMode = AnnealingMode.ANN
    # Noise PSD endpoints as fractions of the per-frequency mean mixture
    # power. The final floor keeps cond(Sigma_x) within what float32 2x2
    # determinants can resolve (~1e6); a -55 dB noise floor is inaudible and
    # far inside the 0.1 dB SDR budget (BASELINE.json).
    # NOTE: the schedule interpolates the endpoints LINEARLY, so at small
    # niter (< ~50) the last step still shrinks sigma by orders of
    # magnitude at once and the final log-likelihood can DIP while tiny
    # residuals get repriced -- cosmetic at realistic iteration counts,
    # use no_ann when comparing logliks across few iterations.
    sigma_start_frac: float = 1e-2
    sigma_end_frac: float = 3e-6
    # Numerical floors (load-bearing: IS divergence and 2x2 inverses blow up
    # on zeros; keep these even in float64 oracle comparisons).
    eps: float = 1e-30
    det_floor: float = 1e-30
    # Per-frequency power floor relative to the global mean power: silent
    # bins otherwise drive sigma_b below the float32 denormal range and the
    # 1/sigma spatial-pooling weights overflow.
    power_floor_frac: float = 1e-4
    # Renormalize factor/mixing scales every iteration (prevents drift over
    # hundreds of iterations).
    renormalize: bool = True
    # (loglik is always computed -- it rides along in the fused E-step pass
    # at negligible cost, so there is no knob for it)
    # Use the fused E-step kernel (ops/pallas_estep.py) where it applies:
    # GPU backend, stereo, ranks <= 2 (pallas_estep.use_kernel). Numerics
    # match the XLA path; multi-device meshes turn it off (the kernel is one
    # custom call that GSPMD cannot split).
    use_pallas: bool = True
    # Hold the spatial mixing fixed for the first frac of iterations: early
    # spectral factors are random, and spatial updates driven by their
    # statistics fling the mixing toward the dominant source (source-collapse
    # local optimum). Letting the spectra adapt first is the standard remedy.
    spatial_hold_frac: float = 0.1

    def __post_init__(self):
        if isinstance(self.annealing, str):
            object.__setattr__(self, "annealing", AnnealingMode(self.annealing))


def load_config(source) -> GEMConfig:
    """Thin loader (SURVEY.md §5 config row): dict, JSON file path, or
    GEMConfig passthrough. Unknown keys raise (typos should not silently
    fall back to defaults)."""
    if isinstance(source, GEMConfig):
        return source
    if isinstance(source, (str, bytes)) or hasattr(source, "__fspath__"):
        import json
        with open(source) as fh:
            source = json.load(fh)
    if not isinstance(source, dict):
        raise TypeError(f"cannot load GEMConfig from {type(source)}")
    valid = {f.name for f in dataclasses.fields(GEMConfig)}
    unknown = set(source) - valid
    if unknown:
        raise ValueError(f"unknown GEMConfig keys: {sorted(unknown)}")
    return GEMConfig(**source)
