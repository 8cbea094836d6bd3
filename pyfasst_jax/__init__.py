"""pyfasst_jax — JAX rebuild of the FASST flexible audio source separation
framework (reference: s-ben/pyfasst, a fork of wslihgt/pyfasst implementing
Ozerov, Vincent & Bimbot, "A General Flexible Framework for the Handling of Prior
Information in Audio Source Separation", IEEE TASLP 20(4):1118-1133, 2012).

This is NOT a port: the compute path is JAX/XLA (jit + vmapped 2x2 Hermitian
algebra over time-frequency bins, GEM loop as a lax.fori_loop, Pallas kernels
for the fused hot paths) and scaling is jax.sharding over a device Mesh.

Reference parity map (symbols recalled from pyfasst/audioModel.py, UNVERIFIED --
the reference mount was empty at build time; see SURVEY.md provenance note):

    pyfasst.audioModel.FASST                    -> pyfasst_jax.models.FASST
    FASST.estim_param_a_posteriori              -> same name (host wrapper over
                                                   jitted ops.gem.run_gem)
    FASST.separate_spat_comps                   -> same name
    FASST.separate_spatial_filter_comp          -> same name
    pyfasst.audioModel.MultiChanNMFInst_FASST   -> models.MultiChanNMFInst_FASST
    pyfasst.audioModel.MultiChanNMFConv         -> models.MultiChanNMFConv
    pyfasst.audioModel.MultiChanHMM             -> models.MultiChanHMM
    pyfasst.audioModel.multiChanSourceF0Filter  -> models.multiChanSourceF0Filter
    pyfasst.audioObject.AudioObject             -> pyfasst_jax.audio.AudioObject
    pyfasst.tftransforms.tft.TFTransform/STFT   -> pyfasst_jax.tf.STFT
    pyfasst.tftransforms.nsgt (ERBlet front-end)-> pyfasst_jax.tf.erblet
                                                   .ERBLetTransform (exact PR,
                                                   erb or constant-Q scale;
                                                   plugs into FASST via
                                                   transform=)
    pyfasst.tools.utils.inv_herm_mat_2d         -> pyfasst_jax.ops.herm.inv_herm_2x2
    pyfasst.demixTF.DEMIX                       -> pyfasst_jax.models.demix.DEMIX
    pyfasst.SeparateLeadStereo                  -> pyfasst_jax.models.lead
"""

__version__ = "0.1.0"

__all__ = [
    "AudioObject",
    "FASST",
    "MultiChanNMFInst_FASST",
    "MultiChanNMFConv",
    "MultiChanHMM",
    "multiChanSourceF0Filter",
]

_LAZY = {
    "AudioObject": "pyfasst_jax.audio",
    "FASST": "pyfasst_jax.models",
    "MultiChanNMFInst_FASST": "pyfasst_jax.models",
    "MultiChanNMFConv": "pyfasst_jax.models",
    "MultiChanHMM": "pyfasst_jax.models",
    "multiChanSourceF0Filter": "pyfasst_jax.models",
}


def __getattr__(name):
    # Lazy top-level API: importing pyfasst_jax stays light (no jax import
    # until a model/transform is actually touched).
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module 'pyfasst_jax' has no attribute {name!r}")
