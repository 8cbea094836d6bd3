"""Time-frequency front-ends.

Reference parity: pyfasst/tftransforms/ (tft.py STFT, minqt.py MinQT, vendored
nsgt/ ERBlet transform; UNVERIFIED -- mount empty, see SURVEY.md). The rebuild
keeps the same abstraction (analysis `computeTransform` / synthesis
`invertTransform`) but the compute is jitted JAX: framing as a gather, DFT via
XLA FFT or a GEMM-native matmul-DFT, overlap-add as a scatter-add.
"""

from pyfasst_jax.tf.stft import STFT, stft, istft
from pyfasst_jax.tf.filterbank import ERBTransform, MelBank, erb_filterbank, mel_filterbank
from pyfasst_jax.tf.erblet import ERBLetTransform, MultiRateERBLet

__all__ = ["STFT", "stft", "istft", "ERBTransform", "ERBLetTransform",
           "MultiRateERBLet", "MelBank", "erb_filterbank",
           "mel_filterbank"]
