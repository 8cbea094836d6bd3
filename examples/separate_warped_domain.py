"""Separate directly in a warped (ERB or constant-Q) subband domain.

The GEM engine is front-end-agnostic: give the model any transform with
computeTransform / invertTransform and it models the warped coefficients
directly -- the reference's FASST-over-NSGT flow (SURVEY.md §3.1). The
ERBLetTransform is perfect-reconstruction, so the separated stems are
synthesized through the exact dual.

Usage: python examples/separate_warped_domain.py mix.wav out_dir [erb|log]
"""
import sys
import os

# runnable from a plain checkout (no pip install needed)
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import pyfasst_jax
from pyfasst_jax.audio import AudioObject
from pyfasst_jax.tf.erblet import ERBLetTransform

mix, out_dir = sys.argv[1], sys.argv[2]
scale = sys.argv[3] if len(sys.argv) > 3 else "erb"

fs = AudioObject(mix).samplerate
tft = ERBLetTransform(fs=fs, n_bands=64, scale=scale)
model = pyfasst_jax.MultiChanNMFInst_FASST(
    mix, nbComps=2, nbNMFComps=8, iter_num=200, transform=tft, verbose=1)
model.estim_param_a_posteriori()
paths = model.separate_spat_comps(out_dir)
print("wrote:", *paths, sep="\n  ")
