"""Separate a stereo WAV into spatial sources (BASELINE configs[0] flow).

Usage: python examples/separate_stereo_nmf.py mix.wav out_dir [niter]
"""
import sys
import os

# runnable from a plain checkout (no pip install needed)
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import pyfasst_jax

mix, out_dir = sys.argv[1], sys.argv[2]
niter = int(sys.argv[3]) if len(sys.argv) > 3 else 200

model = pyfasst_jax.MultiChanNMFInst_FASST(
    mix, nbComps=2, nbNMFComps=8, iter_num=niter, verbose=1)
model.estim_param_a_posteriori()
paths = model.separate_spat_comps(out_dir)
print("wrote:", *paths, sep="\n  ")
