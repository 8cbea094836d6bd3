"""Convolutive separation seeded by DEMIX (BASELINE configs[1] flow).

Usage: python examples/separate_conv_demix.py mix.wav out_dir [n_sources]
"""
import sys
import os

# runnable from a plain checkout (no pip install needed)
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from pyfasst_jax.models import MultiChanNMFConv
from pyfasst_jax.models.demix import DEMIX

mix, out_dir = sys.argv[1], sys.argv[2]
K = int(sys.argv[3]) if len(sys.argv) > 3 else 3

dm = DEMIX(mix)
gains, delays = dm.comp_parameters(K)
print("DEMIX estimates: gains", np.round(gains, 3),
      "delays(samples)", np.round(delays, 2))

model = MultiChanNMFConv(mix, nbComps=K, nbNMFComps=8,
                         init_mixing=dm.mixing(), iter_num=200, verbose=1)
model.estim_param_a_posteriori()
print("wrote:", *model.separate_spat_comps(out_dir), sep="\n  ")
