"""Blind reverberant full-rank separation (BASELINE configs[2] flow).

Uses the consensus spatial-clustering initializer (models/spatial_init.py):
per-frequency covariance clustering + activity alignment + structural
repair by vetoed model evidence (batched short-GEM probes over merge/split
and direction-first hypotheses) seeds the rank-2 spatial covariances, and
the mixing stays frozen for the first 30% of iterations while the spectra
adapt. If every hypothesis is vetoed, a warning says the mixture likely
does not support n_sources separable sources. Equivalent CLI:

    pyfasst-jax separate mix.wav -o out --model fullrank --spatial-init

Usage: python examples/separate_reverberant_fullrank.py mix.wav out_dir [n_sources]
"""
import sys
import os

# runnable from a plain checkout (no pip install needed)
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from pyfasst_jax.models import MultiChanNMFConv
from pyfasst_jax.models.spatial_init import apply_profiles, full_rank_init
from pyfasst_jax.audio import AudioObject
from pyfasst_jax.tf.stft import STFT

mix, out_dir = sys.argv[1], sys.argv[2]
J = int(sys.argv[3]) if len(sys.argv) > 3 else 4
WLEN = 1024

obj = AudioObject(mix)
X = np.asarray(STFT(wlen=WLEN, fs=obj.samplerate)
                    .computeTransform(obj.data.astype(np.float32)))
A0, tw_prof, fb_prof = full_rank_init(X, J=J)

model = MultiChanNMFConv(obj, nbComps=J, nbNMFComps=6, spatial_rank=2,
                         init_mixing=A0, wlen=WLEN, iter_num=400,
                         spatial_hold_frac=0.3, verbose=1)
model.params = apply_profiles(model.params, tw_prof, fb_prof)
model.estim_param_a_posteriori()
print("wrote:", *model.separate_spat_comps(out_dir), sep="\n  ")

# Higher-quality (and costlier) alternative: the full blind pipeline --
# every candidate hypothesis run to convergence in batched device
# programs, winner picked by blind degeneracy statistics, plus
# EM-in-the-loop posterior reseeding. Equivalent CLI: add `--reseed 2`.
#
#   model = MultiChanNMFConv(obj, nbComps=J, nbNMFComps=6,
#                            spatial_rank=2, wlen=WLEN, iter_num=400)
#   info = model.estim_param_blind_reverb(reseed_rounds=2)
#   print("picked:", info["picked"])
#   model.separate_spat_comps(out_dir)
#
# The measured operating points ship as CLI presets: `--preset reverb`
# (adds band-local-EM pool candidates + cross-seed-consistency
# selection: min-SDR worst/median/best 8.02/8.73/11.44 on the gate
# draws) and `--preset speech` (reseed-free pool + consistency
# selection; docs/design.md section 6g).
#
# For material whose alignment evidence lives at a finer time scale than
# the best model grid (e.g. beat-locked music at 44.1 kHz under real
# reverb), run the MULTISCALE LADDER instead (docs/design.md section 6e):
# the blind pipeline executes on a fine grid first and its top candidates
# re-seed the model's own (coarse) grid. Equivalent CLI: add
# `--multiscale-wlen 2048` (with --wlen 8192).
#
#   model = MultiChanNMFConv(obj, nbComps=J, nbNMFComps=6,
#                            spatial_rank=2, wlen=8192, iter_num=400)
#   info = model.estim_param_blind_reverb(reseed_rounds=2,
#                                         multiscale_wlen=2048)
#   print("picked:", info["picked"], "fine:", info["fine"]["picked"])
#   model.separate_spat_comps(out_dir)
