"""Separate a directory of stereo WAVs as one sharded batch (configs[4]).

Usage: python examples/batch_dataset.py 'clips/*.wav' out_dir
"""
import glob
import os
import sys
import os

# runnable from a plain checkout (no pip install needed)
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax.numpy as jnp

from pyfasst_jax.audio import AudioObject, wavwrite
from pyfasst_jax.models.components import (
    FasstParams, SpatialComp, SpectralComp, init_inst_mixing,
)
from pyfasst_jax.parallel.batch import batch_separate
from pyfasst_jax.parallel.sharding import make_mesh
from pyfasst_jax.tf.stft import STFT
from pyfasst_jax.utils.config import GEMConfig

pattern, out_dir = sys.argv[1], sys.argv[2]
paths = sorted(glob.glob(pattern))
audios = [AudioObject(p) for p in paths]
tft = STFT(wlen=1024, fs=audios[0].samplerate)
Xs = [np.asarray(tft.computeTransform(a.data.astype(np.float32)))
      for a in audios]
F = Xs[0].shape[0]


def make_params(F, Npad, i):
    rng = np.random.default_rng(i)
    spat = tuple(SpatialComp(A=a) for a in init_inst_mixing(None, 2, 1, 2))
    spec = tuple(SpectralComp(
        FB=jnp.asarray(0.5 + rng.random((F, 8)), jnp.float32),
        TW=jnp.asarray(0.5 + rng.random((8, Npad)), jnp.float32),
        spat_ind=j) for j in range(2))
    return FasstParams(spat=spat, spec=spec)


imgs, lls = batch_separate(Xs, make_params, GEMConfig(niter=200),
                           mesh=make_mesh())
os.makedirs(out_dir, exist_ok=True)
for p, a, img in zip(paths, audios, imgs):
    stem = os.path.splitext(os.path.basename(p))[0]
    for j in range(img.shape[0]):
        tft._nsamples = a.nsamples
        y = np.asarray(tft.invertTransform(img[j], nsamples=a.nsamples))
        wavwrite(y / max(np.abs(y).max(), 1.0), a.samplerate,
                 os.path.join(out_dir, f"{stem}_src{j}.wav"))
print("done:", len(paths), "clips")
