"""Online/streaming separation of a long recording — bounded memory.

Nothing ever holds the full (F, N) plane: analysis blocks are paged off
disk (STFT.stream_blocks reads only each block's samples via the native
codec's seek+read when built), the exponential-forgetting online GEM
learns the frequency-side parameters block by block (pass 1), and a
second streamed pass separates each block under the frozen parameters
and emits time samples through the exact-WOLA StreamingSynthesis.
Device memory stays O(F x block_frames) for any recording length.

The one-call pipeline:

Usage: python examples/streaming_online.py long_mix.wav out_dir
"""
import os
import sys

# runnable from a plain checkout (no pip install needed)
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from pyfasst_jax.models.streaming import separate_streaming

mix_path, out_dir = sys.argv[1], sys.argv[2]

ys, info = separate_streaming(
    mix_path,
    J=2,                  # sources
    K=8,                  # NMF components per source
    wlen=1024,
    frames_per_block=64,  # device memory ~ F x this
    out_dir=out_dir,      # writes stream_src_<j>.wav per source
    # spatial_rank=-1,    # diffuse/reverberant sources: learn a FULL-RANK
    #                     # spatial covariance per source (online Duong EM,
    #                     # re-estimated every block; default is rank-1
    #                     # point-source mixing)
)
print(f"streamed {info['blocks']} blocks of {info['block_frames']} frames; "
      f"block log-likelihood {info['logliks'][0]:.1f} -> "
      f"{info['logliks'][-1]:.1f}")
print("per-source output peak:",
      np.round(np.max(np.abs(ys), axis=(1, 2)), 3))
print("wrote", info["files"])

# The pieces are public if you need a custom loop -- see
# pyfasst_jax.ops.online (online_init / online_block),
# pyfasst_jax.tf.stft.STFT.stream_blocks and .synthesis_stream:
# push analysis blocks through online_block with a carried state, then
# Wiener-separate each block and feed StreamingSynthesis.push /
# .flush for constant-memory synthesis (tools/validate_hw.py's
# long-form scenario is the reference implementation).
