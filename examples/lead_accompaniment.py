"""Lead / accompaniment separation (SeparateLeadStereo flow).

Usage: python examples/lead_accompaniment.py song.wav out_dir
"""
import sys
import os

# runnable from a plain checkout (no pip install needed)
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from pyfasst_jax.models.lead import SeparateLeadStereoTF

song, out_dir = sys.argv[1], sys.argv[2]
sep = SeparateLeadStereoTF(song, niter=60)
sep.runDecomposition()
lead, acc = sep.writeSeparatedSignals(out_dir)
print("wrote:", lead, acc)
