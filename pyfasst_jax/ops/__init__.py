"""Device compute: Hermitian 2x2 algebra, GEM E/M steps, Wiener separation.

Reference parity: the hot loops of pyfasst/audioModel.py (comp_suff_stat,
update_spat_comps, update_spec_comps; UNVERIFIED -- mount empty, SURVEY.md)
and pyfasst/tools/utils.py::inv_herm_mat_2d. The rebuild replaces the per-bin
Python loops by vmapped/elementwise packed-real algebra over the whole (f, n)
plane inside one jitted GEM step (BASELINE.json:north_star).
"""

from pyfasst_jax.ops import herm, estep, mstep, gem, wiener  # noqa: F401
