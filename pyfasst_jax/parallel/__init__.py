"""Multi-chip scaling: device meshes and sharded batch separation.

The reference is a single-process NumPy library with NO distributed layer
(SURVEY.md §2, verified finding) -- this package is new capability, built
the XLA way: jax.sharding Mesh + pjit sharding constraints, with XLA's SPMD
partitioner inserting the collectives (psum over the frequency axis for the
pooled spatial solve and the spectral cross-frequency reductions; no
point-to-point traffic exists in FASST's dataflow).
"""

from pyfasst_jax.parallel.sharding import (
    make_mesh, batch_params, batched_run_gem, sharded_batch_separate,
)

__all__ = ["make_mesh", "batch_params", "batched_run_gem",
           "sharded_batch_separate"]
