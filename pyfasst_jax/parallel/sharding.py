"""Mesh construction and the sharded batch-separation path.

BASELINE.json configs[4]: batch separation of a full SiSEC dev set, vmapped
over clips/segments across the cards of a mesh (all to all over NVLink, so
the mesh shape follows the algorithm alone). Parallelism map (SURVEY.md §2):

  - DP: clips/segments across the 'dp' mesh axis (vmap batch axis).
  - TP-analog: the frequency axis F across the 'fp' mesh axis -- FASST's
    per-bin 2x2 algebra is embarrassingly parallel in f; the only cross-shard
    reductions are the pooled instantaneous spatial solve (sum over f) and
    the spectral updates' F-contractions, which GSPMD lowers to psum over
    'fp' automatically.
  - PP: not applicable to a two-phase EM loop (documented, not faked).
  - SP (frame axis): available by the same mechanism (shard N); off by
    default since clips are short relative to F.
  - EP (source axis): deliberately NOT sharded. FASST keeps J small by
    design (2-8 sources; polyphony lives in NMF components WITHIN a source,
    not in more sources), so the J axis has less parallelism than one
    device's vector lanes. Worse, the float32-safe E-step couples sources
    through the leave-one-out statistics S_j = sum_{k!=j} v_k R_k + sigma I
    (estep.py): sharding J would move an O(J^2) all-to-all of (F, N)-sized
    planes onto the interconnect every iteration to save elementwise work
    that is already ~free. The fp/sp axes expose strictly more parallelism at zero extra
    communication.

Everything below is plain jit + NamedSharding constraints: no hand-written
collectives, which is the idiomatic XLA SPMD design.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.experimental import mesh_utils
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pyfasst_jax.models.components import FasstParams
from pyfasst_jax.ops.gem import run_gem
from pyfasst_jax.ops.wiener import separate_sources
from pyfasst_jax.utils.config import GEMConfig


def make_mesh(n_devices: Optional[int] = None,
              axes: Tuple[str, str] = ("dp", "fp"),
              dp: Optional[int] = None) -> Mesh:
    """Mesh over the first n devices, factored into (dp, fp).

    dp defaults to the largest power-of-two divisor <= sqrt(n) so both data
    and frequency parallelism get lanes; pass dp explicitly to override.
    """
    devices = jax.devices()[: (n_devices or len(jax.devices()))]
    n = len(devices)
    if dp is None:
        dp = 1
        while (dp * 2) * (dp * 2) <= n and n % (dp * 2) == 0:
            dp *= 2
        while n % dp != 0:
            dp //= 2
    fp = n // dp
    mesh_devices = mesh_utils.create_device_mesh((dp, fp), devices=devices)
    return Mesh(mesh_devices, axes)


def batch_params(params_list) -> FasstParams:
    """Stack per-clip parameter pytrees along a new leading batch axis."""
    return jax.tree.map(lambda *xs: jnp.stack(xs), *params_list)


def mesh_config(cfg: GEMConfig, mesh: Mesh) -> GEMConfig:
    """cfg for a GEM program on `mesh`: on more than one device the fused
    E-step kernel is off. It is one custom call that GSPMD cannot
    partition, so it would gather every shard onto every device; the XLA
    E-step partitions like the rest of the step."""
    if mesh.devices.size > 1:
        return dataclasses.replace(cfg, use_pallas=False)
    return cfg


@functools.lru_cache(maxsize=None)
def _batched_gem_jit(cfg: GEMConfig, mesh: Mesh, with_endpoints: bool):
    """One cached jit wrapper per (cfg, mesh[, endpoints-mode]).

    The jitted callable MUST be constructed once and reused: jit's trace
    cache is keyed on the function object, so wrapping a fresh closure per
    call re-traces AND re-compiles the whole batched GEM program every
    time.
    in_shardings uses prefix pytrees: one NamedSharding covers the whole
    params pytree.

    The iteration bounds (it0, it1) are TRACED scalars broadcast over the
    batch (in_axes=None), so chunked runs -- checkpoint every K
    iterations, resume a killed bucket -- reuse this one executable,
    exactly like the single-clip path (ops/gem.run_gem docstring).
    """
    cfg = mesh_config(cfg, mesh)
    x_in = NamedSharding(mesh, P("dp"))
    x_shard = NamedSharding(mesh, P("dp", "fp"))
    scalar = NamedSharding(mesh, P())

    if with_endpoints:
        def fn(params_b, X_b, se_b, it0, it1):
            X_b = jax.lax.with_sharding_constraint(X_b, x_shard)
            return jax.vmap(
                lambda p, X, se: run_gem(p, X, cfg, sigma_endpoints=se,
                                         start_iter=it0, end_iter=it1)
            )(params_b, X_b, se_b)

        return jax.jit(fn, in_shardings=(x_in, x_in, (x_in, x_in),
                                         scalar, scalar))

    def fn(params_b, X_b, it0, it1):
        X_b = jax.lax.with_sharding_constraint(X_b, x_shard)
        return jax.vmap(
            lambda p, X: run_gem(p, X, cfg, start_iter=it0, end_iter=it1)
        )(params_b, X_b)

    return jax.jit(fn, in_shardings=(x_in, x_in, scalar, scalar))


def batched_run_gem(params_b: FasstParams, X_b: jnp.ndarray, cfg: GEMConfig,
                    mesh: Mesh, sigma_endpoints_b=None, bounds=None):
    """Run the GEM loop for a batch of equal-shape clips on a mesh.

    params_b: pytree with leading batch axis B; X_b: (B, F, N, 2) complex.
    B must be divisible by the 'dp' axis size; F need not divide 'fp' --
    the frequency sharding is applied as an internal constraint, which GSPMD
    pads. sigma_endpoints_b, if given, is a (sigma0 (B, F), sigma1 (B, F))
    pair of per-clip annealing endpoints (compute them on the UNPADDED
    frames -- see batch.batch_separate). bounds, if given, is a dynamic
    (start_iter, end_iter) pair: iterations outside the range leave their
    loglik entries zero (chunked checkpoint/resume; the annealing schedule
    stays a function of the index against the FULL cfg.niter). Returns
    (params_b, logliks (B, niter)).
    """
    it0, it1 = (0, cfg.niter) if bounds is None else bounds
    if sigma_endpoints_b is None:
        return _batched_gem_jit(cfg, mesh, False)(params_b, X_b, it0, it1)
    return _batched_gem_jit(cfg, mesh, True)(
        params_b, X_b, tuple(sigma_endpoints_b), it0, it1)


@functools.lru_cache(maxsize=None)
def _batched_separate_jit(mesh: Mesh):
    x_in = NamedSharding(mesh, P("dp"))
    x_shard = NamedSharding(mesh, P("dp", "fp"))

    def fn(params_b, X_b, sigma_b):
        X_b = jax.lax.with_sharding_constraint(X_b, x_shard)
        return jax.vmap(separate_sources)(params_b, X_b, sigma_b)

    return jax.jit(fn, in_shardings=(x_in, x_in, x_in))


def sharded_batch_separate(params_b: FasstParams, X_b: jnp.ndarray,
                           sigma_b: jnp.ndarray, mesh: Mesh):
    """Wiener-separate a batch of clips on the mesh: (B, J, F, N, 2)."""
    return _batched_separate_jit(mesh)(params_b, X_b, sigma_b)
