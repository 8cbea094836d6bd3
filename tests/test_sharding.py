"""Multi-chip sharding tests on the simulated 8-device CPU mesh
(SURVEY.md §4: distributed tests without a cluster)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pyfasst_jax.parallel import (
    batch_params, batched_run_gem, make_mesh, sharded_batch_separate,
)
from pyfasst_jax.ops.gem import annealing_endpoints, run_gem
from pyfasst_jax.models.components import (
    FasstParams, SpatialComp, SpectralComp, init_inst_mixing,
)
from pyfasst_jax.utils.config import GEMConfig


def _model(F, N, J=2, K=3, seed=0):
    rng = np.random.default_rng(seed)
    spat = tuple(SpatialComp(A=a) for a in init_inst_mixing(None, 2, 1, J))
    spec = tuple(SpectralComp(
        FB=jnp.asarray(0.5 + rng.random((F, K)), jnp.float32),
        TW=jnp.asarray(0.5 + rng.random((K, N)), jnp.float32),
        spat_ind=j) for j in range(J))
    return FasstParams(spat=spat, spec=spec)


def _batch(B, F, N, seed=0):
    rng = np.random.default_rng(seed)
    X_b = jnp.asarray(rng.standard_normal((B, F, N, 2))
                      + 1j * rng.standard_normal((B, F, N, 2)), jnp.complex64)
    params_b = batch_params([_model(F, N, seed=b) for b in range(B)])
    return params_b, X_b


def test_mesh_shapes():
    mesh = make_mesh(8)
    assert mesh.shape["dp"] * mesh.shape["fp"] == 8


def test_batched_gem_matches_single_clip():
    """The sharded batched path must produce the same result as running each
    clip through the plain single-device run_gem."""
    B, F, N = 4, 33, 16
    params_b, X_b = _batch(B, F, N)
    cfg = GEMConfig(niter=5)
    mesh = make_mesh(8)
    out_b, ll_b = jax.block_until_ready(
        batched_run_gem(params_b, X_b, cfg, mesh))
    assert ll_b.shape == (B, 5)
    for b in range(B):
        p = jax.tree.map(lambda a, b_=b: a[b_], params_b)
        _, ll = run_gem(p, X_b[b], cfg)
        np.testing.assert_allclose(np.asarray(ll_b[b]), np.asarray(ll),
                                   rtol=2e-4)


def test_sharded_separation_runs():
    B, F, N = 2, 33, 16
    params_b, X_b = _batch(B, F, N)
    cfg = GEMConfig(niter=3)
    mesh = make_mesh(8)
    params_b, _ = batched_run_gem(params_b, X_b, cfg, mesh)
    sigma_b = jax.vmap(lambda X: annealing_endpoints(X, cfg)[1])(X_b)
    Y = jax.block_until_ready(
        sharded_batch_separate(params_b, X_b, sigma_b, mesh))
    assert Y.shape == (B, 2, F, N, 2)
    assert bool(jnp.all(jnp.isfinite(jnp.abs(Y))))


def test_graft_entry_contract():
    """Exercise the driver contract: entry() compiles, dryrun_multichip runs."""
    import importlib.util, pathlib
    spec = importlib.util.spec_from_file_location(
        "_graft", pathlib.Path(__file__).resolve().parents[1]
        / "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fn, args = mod.entry()
    ll, new_params = jax.jit(fn)(*args)
    assert bool(jnp.isfinite(ll))
    mod.dryrun_multichip(8)


def test_batch_separate_variable_lengths(rng):
    """Bucketed batch separation over clips of different lengths."""
    from pyfasst_jax.parallel.batch import batch_separate, frame_buckets
    from pyfasst_jax.utils.config import GEMConfig

    assert frame_buckets([10, 100, 129, 200], granularity=128) == {
        128: [0, 1], 256: [2, 3]}

    F = 33
    lengths = [40, 44, 150]
    Xs = [rng.standard_normal((F, n, 2)) + 1j * rng.standard_normal((F, n, 2))
          for n in lengths]

    def make_params(F, Npad, i):
        r = np.random.default_rng(i)
        spat = tuple(SpatialComp(A=jnp.asarray(
            np.abs(r.standard_normal((2, 1))) + 0.4, jnp.float32))
            for _ in range(2))
        spec = tuple(SpectralComp(
            FB=jnp.asarray(0.5 + r.random((F, 3)), jnp.float32),
            TW=jnp.asarray(0.5 + r.random((3, Npad)), jnp.float32),
            spat_ind=j) for j in range(2))
        return FasstParams(spat=spat, spec=spec)

    imgs, lls = batch_separate(Xs, make_params, GEMConfig(niter=4),
                               mesh=make_mesh(8), granularity=64)
    for i, n in enumerate(lengths):
        assert imgs[i].shape == (2, F, n, 2)
        assert np.all(np.isfinite(imgs[i]))
        assert lls[i].shape == (4,)


def test_batch_padding_preserves_annealing_endpoints(rng):
    """A heavily padded clip must be driven by the SAME annealing schedule
    as the clip run alone: the batch path computes the endpoints from the
    unpadded frames (zero padding would dilute the per-frequency mean power
    and shrink the noise floor)."""
    from pyfasst_jax.parallel.batch import batch_separate
    from pyfasst_jax.utils.config import GEMConfig

    F, n = 33, 40          # granularity 128 -> padded 3.2x
    X = (rng.standard_normal((F, n, 2))
         + 1j * rng.standard_normal((F, n, 2)))

    def make_params(F, Npad, i):
        r = np.random.default_rng(0)
        spat = tuple(SpatialComp(A=jnp.asarray(
            np.abs(r.standard_normal((2, 1))) + 0.4, jnp.float32))
            for _ in range(2))
        spec = tuple(SpectralComp(
            FB=jnp.asarray(0.5 + r.random((F, 3)), jnp.float32),
            TW=jnp.asarray(0.5 + r.random((3, Npad)), jnp.float32),
            spat_ind=j) for j in range(2))
        return FasstParams(spat=spat, spec=spec)

    cfg = GEMConfig(niter=4)
    _, lls = batch_separate([X], make_params, cfg, mesh=make_mesh(8),
                            granularity=128)

    # reference: the same clip through run_gem with zero padding but the
    # TRUE endpoints (what an unpadded run of those frames would use)
    from pyfasst_jax.ops.gem import endpoints_from_power
    Xp = jnp.asarray(np.pad(X, ((0, 0), (0, 128 - n), (0, 0))),
                     jnp.complex64)
    se = endpoints_from_power(
        jnp.asarray(np.mean(np.abs(X) ** 2, axis=(1, 2)), jnp.float32), cfg)
    _, ll_ref = run_gem(make_params(F, 128, 0), Xp, cfg, sigma_endpoints=se)
    np.testing.assert_allclose(lls[0], np.asarray(ll_ref), rtol=2e-4)
    # and it must DIFFER from the naive diluted-endpoint run
    _, ll_diluted = run_gem(make_params(F, 128, 0), Xp, cfg)
    assert not np.allclose(lls[0], np.asarray(ll_diluted), rtol=1e-5)


def test_batch_checkpoint_resume(rng, tmp_path):
    """VERDICT r2 #10: kill a bucket mid-run, resume, and land on the same
    logliks and images as an uninterrupted run (the single-clip path
    already proves the chunked math; this proves the bucketed configs[4]
    path persists and resumes correctly)."""
    from pyfasst_jax.parallel.batch import batch_separate

    F = 33
    lengths = [40, 44, 150]          # two buckets at granularity 64
    Xs = [rng.standard_normal((F, n, 2)) + 1j * rng.standard_normal((F, n, 2))
          for n in lengths]

    def make_params(F, Npad, i):
        r = np.random.default_rng(i)
        spat = tuple(SpatialComp(A=jnp.asarray(
            np.abs(r.standard_normal((2, 1))) + 0.4, jnp.float32))
            for _ in range(2))
        spec = tuple(SpectralComp(
            FB=jnp.asarray(0.5 + r.random((F, 3)), jnp.float32),
            TW=jnp.asarray(0.5 + r.random((3, Npad)), jnp.float32),
            spat_ind=j) for j in range(2))
        return FasstParams(spat=spat, spec=spec)

    cfg = GEMConfig(niter=6)
    mesh = make_mesh(8)
    ref_imgs, ref_lls = batch_separate(Xs, make_params, cfg, mesh=mesh,
                                       granularity=64)

    class Killed(RuntimeError):
        pass

    def kill_first_chunk(Npad, iteration):
        raise Killed(f"simulated preemption at bucket {Npad} it {iteration}")

    ckpt_dir = str(tmp_path / "ckpts")
    with pytest.raises(Killed):
        batch_separate(Xs, make_params, cfg, mesh=mesh, granularity=64,
                       checkpoint_dir=ckpt_dir, checkpoint_every=2,
                       on_checkpoint=kill_first_chunk)
    import os
    saved = os.listdir(ckpt_dir)
    assert len(saved) == 1 and saved[0].startswith("bucket_")

    imgs, lls = batch_separate(Xs, make_params, cfg, mesh=mesh,
                               granularity=64, checkpoint_dir=ckpt_dir,
                               checkpoint_every=2)
    assert os.listdir(ckpt_dir) == []       # completed buckets clean up
    for i in range(len(Xs)):
        np.testing.assert_allclose(lls[i], ref_lls[i], rtol=1e-6)
        np.testing.assert_allclose(imgs[i], ref_imgs[i], rtol=1e-4,
                                   atol=1e-6)


def test_batch_checkpoint_mismatch_ignored(rng, tmp_path):
    """A stale bucket checkpoint (different clip set or niter) must be
    ignored, not resumed from."""
    from pyfasst_jax.parallel.batch import batch_separate

    F, n = 33, 40
    X = rng.standard_normal((F, n, 2)) + 1j * rng.standard_normal((F, n, 2))

    def make_params(F, Npad, i):
        r = np.random.default_rng(i)
        spat = tuple(SpatialComp(A=jnp.asarray(
            np.abs(r.standard_normal((2, 1))) + 0.4, jnp.float32))
            for _ in range(2))
        spec = tuple(SpectralComp(
            FB=jnp.asarray(0.5 + r.random((F, 3)), jnp.float32),
            TW=jnp.asarray(0.5 + r.random((3, Npad)), jnp.float32),
            spat_ind=j) for j in range(2))
        return FasstParams(spat=spat, spec=spec)

    mesh = make_mesh(8)
    ckpt_dir = str(tmp_path / "ckpts")

    class Killed(RuntimeError):
        pass

    def kill(Npad, iteration):
        raise Killed()

    with pytest.raises(Killed):
        batch_separate([X], make_params, GEMConfig(niter=6), mesh=mesh,
                       granularity=64, checkpoint_dir=ckpt_dir,
                       checkpoint_every=2, on_checkpoint=kill)
    # different niter: stale checkpoint must not poison the run
    ref, ref_lls = batch_separate([X], make_params, GEMConfig(niter=4),
                                  mesh=mesh, granularity=64)
    imgs, lls = batch_separate([X], make_params, GEMConfig(niter=4),
                               mesh=mesh, granularity=64,
                               checkpoint_dir=ckpt_dir, checkpoint_every=2)
    np.testing.assert_allclose(lls[0], ref_lls[0], rtol=1e-6)


def test_frame_axis_sharding_sp(rng):
    """SURVEY.md §2 SP row: shard the frame axis N instead of frequencies;
    the suff-stat reductions over n become psums inserted by GSPMD."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    import functools
    from pyfasst_jax.ops.gem import run_gem
    from pyfasst_jax.utils.config import GEMConfig

    B, F, N = 2, 17, 64
    params_b, X_b = _batch(B, F, N)
    mesh = make_mesh(8)
    x_sp = NamedSharding(mesh, P("dp", None, "fp"))   # N over 'fp'
    p_dp = jax.tree.map(lambda a: NamedSharding(mesh, P("dp")), params_b)
    cfg = GEMConfig(niter=3)

    def fn(params_b, X_b):
        X_b = jax.lax.with_sharding_constraint(X_b, x_sp)
        return jax.vmap(functools.partial(run_gem, cfg=cfg))(params_b, X_b)

    out, ll = jax.jit(fn, in_shardings=(p_dp, NamedSharding(mesh, P("dp"))))(
        params_b, X_b)
    ll = np.asarray(jax.block_until_ready(ll))
    assert ll.shape == (B, 3) and np.all(np.isfinite(ll))
    # matches the unsharded result
    _, ll_ref = run_gem(jax.tree.map(lambda a: a[0], params_b), X_b[0], cfg)
    np.testing.assert_allclose(ll[0], np.asarray(ll_ref), rtol=2e-4)
