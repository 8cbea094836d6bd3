"""Unit tests for the learned per-bin embedding (models/binfeat.py).

Training/transfer tables live in docs/design.md §6j (tools/train_binfeat.py
on hardware); these tests cover the module mechanics at tiny shapes.
"""
import numpy as np
import pytest

from pyfasst_jax.models import binfeat


def _tiny_params():
    # small geometry so CPU tests stay fast
    return binfeat.init_params(
        seed=0, c_in=5, width=8, emb_dim=4,
        layers=((3, 3, 1, 1), (3, 3, 2, 2)))


def test_bin_inputs_shapes_and_scale_invariance():
    rng = np.random.default_rng(0)
    X = (rng.standard_normal((33, 20, 2))
         + 1j * rng.standard_normal((33, 20, 2)))
    inp, pw = binfeat.bin_inputs(X)
    assert inp.shape == (33, 20, 5) and pw.shape == (33, 20)
    inp2, _ = binfeat.bin_inputs(X * 7.3)
    # covariance channels exactly scale-invariant; log-power standardized
    np.testing.assert_allclose(inp2[..., :4], inp[..., :4], atol=1e-5)
    np.testing.assert_allclose(inp2[..., 4], inp[..., 4], atol=1e-3)


def test_embed_unit_norm_and_shape():
    params = _tiny_params()
    rng = np.random.default_rng(1)
    inp = rng.standard_normal((2, 16, 12, 5)).astype(np.float32)
    V = np.asarray(binfeat.embed(binfeat._as_pytree(params), inp))
    assert V.shape == (2, 16, 12, 4)
    np.testing.assert_allclose(
        np.linalg.norm(V, axis=-1), np.ones((2, 16, 12)), atol=1e-5)


def test_dc_loss_zero_at_perfect_and_positive_otherwise():
    import jax.numpy as jnp
    rng = np.random.default_rng(2)
    lab = rng.integers(0, 3, size=(1, 8, 10))
    Y = np.eye(4, dtype=np.float32)[lab]
    wb = np.full((1, 8, 10), 1.0 / 80, np.float32)
    # embeddings exactly equal to the one-hot labels -> VV' == YY'
    perfect = float(binfeat.dc_loss(jnp.asarray(Y), jnp.asarray(Y),
                                    jnp.asarray(wb)))
    assert abs(perfect) < 1e-5
    V = rng.standard_normal((1, 8, 10, 4)).astype(np.float32)
    V /= np.linalg.norm(V, axis=-1, keepdims=True)
    bad = float(binfeat.dc_loss(jnp.asarray(V), jnp.asarray(Y),
                                jnp.asarray(wb)))
    assert bad > 0.1


def test_training_step_reduces_loss():
    import jax
    import jax.numpy as jnp
    import optax

    params = _tiny_params()
    meta = params.pop("_meta")
    params = {k: jnp.asarray(v) for k, v in params.items()}
    rng = np.random.default_rng(3)
    # separable toy: two "sources" occupy different feature half-spaces
    lab = (rng.uniform(size=(2, 16, 12)) < 0.5).astype(np.int32)
    inp = rng.standard_normal((2, 16, 12, 5)).astype(np.float32) * 0.1
    inp[..., 0] += lab.astype(np.float32)
    Y = jax.nn.one_hot(lab, 4)
    wb = jnp.full((2, 16, 12), 1.0 / (16 * 12))

    def loss(p):
        V = binfeat.embed({**p, "_meta": meta}, jnp.asarray(inp))
        return binfeat.dc_loss(V, Y, wb)

    opt = optax.adam(3e-3)
    st = opt.init(params)
    l0 = float(loss(params))
    step = jax.jit(lambda p, s: (lambda g: (
        optax.apply_updates(p, opt.update(g, s, p)[0]),
        opt.update(g, s, p)[1]))(jax.grad(loss)(p)))
    for _ in range(30):
        params, st = step(params, st)
    l1 = float(loss(params))
    assert l1 < l0 * 0.8, (l0, l1)


def test_learned_votes_shape_and_onehot():
    params = _tiny_params()
    rng = np.random.default_rng(4)
    X = (rng.standard_normal((33, 24, 2))
         + 1j * rng.standard_normal((33, 24, 2)))
    votes = binfeat.learned_votes(X, J=3, params=params, n_seeds=2)
    assert votes.shape == (33, 24, 3)
    np.testing.assert_allclose(votes.sum(-1), np.ones((33, 24)))
    assert set(np.unique(votes)) <= {0.0, 1.0}


def test_learned_votes_separates_clear_panning():
    """Two sources hard-panned to opposite channels: even an untrained
    random conv stack must not be needed -- train a tiny net for a few
    steps on one draw and check votes beat chance on a fresh draw."""
    import jax
    import jax.numpy as jnp
    import optax

    def draw(seed):
        rng = np.random.default_rng(seed)
        F, N = 48, 40
        m0 = rng.uniform(size=(F, N)) < 0.5
        a = (rng.standard_normal((F, N)) + 1j * rng.standard_normal((F, N)))
        b = (rng.standard_normal((F, N)) + 1j * rng.standard_normal((F, N)))
        X = np.zeros((F, N, 2), complex)
        X[..., 0] = np.where(m0, a * 3, b * 0.1)
        X[..., 1] = np.where(m0, a * 0.1, b * 3)
        lab = np.where(m0, 0, 1)
        return X, lab

    X, lab = draw(10)
    inp, pw = binfeat.bin_inputs(X)
    params = _tiny_params()
    meta = params.pop("_meta")
    params = {k: jnp.asarray(v) for k, v in params.items()}
    Y = jax.nn.one_hot(lab[None], 4)
    wb = jnp.asarray((pw / pw.sum())[None])
    binp = jnp.asarray(inp[None])

    def loss(p):
        V = binfeat.embed({**p, "_meta": meta}, binp)
        return binfeat.dc_loss(V, Y, wb)

    opt = optax.adam(1e-2)
    st = opt.init(params)

    @jax.jit
    def step(p, s):
        g = jax.grad(loss)(p)
        u, s = opt.update(g, s, p)
        return optax.apply_updates(p, u), s

    for _ in range(60):
        params, st = step(params, st)

    X2, lab2 = draw(11)
    votes = binfeat.learned_votes(
        X2, J=2, params={**{k: np.asarray(v) for k, v in params.items()},
                         "_meta": meta}, n_seeds=2)
    got = np.argmax(votes, -1)
    _i, pw2 = binfeat.bin_inputs(X2)
    acc = max(((got == lab2) * pw2).sum(), ((got == 1 - lab2) * pw2).sum()) \
        / pw2.sum()
    assert acc > 0.9, acc


def test_save_load_roundtrip(tmp_path):
    params = _tiny_params()
    path = str(tmp_path / "w.npz")
    binfeat.save_params(params, path)
    back = binfeat.load_params(path)
    assert back["_meta"] == params["_meta"]
    for k, v in params.items():
        if k != "_meta":
            np.testing.assert_array_equal(back[k], v)


def test_load_params_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        binfeat.load_params(str(tmp_path / "nope.npz"))
