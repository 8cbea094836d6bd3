"""utils.signal (signalTools parity) tests."""
import numpy as np
import jax.numpy as jnp

from pyfasst_jax.utils.signal import is_distortion, median_filter, db


def test_median_filter_matches_scipy(rng):
    from scipy.ndimage import median_filter as sp_med
    x = rng.standard_normal((7, 50))
    got = np.asarray(median_filter(jnp.asarray(x), 5, axis=-1))
    want = sp_med(x, size=(1, 5), mode="nearest")
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_is_distortion_properties(rng):
    P = jnp.asarray(0.5 + rng.random((10, 10)))
    assert float(is_distortion(P, P)) < 1e-5
    assert float(is_distortion(P, 2 * P)) > 0


def test_db():
    assert abs(float(db(jnp.asarray(100.0))) - 20.0) < 1e-6
