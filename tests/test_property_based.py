"""Property-based tests (hypothesis) for the numerically critical primitives.

These sweep magnitude ranges and shape edge cases that fixed-seed unit tests
miss: the float32 engine must hold across ~16 orders of magnitude of source
power (annealing sweeps sigma over ~4 orders; recordings vary the rest).
"""
import numpy as np
import jax.numpy as jnp
from hypothesis import given, settings, strategies as st

from pyfasst_jax.ops import herm

_settings = settings(max_examples=25, deadline=None)


def _random_pd(rng, n, scale):
    """Random packed-Hermitian PD batch (n, 4) at a given magnitude."""
    a = rng.standard_normal((n, 2)) + 1j * rng.standard_normal((n, 2))
    H = a[:, :, None] * np.conj(a[:, None, :])
    H = H + 0.05 * np.trace(H, axis1=1, axis2=2).real[:, None, None] \
        * np.eye(2)
    H = H * scale
    return jnp.asarray(np.stack([H[:, 0, 0].real, H[:, 1, 1].real,
                                 H[:, 0, 1].real, H[:, 0, 1].imag],
                                axis=-1), jnp.float32)


@_settings
@given(seed=st.integers(0, 2 ** 31 - 1), logscale=st.floats(-8, 8))
def test_herm_inv_is_inverse_across_magnitudes(seed, logscale):
    rng = np.random.default_rng(seed)
    P = _random_pd(rng, 16, 10.0 ** logscale)
    Pinv = herm.inv(P)
    # H^-1 H = I: check via trace_prod (= tr(H^-1 H) = 2) and det product
    tr = np.asarray(herm.trace_prod(Pinv, P))
    np.testing.assert_allclose(tr, 2.0, rtol=2e-3)
    d = np.asarray(herm.det(P)) * np.asarray(herm.det(Pinv))
    np.testing.assert_allclose(d, 1.0, rtol=5e-3)


@_settings
@given(seed=st.integers(0, 2 ** 31 - 1),
       logv=st.floats(-10, 10), logsig=st.floats(-10, 0))
def test_stable_mixture_det_nonnegative_and_exact(seed, logv, logsig):
    """The nonnegative-monomial determinant must stay > 0 in float32 for any
    power/noise magnitudes, and match the float64 naive det."""
    from pyfasst_jax.ops.estep import cross_terms, stable_mixture_det

    rng = np.random.default_rng(seed)
    J, F, N = 2, 5, 7
    A = rng.standard_normal((J, F, 2, 1)) + 1j * rng.standard_normal(
        (J, F, 2, 1))
    A_conv = tuple(jnp.asarray(A[j], jnp.complex64) for j in range(J))
    Rj = jnp.stack([herm.herm_from_mixing(A_conv[j]) for j in range(J)])
    v = jnp.asarray(10.0 ** logv * (0.5 + rng.random((J, F, N))),
                    jnp.float32)
    sigma = jnp.full((F,), 10.0 ** logsig, jnp.float32)
    trR, Xc = cross_terms(Rj, A_conv)
    det = np.asarray(stable_mixture_det(v, trR, Xc, sigma))
    assert np.all(det > 0) and np.all(np.isfinite(det))

    # float64 ground truth from the assembled matrix
    Hf = np.zeros((F, N, 2, 2), complex)
    for j in range(J):
        Rfull = (np.asarray(A[j]) @ np.conj(np.asarray(A[j]))
                 .transpose(0, 2, 1))
        Hf += np.asarray(v[j], np.float64)[..., None, None] * Rfull[:, None]
    Hf += (10.0 ** logsig) * np.eye(2)
    det64 = np.linalg.det(Hf).real
    np.testing.assert_allclose(det, det64, rtol=5e-3)


@_settings
@given(nsamples=st.integers(30, 4000),
       wlen_pow=st.integers(4, 9), hop_div=st.sampled_from([2, 4]))
def test_stft_perfect_reconstruction_any_geometry(nsamples, wlen_pow,
                                                  hop_div):
    from pyfasst_jax.tf.stft import istft, stft

    wlen = 2 ** wlen_pow
    hop = wlen // hop_div
    rng = np.random.default_rng(nsamples)
    x = rng.standard_normal(nsamples).astype(np.float32)
    y = np.asarray(istft(stft(x, wlen, hop), nsamples, wlen, hop))
    np.testing.assert_allclose(y, x, atol=5e-5)


@_settings
@given(seed=st.integers(0, 2 ** 31 - 1), logn=st.floats(-12, 12),
       logd=st.floats(-12, 12))
def test_mul_upd_clamps_and_floors(seed, logn, logd):
    from pyfasst_jax.ops.mstep import UPD_MAX, UPD_MIN, _mul_upd

    rng = np.random.default_rng(seed)
    f = jnp.asarray(rng.random((4, 5)) + 1e-6, jnp.float32)
    num = jnp.asarray(10.0 ** logn * rng.random((4, 5)), jnp.float32)
    den = jnp.asarray(10.0 ** logd * rng.random((4, 5)), jnp.float32)
    out = np.asarray(_mul_upd(f, num, den, eps=1e-30))
    fn = np.asarray(f)
    assert np.all(np.isfinite(out)) and np.all(out > 0)
    assert np.all(out <= fn * UPD_MAX * (1 + 1e-6))
    assert np.all(out >= np.minimum(fn * UPD_MIN * (1 - 1e-6), out))


@_settings
@given(frames=st.integers(1, 300), channels=st.integers(1, 4),
       bits=st.sampled_from([16, 24, 32]), sr=st.sampled_from([8000, 44100]))
def test_wavio_roundtrip_any_shape(tmp_path_factory, frames, channels, bits,
                                   sr):
    from pyfasst_jax.native import wavio
    import pytest
    native = wavio()
    if native is None:
        pytest.skip("native toolchain unavailable")
    rng = np.random.default_rng(frames * 7 + channels)
    x = np.clip(rng.standard_normal((frames, channels)) * 0.4, -1, 1)
    p = str(tmp_path_factory.mktemp("w") / "x.wav")
    native.write(p, x, sr, bits=bits)
    y, sr2 = native.read(p)
    assert sr2 == sr and y.shape == x.shape
    tol = {16: 2 ** -14, 24: 2 ** -22, 32: 1e-7}[bits]
    assert np.abs(y - x).max() < tol
