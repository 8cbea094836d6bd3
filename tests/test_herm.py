"""Packed 2x2 Hermitian algebra vs numpy.linalg (SURVEY.md §4 unit tests)."""
import numpy as np
import pytest

from pyfasst_jax.ops import herm


def _random_herm_pd(rng, n):
    """Batch of random Hermitian positive-definite 2x2s."""
    B = rng.standard_normal((n, 2, 2)) + 1j * rng.standard_normal((n, 2, 2))
    H = B @ B.conj().transpose(0, 2, 1) + 0.1 * np.eye(2)[None]
    return H


def test_inv_matches_numpy(rng):
    H = _random_herm_pd(rng, 64)
    got = np.asarray(herm.inv_herm_2x2(H.astype(np.complex64)))
    want = np.linalg.inv(H)
    assert np.allclose(got, want, rtol=2e-3, atol=1e-4)


def test_pack_unpack_roundtrip(rng):
    H = _random_herm_pd(rng, 8)
    P = herm.herm_from_complex(H)
    H2 = np.asarray(herm.herm_to_complex(P))
    assert np.allclose(H, H2, rtol=1e-6, atol=1e-6)


def test_trace_prod(rng):
    P_ = _random_herm_pd(rng, 16)
    Q_ = _random_herm_pd(rng, 16)
    got = np.asarray(herm.trace_prod(herm.herm_from_complex(P_),
                                     herm.herm_from_complex(Q_)))
    want = np.einsum("nab,nba->n", P_, Q_).real
    assert np.allclose(got, want, rtol=1e-5)


def test_congruence(rng):
    A_ = _random_herm_pd(rng, 16)
    R_ = _random_herm_pd(rng, 16)
    got = np.asarray(herm.herm_to_complex(herm.congruence(
        herm.herm_from_complex(A_), herm.herm_from_complex(R_))))
    want = A_ @ R_ @ A_
    assert np.allclose(got, want, rtol=1e-4, atol=1e-4)


def test_mul_general(rng):
    P_ = _random_herm_pd(rng, 16)
    Q_ = _random_herm_pd(rng, 16)
    got = np.asarray(herm.gen_to_complex(herm.mul(
        herm.herm_from_complex(P_), herm.herm_from_complex(Q_))))
    want = P_ @ Q_
    assert np.allclose(got, want, rtol=1e-4, atol=1e-4)


def test_gen_apply(rng):
    P_ = _random_herm_pd(rng, 16)
    Q_ = _random_herm_pd(rng, 16)
    M = herm.mul(herm.herm_from_complex(P_), herm.herm_from_complex(Q_))
    x = rng.standard_normal((16, 2)) + 1j * rng.standard_normal((16, 2))
    y0, y1 = herm.gen_apply(M, x[:, 0], x[:, 1])
    want = np.einsum("nab,nb->na", P_ @ Q_, x)
    assert np.allclose(np.stack([np.asarray(y0), np.asarray(y1)], -1), want,
                       rtol=1e-4, atol=1e-4)


def test_herm_from_mixing(rng):
    A = rng.standard_normal((5, 2, 3)) + 1j * rng.standard_normal((5, 2, 3))
    got = np.asarray(herm.herm_to_complex(herm.herm_from_mixing(A)))
    want = A @ A.conj().transpose(0, 2, 1)
    assert np.allclose(got, want, rtol=1e-5, atol=1e-6)


def test_det_floor():
    P = herm.pack_herm(np.zeros(3), np.zeros(3), np.zeros(3, complex))
    out = np.asarray(herm.inv(P, det_floor=1e-10))
    assert np.all(np.isfinite(out))
