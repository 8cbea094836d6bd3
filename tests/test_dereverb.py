"""WPE dereverberation (tf/dereverb.py) and band-EM votes
(spatial_init.band_em_votes)."""
import numpy as np
import pytest

from pyfasst_jax.tf.dereverb import wpe_dereverb


def _reverberant_plane(rng, fs=8000, dur=3.0, t60=0.35):
    """Single source through a synthetic exponential-decay RIR; returns
    (X reverberant STFT, D direct+early STFT)."""
    import jax.numpy as jnp

    from pyfasst_jax.tf.stft import _stft_core, sine_window

    from scipy.signal import butter, lfilter

    # noise-driven source: WPE removes the linearly-PREDICTABLE part of
    # each bin, so a stationary sine (perfectly predictable from delayed
    # frames) would be cancelled along with the tail -- that is a
    # documented property of linear-prediction dereverberation, not a
    # bug. Speech-like modulated noise is the design regime.
    n = int(fs * dur)
    t = np.arange(n) / fs
    b, a = butter(4, [0.05, 0.6], btype="band")
    s = lfilter(b, a, rng.standard_normal(n))
    s *= 1.0 + 0.8 * np.sin(2 * np.pi * 2.7 * t)
    L = int(t60 * fs)
    xs, ds = [], []
    for ch in range(2):
        h = rng.standard_normal(L) * np.exp(-3.0 * np.log(10)
                                            * np.arange(L) / L)
        h[0] = 2.0 + 0.5 * ch
        he = h.copy()
        he[int(0.01 * fs):] = 0.0
        xs.append(np.convolve(s, h)[:n])
        ds.append(np.convolve(s, he)[:n])
    w = jnp.asarray(sine_window(512), jnp.float32)
    X = np.asarray(_stft_core(jnp.asarray(np.stack(xs, 1), jnp.float32),
                              w, 512, 256, "fft"))
    D = np.asarray(_stft_core(jnp.asarray(np.stack(ds, 1), jnp.float32),
                              w, 512, 256, "fft"))
    return X, D


def test_wpe_raises_direct_to_reverb(rng):
    X, D = _reverberant_plane(rng)

    def drr(A):
        return 10 * np.log10(np.sum(np.abs(D) ** 2)
                             / np.sum(np.abs(A - D) ** 2))

    Xd = wpe_dereverb(X, order=8, delay=2, iters=3)
    assert Xd.shape == X.shape
    assert drr(Xd) > drr(X) + 1.0, (drr(X), drr(Xd))
    # direct component preserved: the magnitude plane still matches the
    # direct signal's (a complex inner product would phase-cancel across
    # bins and says nothing), and the output didn't collapse to silence
    a, d = np.abs(Xd).ravel(), np.abs(D).ravel()
    c = float(a @ d / (np.linalg.norm(a) * np.linalg.norm(d)))
    assert c > 0.8, c
    assert np.sum(np.abs(Xd) ** 2) > 0.25 * np.sum(np.abs(D) ** 2)


def test_wpe_contract():
    rng = np.random.default_rng(1)
    X = rng.standard_normal((17, 40, 2)) + 1j * rng.standard_normal(
        (17, 40, 2))
    Xd = wpe_dereverb(X, order=4, delay=2)
    assert Xd.shape == X.shape and Xd.dtype == X.dtype
    # too-short plane: passthrough copy
    Xs = X[:, :5]
    np.testing.assert_array_equal(wpe_dereverb(Xs, order=4, delay=2), Xs)
    with pytest.raises(ValueError, match="delay"):
        wpe_dereverb(X, delay=0)
    with pytest.raises(ValueError, match="F, N, I"):
        wpe_dereverb(X[..., 0])


def test_chain_glue_composition():
    """_chain_glue composes pairwise relative perms into a global band
    alignment: inv[b+1] = inv[b] rearranged by the glue, anchored at
    band 0; a known chain must invert exactly."""
    from pyfasst_jax.models.spatial_init import _chain_glue

    J = 3
    # rel[b][a] = stem of band b+1 glued to stem a of band b
    perms = np.array([[1, 2, 0],   # band1 stem1 carries band0 stem0's src
                      [0, 1, 2],   # identity link
                      [2, 1, 0]])  # swap outer
    inv = _chain_glue(perms, J)
    assert inv.shape == (4, J)
    np.testing.assert_array_equal(inv[0], [0, 1, 2])
    # every row is a permutation
    for b in range(4):
        assert sorted(inv[b]) == list(range(J))
    # chaining consistency: channel of band b stem a must equal channel
    # of band b+1 stem perms[b][a] (they are glued together)
    for b in range(3):
        np.testing.assert_array_equal(inv[b], inv[b + 1][perms[b]])


@pytest.mark.slow
def test_band_em_votes_beats_consensus_on_mini_fixture():
    """Model-evidence band votes must beat the clustering consensus votes
    on the miniature configs[2] draw (measured 0.918 vs 0.866 power-
    weighted oracle accuracy)."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).parent))
    from test_reverb_pipeline import _mini_configs2_fixture

    from pyfasst_jax.models.spatial_init import (
        band_em_votes, consensus_votes, tf_covariance_features,
    )
    from pyfasst_jax.tf.stft import STFT

    fs = 8000
    mix, ys_true = _mini_configs2_fixture(102, fs=fs)
    tft = STFT(wlen=512, fs=fs)
    X = np.asarray(tft.computeTransform(mix.astype(np.float32)))
    J = 3
    P = [(np.abs(np.asarray(tft.computeTransform(
        np.ascontiguousarray(ys_true[j]).astype(np.float32)))) ** 2
    ).sum(-1) for j in range(J)]
    olab = np.argmax(np.stack(P), axis=0)
    _, _, pw, _ = tf_covariance_features(X)

    def acc(lab):
        best = 0.0
        from itertools import permutations
        for p in permutations(range(J)):
            m = np.asarray(p)[lab] == olab
            best = max(best, float((pw * m).sum() / pw.sum()))
        return best

    v_cons = consensus_votes(X, J, n_seeds=4)
    v_all, detail = band_em_votes(X, J, band_width=32, iters=100,
                                  n_seeds=4, votes_init=v_cons,
                                  band_align="all+glue", glue_iters=10,
                                  return_detail=True)
    assert set(v_all) == {"envelope", "init", "spatial", "glue"}
    a_c = acc(np.argmax(v_cons, -1))
    a_b = acc(np.argmax(v_all["envelope"], -1))
    assert a_b > a_c - 0.02, (a_b, a_c)
    assert a_b > 0.85
    # the spatial plane is a measured-and-rejected variant (band-pooled
    # covariance centroids align only 30/72 oracle band pairs here --
    # spatial_init.band_em_votes docstring); assert mechanism only
    v_s = v_all["spatial"]
    assert v_s.shape == v_all["envelope"].shape
    np.testing.assert_allclose(v_s.sum(-1), 1.0, atol=1e-6)
    # the glue plane is likewise measured-and-rejected (design.md §6i:
    # never strictly beats init/envelope on any hard draw, margins
    # uninformative); assert mechanism only — valid vote plane and a
    # valid permutation per band in the chained alignment
    v_g = v_all["glue"]
    assert v_g.shape == v_all["envelope"].shape
    np.testing.assert_allclose(v_g.sum(-1), 1.0, atol=1e-6)
    inv_g = detail["inv"]["glue"]
    assert inv_g.shape[1] == J
    for row in inv_g:
        assert sorted(row) == list(range(J))
