"""Blind mono init (models/mono.py): mixture IS-NMF + envelope clustering.

Quality evidence at validation scale lives in tools/mono_ceiling.py +
docs/design.md §6h (random 3.2 -> nmf-cluster 11.5 dB min SDR on
hardware); these tests pin the mechanism at CPU shapes: the factorization,
the grouping, the init application, and the end-to-end advantage over a
random init on a small separable fixture.
"""
import numpy as np
import pytest

from pyfasst_jax.models.mono import is_nmf, nmf_cluster_init


def _mono_fixture(fs=8000, dur=3.0, seed=0):
    """Tone stack + gated low noise, spectrally and temporally distinct."""
    rng = np.random.default_rng(seed)
    n = int(fs * dur)
    t = np.arange(n) / fs
    harm = sum(np.sin(2 * np.pi * 220 * (k + 1) * t) / (k + 1)
               for k in range(5))
    harm *= 1 + 0.5 * np.sin(2 * np.pi * 1.7 * t)
    lo = np.convolve(rng.standard_normal(n), np.ones(16) / 16, "same")
    lo *= (np.sin(2 * np.pi * 0.9 * t) > 0)
    srcs = [s / (np.std(s) + 1e-9) for s in (harm, lo)]
    ys = np.stack([s[:, None] for s in srcs])
    return ys.sum(0).astype(np.float32), ys


def test_is_nmf_reduces_divergence():
    rng = np.random.default_rng(0)
    P = rng.random((32, 40)) + 0.1
    W, H = is_nmf(P, 4, iters=100, seed=1)

    def isd(P, V):
        R = P / V
        return float(np.sum(R - np.log(R) - 1.0))

    W0 = 0.5 + np.random.default_rng(1).random((32, 4))
    H0 = 0.5 + np.random.default_rng(1).random((4, 40))
    assert isd(P, np.maximum(W @ H, 1e-9)) < isd(P, W0 @ H0)
    # normalization contract: unit-sum basis columns
    np.testing.assert_allclose(W.sum(0), 1.0, rtol=1e-6)


def test_nmf_cluster_init_shapes_and_grouping():
    from pyfasst_jax.tf.stft import STFT

    mix, ys = _mono_fixture()
    tft = STFT(wlen=512, fs=8000)
    X = np.asarray(tft.computeTransform(mix))
    K = 4
    init = nmf_cluster_init(X, J=2, nmf_comps=K)
    assert len(init) == 2
    F = X.shape[0]
    for W, H in init:
        assert W.shape == (F, K) and H.shape == (K, X.shape[1])
        assert np.all(W >= 0) and np.all(H > 0)
    # the two sources' dominant basis columns should concentrate in
    # different frequency regions (tone stack low/discrete vs noise)
    c0 = (np.arange(F) @ init[0][0][:, 0]) / init[0][0][:, 0].sum()
    c1 = (np.arange(F) @ init[1][0][:, 0]) / init[1][0][:, 0].sum()
    assert abs(c0 - c1) > 3.0


def test_blind_mono_beats_random_init():
    from itertools import permutations

    from pyfasst_jax.models.variants import MultiChanNMFInst_FASST

    mix, ys_true = _mono_fixture()

    def run(blind_mono):
        m = MultiChanNMFInst_FASST(mix, fs=8000, nbComps=2, nbNMFComps=4,
                                   wlen=512, iter_num=60, seed=0)
        if blind_mono:
            m.estim_param_blind_mono()
        else:
            m.estim_param_a_posteriori()
        est = m.separated_images()

        def sdr(e, r):
            return 10 * np.log10(np.sum(r ** 2)
                                 / max(np.sum((e - r) ** 2), 1e-12))

        return max(min(sdr(est[p[j]], ys_true[j]) for j in range(2))
                   for p in permutations(range(2)))

    rand = run(False)
    clus = run(True)
    assert clus > rand + 2.0, f"nmf-cluster {clus:.2f} vs random {rand:.2f}"
    assert clus > 5.0, f"nmf-cluster min SDR {clus:.2f} dB"


def test_blind_mono_rejects_multichannel():
    from pyfasst_jax.models.variants import MultiChanNMFInst_FASST

    rng = np.random.default_rng(0)
    stereo = rng.standard_normal((4000, 2)).astype(np.float32)
    m = MultiChanNMFInst_FASST(stereo, fs=8000, nbComps=2, nbNMFComps=3,
                               wlen=256, iter_num=5, seed=0)
    with pytest.raises(ValueError, match="mono"):
        m.estim_param_blind_mono()


def test_nmf_cluster_init_degenerate_fallback():
    """A rank-1 mixture (every NMF component shares one envelope) makes
    every k-means restart collapse to < J clusters; the init must fall
    back to round-robin labels (mono.py fallback path) and still return
    J well-formed (FB, TW) pairs."""
    from pyfasst_jax.models.mono import nmf_cluster_init

    rng = np.random.default_rng(3)
    w = rng.random(65) + 0.1
    h = rng.random(40) + 0.1
    X = np.sqrt(np.outer(w, h)).astype(np.complex128)   # rank-1 power
    init = nmf_cluster_init(X, J=3, nmf_comps=4)
    assert len(init) == 3
    for FB, TW in init:
        assert FB.shape == (65, 4) and TW.shape == (4, 40)
        assert np.all(FB >= 0) and np.all(TW > 0)
        assert np.isfinite(FB).all() and np.isfinite(TW).all()
