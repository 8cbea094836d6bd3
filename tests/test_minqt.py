"""Min-Q / constant-Q transform tests."""
import numpy as np
import pytest

from pyfasst_jax.tf.minqt import MinQTransfo, minqt_kernel


def test_kernel_shapes_and_peak_response():
    fs, wlen, B = 16000, 2048, 96
    K = minqt_kernel(fs, wlen, B, 60.0, 7000.0)
    assert K.shape == (wlen, B)
    tr = MinQTransfo(fs=fs, wlen=wlen, n_bins=B, fmin=60, fmax=7000)
    # a pure tone excites the matching log-frequency bin most
    for f0 in (110.0, 440.0, 1760.0):
        t = np.arange(4 * wlen) / fs
        x = np.sin(2 * np.pi * f0 * t)
        Xb = np.asarray(tr.computeTransform(x))
        mag = np.abs(Xb[:, Xb.shape[1] // 2])
        k_peak = int(np.argmax(mag))
        k_true = int(np.argmin(np.abs(tr.freqs - f0)))
        assert abs(k_peak - k_true) <= 2, (f0, k_peak, k_true)


def test_minqt_roundtrip_on_band_limited_signal(rng):
    fs, wlen = 16000, 2048
    tr = MinQTransfo(fs=fs, wlen=wlen, n_bins=160, fmin=80, fmax=6000,
                     hop=wlen // 4)
    n = 8 * wlen
    t = np.arange(n) / fs
    x = (np.sin(2 * np.pi * 220 * t) + 0.5 * np.sin(2 * np.pi * 880 * t)
         ).astype(np.float32)
    Xb = tr.computeTransform(x)
    y = np.asarray(tr.invertTransform(Xb, nsamples=n))
    # band-limited projection: compare away from the edges
    sl = slice(wlen, n - wlen)
    err = (np.linalg.norm(y[sl] - x[sl]) / np.linalg.norm(x[sl]))
    assert err < 0.25, err


def test_minqt_stereo_shapes(rng):
    tr = MinQTransfo(fs=8000, wlen=1024, n_bins=48, fmin=60, fmax=3500)
    x = rng.standard_normal((5000, 2)).astype(np.float32)
    Xb = np.asarray(tr.computeTransform(x))
    assert Xb.shape[0] == 48 and Xb.shape[2] == 2
    y = np.asarray(tr.invertTransform(Xb))
    assert y.shape == (5000, 2)


def test_fasst_over_minqt_front_end(rng):
    """MinQT plugs in as the model front-end (reference runs FASST over
    MinQT coefficients -- SURVEY.md §3.1); its inverse is a band-limited
    projection, so the bar is a finite, improving run, not exact PR."""
    from pyfasst_jax.models.variants import MultiChanNMFInst_FASST

    fs, T = 8000, 6000
    t = np.arange(T) / fs
    s1 = np.sin(2 * np.pi * 440 * t)
    s2 = rng.standard_normal(T)
    mix = (np.outer(s1, [0.9, 0.3]) + np.outer(s2, [0.3, 0.9])).astype(
        np.float32)
    tr = MinQTransfo(fs=fs, wlen=1024, n_bins=36, fmin=60, fmax=3500)
    model = MultiChanNMFInst_FASST(mix, fs=fs, nbComps=2, nbNMFComps=3,
                                   iter_num=12, transform=tr)
    assert model.F == 36
    lls = model.estim_param_a_posteriori()
    assert np.all(np.isfinite(lls)) and lls[-1] > lls[0]
    ys = model.separated_images()
    assert ys.shape == (2, T, 2) and np.all(np.isfinite(ys))


def test_freq_basis_rejected_over_minqt():
    """MinQT HAS a wlen attribute but its bins are log-spaced; the
    freq_basis guard must still reject it (keys on name, not wlen)."""
    import pytest as _pytest

    from pyfasst_jax.models.variants import MultiChanNMFInst_FASST

    tr = MinQTransfo(fs=8000, wlen=1024, n_bins=24, fmin=60, fmax=3500)
    with _pytest.raises(ValueError, match="STFT front-end"):
        MultiChanNMFInst_FASST(np.zeros((4000, 2), np.float32), fs=8000,
                               freq_basis="erb", transform=tr)
