"""STFT/ISTFT unit tests (SURVEY.md §4: perfect reconstruction < 1e-6 rel err)."""
import numpy as np
import pytest

from pyfasst_jax.tf import STFT, stft, istft


@pytest.mark.parametrize("wlen,hop", [(256, 128), (256, 64), (1024, 512)])
@pytest.mark.parametrize("channels", [1, 2])
def test_perfect_reconstruction(rng, wlen, hop, channels):
    n = 8000
    x = rng.standard_normal((n, channels)) if channels > 1 else \
        rng.standard_normal(n)
    X = stft(x, wlen=wlen, hop=hop)
    y = np.asarray(istft(X, nsamples=n, wlen=wlen, hop=hop))
    rel = np.linalg.norm(y - x) / np.linalg.norm(x)
    assert rel < 1e-6, rel


def test_shapes_and_object_api(rng):
    n = 44100
    x = rng.standard_normal((n, 2))
    tr = STFT(wlen=1024, hop=512, fs=44100)
    X = tr.computeTransform(x)
    assert X.shape[0] == 513  # F = wlen//2 + 1
    assert X.shape[2] == 2
    assert X.shape[1] == tr.n_frames(n)
    y = np.asarray(tr.invertTransform(X))
    assert y.shape == (n, 2)
    assert np.linalg.norm(y - x) / np.linalg.norm(x) < 1e-6


def test_matmul_dft_matches_fft(rng):
    x = rng.standard_normal(4000)
    Xf = np.asarray(stft(x, wlen=256, hop=128, method="fft"))
    Xm = np.asarray(stft(x, wlen=256, hop=128, method="matmul"))
    # float32 accumulation over wlen taps: ~1e-5 relative is the honest bound
    assert np.max(np.abs(Xf - Xm)) < 1e-4 * np.max(np.abs(Xf))


def test_sinusoid_peak_bin(rng):
    fs, wlen = 16000, 512
    f0 = 1000.0
    t = np.arange(16000) / fs
    x = np.sin(2 * np.pi * f0 * t)
    X = np.asarray(stft(x, wlen=wlen, hop=256))
    mag = np.abs(X[:, X.shape[1] // 2])
    peak_hz = np.argmax(mag) * fs / wlen
    assert abs(peak_hz - f0) <= fs / wlen
