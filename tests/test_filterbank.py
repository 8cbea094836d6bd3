"""ERB/Mel filterbank tests (SURVEY.md §4: filterbank frame bounds)."""
import numpy as np

from pyfasst_jax.tf.filterbank import (
    ERBTransform, erb_filterbank, mel_filterbank, spectral_basis,
    hz_to_erb, erb_to_hz,
)


def test_scale_roundtrip():
    f = np.array([100.0, 1000.0, 8000.0])
    assert np.allclose(erb_to_hz(hz_to_erb(f)), f, rtol=1e-10)


def test_partition_of_unity_interior():
    F, fs, wlen = 513, 44100, 1024
    bank = erb_filterbank(60, F, fs, wlen, fmin=50, fmax=18000)
    freqs = np.arange(F) * fs / wlen
    interior = (freqs > 200) & (freqs < 15000)
    colsum = bank.sum(axis=0)
    assert np.all(colsum[interior] > 0.5)
    assert np.all(colsum[interior] < 1.5)


def test_spectral_basis_shape_and_norm():
    FB = spectral_basis("erb", 40, 513, 44100, 1024)
    assert FB.shape == (513, 40)
    s = FB.sum(axis=0)
    assert np.allclose(s[s > 0], 1.0, atol=1e-9)
    FBm = spectral_basis("mel", 40, 513, 44100, 1024)
    assert FBm.shape == (513, 40)


def test_erb_transform_roundtrip_smooth_signal(rng):
    # Band-limited projection: a smooth (in-band) signal survives
    # analysis+dual-synthesis with moderate error.
    fs, n = 16000, 8000
    t = np.arange(n) / fs
    x = np.sin(2 * np.pi * 440 * t) + 0.5 * np.sin(2 * np.pi * 880 * t)
    tr = ERBTransform(n_bands=120, wlen=512, fs=fs, fmin=50, fmax=7500)
    Xb = tr.computeTransform(x)
    assert Xb.shape[0] == 120
    y = np.asarray(tr.invertTransform(Xb, nsamples=n))
    err = np.linalg.norm(y - x) / np.linalg.norm(x)
    assert err < 0.15, err


def test_full_coverage_every_bin():
    """Every frequency row must be representable: bank coverage == 1
    everywhere (shelf edges). A coverage hole makes those bins
    unrepresentable and collapses the annealed likelihood on broadband
    audio (observed before the fix)."""
    from pyfasst_jax.tf.filterbank import erb_filterbank, mel_filterbank
    for fb in (erb_filterbank(32, 513, 16000, 1024),
               mel_filterbank(12, 129, 8000, 256)):
        cov = fb.sum(0)
        np.testing.assert_allclose(cov, 1.0, rtol=1e-9)
