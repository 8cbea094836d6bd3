"""AudioObject WAV round-trip tests."""
import numpy as np

from pyfasst_jax.audio import AudioObject, wavread, wavwrite


def test_wav_roundtrip_pcm16(tmp_path, rng):
    x = 0.5 * rng.standard_normal((4410, 2)).clip(-1, 1)
    path = tmp_path / "t.wav"
    wavwrite(x, 44100, str(path))
    y, sr = wavread(str(path))
    assert sr == 44100
    assert y.shape == x.shape
    assert np.max(np.abs(y - x)) < 2.0 / 2 ** 15


def test_mono_promoted_to_2d(rng):
    obj = AudioObject(data=rng.standard_normal(100), samplerate=8000)
    assert obj.data.shape == (100, 1)
    assert obj.channels == 1
    assert obj.nsamples == 100
    assert abs(obj.duration - 100 / 8000) < 1e-12
