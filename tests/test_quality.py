"""Realistic separation-quality tests: music-like time-domain mixtures scored
with BSS-Eval (the reference's quality regime, SURVEY.md §6)."""
import numpy as np
import pytest
from scipy.signal import lfilter

from pyfasst_jax.models import MultiChanNMFInst_FASST
from pyfasst_jax.utils.metrics import bss_eval_sources


def _music_like_sources(rng, fs, n):
    """A pseudo 'vocals' (vibrato harmonic phrase) and 'drums+bass'
    (transient clicks through a resonator + low square wave)."""
    t = np.arange(n) / fs
    # vocals: harmonic with vibrato and syllable-ish AM
    f0 = 220 * 2 ** (0.2 * np.sin(2 * np.pi * 0.9 * t))
    phase = 2 * np.pi * np.cumsum(f0) / fs
    am = 0.55 + 0.45 * np.clip(np.sin(2 * np.pi * 2.2 * t + 0.5), 0, None)
    vocals = am * sum((0.6 / h) * np.sin(h * phase) for h in range(1, 7))
    # drums: sparse impulses -> resonant filter; bass: low square
    impulses = np.zeros(n)
    impulses[np.arange(0, n, fs // 4)] = 1.0
    drums = lfilter([1.0], [1.0, -1.6, 0.73], impulses)
    drums += 0.02 * rng.standard_normal(n)
    bass = 0.25 * np.sign(np.sin(2 * np.pi * 55 * t))
    accomp = drums + bass
    vocals /= np.abs(vocals).max()
    accomp /= np.abs(accomp).max()
    return vocals, accomp


@pytest.mark.parametrize("seed", [0, 7])
def test_music_mixture_bss_eval(rng, seed):
    r = np.random.default_rng(seed)
    fs, dur = 16000, 5.0
    n = int(fs * dur)
    vocals, accomp = _music_like_sources(r, fs, n)
    a1, a2 = np.array([0.85, 0.53]), np.array([0.45, 0.89])
    y1 = vocals[:, None] * a1
    y2 = accomp[:, None] * a2
    mix = (y1 + y2).astype(np.float32)

    m = MultiChanNMFInst_FASST(mix, fs=fs, wlen=1024, iter_num=200,
                               nbComps=2, nbNMFComps=10, seed=seed)
    ll = m.estim_param_a_posteriori()
    assert np.all(np.isfinite(ll))
    ys = m.separated_images()                     # (2, n, 2)

    out = bss_eval_sources(ys.mean(axis=2), np.stack([y1, y2]).mean(axis=2),
                           filt_len=32)
    # music-like material, blind, 200 iterations: several-dB SDR expected
    assert out["sdr"].min() > 4.0, out
    assert out["sir"].min() > 6.0, out


def test_stress_no_nan_across_seeds(rng):
    """Randomized engine stress: varied seeds/durations/source counts must
    never produce non-finite likelihoods (the float32 collapse guard)."""
    fs = 8000
    for seed in range(4):
        r = np.random.default_rng(seed)
        dur = 1.0 + seed * 0.7
        n = int(fs * dur)
        t = np.arange(n) / fs
        s1 = np.sin(2 * np.pi * (150 + 60 * seed) * t) * (0.2 + 0.2 * seed)
        s2 = 0.3 * r.standard_normal(n)
        s3 = 0.15 * np.sign(np.sin(2 * np.pi * 3 * t)) \
            * np.sin(2 * np.pi * 800 * t)
        mixes = np.stack([0.9 * s1 + 0.4 * s2 + 0.2 * s3,
                          0.3 * s1 + 0.8 * s2 + 0.7 * s3], axis=1)
        m = MultiChanNMFInst_FASST(mixes.astype(np.float32), fs=fs,
                                   wlen=256, iter_num=120, nbComps=3,
                                   nbNMFComps=4, seed=seed)
        ll = m.estim_param_a_posteriori()
        assert np.all(np.isfinite(ll)), f"seed {seed}"
        ys = m.separated_images()
        assert np.all(np.isfinite(ys)), f"seed {seed}"
