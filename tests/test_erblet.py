"""Perfect-reconstruction ERBlet transform tests (VERDICT r1 #7).

The pass bar from the round-1 verdict: invert(compute(x)) ~ x to < 1e-5 on
broadband noise -- true PR, unlike filterbank.ERBTransform's band-limited
projection.
"""
import numpy as np
import pytest

from pyfasst_jax.tf.erblet import ERBLetTransform


@pytest.mark.parametrize("fs,n_bands,T", [
    (16000, 64, 16000),        # 1 s
    (16000, 40, 12345),        # non-multiple-of-hop length
    (44100, 80, 22050),
])
def test_perfect_reconstruction_broadband(rng, fs, n_bands, T):
    t = ERBLetTransform(fs=fs, n_bands=n_bands)
    x = rng.standard_normal(T).astype(np.float32)
    C = t.computeTransform(x)
    assert C.shape[0] == n_bands and np.iscomplexobj(C)
    y = np.asarray(t.invertTransform(C))
    assert y.shape == x.shape
    rel = np.abs(y - x).max() / np.abs(x).max()
    assert rel < 1e-5, rel


def test_perfect_reconstruction_stereo(rng):
    t = ERBLetTransform(fs=16000, n_bands=48)
    x = rng.standard_normal((8000, 2)).astype(np.float32)
    y = np.asarray(t.invertTransform(t.computeTransform(x)))
    rel = np.abs(y - x).max() / np.abs(x).max()
    assert rel < 1e-5, rel


def test_analyze_modify_resynthesize(rng):
    """The reference capability the projection transform lacked: zeroing
    bands removes exactly those bands' content from the resynthesis."""
    fs, T = 16000, 16000
    t = ERBLetTransform(fs=fs, n_bands=64)
    time = np.arange(T) / fs
    lo = np.sin(2 * np.pi * 200 * time)            # low-band tone
    hi = np.sin(2 * np.pi * 5000 * time)           # high-band tone
    C = np.array(t.computeTransform((lo + hi).astype(np.float32)))
    centers = t.band_centers()
    keep = centers < 1000.0                        # kill everything >= 1 kHz
    C[~keep] = 0.0
    y = np.asarray(t.invertTransform(C, nsamples=T))
    # interior (edge bands taper): low tone preserved, high tone gone
    sl = slice(T // 8, -T // 8)
    num = np.sum((y[sl] - lo[sl]) ** 2)
    assert 10 * np.log10(np.sum(lo[sl] ** 2) / num) > 30.0
    assert np.abs(y[sl] @ hi[sl]) / np.sqrt(
        (y[sl] @ y[sl]) * (hi[sl] @ hi[sl])) < 0.02


def test_tone_band_localization(rng):
    fs, T = 16000, 8192
    t = ERBLetTransform(fs=fs, n_bands=64)
    time = np.arange(T) / fs
    for f0 in (150.0, 440.0, 2000.0, 6000.0):
        C = np.abs(np.asarray(
            t.computeTransform(np.sin(2 * np.pi * f0 * time))))
        b_peak = int(np.argmax(C.mean(axis=1)))
        b_true = int(np.argmin(np.abs(t.band_centers() - f0)))
        assert abs(b_peak - b_true) <= 1, (f0, b_peak, b_true)


def test_perfect_reconstruction_log_scale(rng):
    """scale='log' = perfect-reconstruction constant-Q (NSGT-CQ analog)."""
    t = ERBLetTransform(fs=16000, n_bands=56, scale="log", fmin=60.0)
    # geometric spacing: constant ratio between interior centers
    c = t.band_centers()[1:]
    ratios = c[1:] / c[:-1]
    assert np.allclose(ratios[:-1], ratios[0], rtol=1e-6)
    x = rng.standard_normal(12000).astype(np.float32)
    y = np.asarray(t.invertTransform(t.computeTransform(x)))
    rel = np.abs(y - x).max() / np.abs(x).max()
    assert rel < 1e-5, rel


def test_bad_scale_rejected():
    with pytest.raises(ValueError, match="scale"):
        ERBLetTransform(fs=16000, scale="linear")


def test_fasst_over_erblet_front_end(rng):
    """The GEM engine runs directly in the warped subband domain (the
    reference runs FASST over its NSGT coefficients -- SURVEY.md §3.1)."""
    from pyfasst_jax.models.variants import MultiChanNMFInst_FASST

    fs, T = 8000, 8000
    time = np.arange(T) / fs
    s1 = np.sin(2 * np.pi * 320 * time) * (1 + 0.5 * np.sin(
        2 * np.pi * 2 * time))
    s2 = rng.standard_normal(T) * (np.sin(2 * np.pi * 1.1 * time) > 0)
    y1 = np.outer(s1, [0.95, 0.31]).astype(np.float32)
    y2 = np.outer(s2, [0.31, 0.95]).astype(np.float32)
    tft = ERBLetTransform(fs=fs, n_bands=40)
    model = MultiChanNMFInst_FASST(y1 + y2, fs=fs, nbComps=2, nbNMFComps=4,
                                   iter_num=60, transform=tft)
    assert model.F == 40                      # engine sees the band axis
    lls = model.estim_param_a_posteriori()
    assert np.all(np.isfinite(lls))
    ys = model.separated_images()             # (J, T, 2) via the exact dual
    assert ys.shape == (2, T, 2) and np.all(np.isfinite(ys))

    def sdr(e, r):
        return 10 * np.log10(np.sum(r ** 2)
                             / max(np.sum((e - r) ** 2), 1e-12))

    best = max(min(sdr(ys[p[0]], y1), sdr(ys[p[1]], y2))
               for p in [(0, 1), (1, 0)])
    assert best > 5.0, best                   # genuinely separates
    # posterior Wiener images conserve the mixture as sigma_b -> 0
    rel = np.abs(ys.sum(0) - (y1 + y2)).max() / np.abs(y1 + y2).max()
    assert rel < 0.15, rel


def test_freq_basis_guard_on_warped_front_end():
    from pyfasst_jax.models.variants import MultiChanNMFInst_FASST

    tft = ERBLetTransform(fs=8000, n_bands=32)
    with pytest.raises(ValueError, match="STFT front-end"):
        MultiChanNMFInst_FASST(np.zeros((4000, 2), np.float32), fs=8000,
                               freq_basis="erb", transform=tft)


def test_frame_bounds_and_hop_guard():
    t = ERBLetTransform(fs=16000, n_bands=64)
    A, B = t.frame_bounds(16000)
    assert A > 0.1 and B / A < 10.0                # snug frame
    bad = ERBLetTransform(fs=16000, n_bands=64, hop=4096)
    with pytest.raises(ValueError, match="hop"):
        bad.computeTransform(np.zeros(16000, np.float32))


# -- multi-rate (per-band decimation groups) ----------------------------------

def test_multirate_perfect_reconstruction(rng):
    """MultiRateERBLet: exact PR from the rate-group list (mono + stereo),
    at a fraction of the uniform-hop coefficient count."""
    from pyfasst_jax.tf.erblet import MultiRateERBLet

    t = MultiRateERBLet(fs=16000, n_bands=64)
    x = rng.standard_normal(16000).astype(np.float32)
    Cs = t.computeTransform(x)
    assert isinstance(Cs, list) and len(Cs) >= 2      # several rate groups
    y = np.asarray(t.invertTransform(Cs))
    rel = np.abs(y - x).max() / np.abs(x).max()
    assert rel < 1e-5, rel

    xs = rng.standard_normal((12345, 2)).astype(np.float32)
    Cs = t.computeTransform(xs)
    ys = np.asarray(t.invertTransform(Cs))
    rel = np.abs(ys - xs).max() / np.abs(xs).max()
    assert rel < 1e-5, rel


def test_multirate_redundancy_saving():
    """The point of the exercise: per-band rates cut the uniform-hop
    coefficient count by >= 3x at auditory band counts (measured overhead
    of the uniform hop is 8-12x vs per-band minimal rates -- tf/erblet.py
    docstring), and the group partition covers every band exactly once."""
    from pyfasst_jax.tf.erblet import MultiRateERBLet

    for fs, n_bands in ((16000, 64), (44100, 80)):
        t = MultiRateERBLet(fs=fs, n_bands=n_bands)
        t.computeTransform(np.zeros(fs, np.float32))  # build geometry
        r = t.redundancy(fs)
        assert r < 0.35, (fs, n_bands, r)
        bands = np.concatenate(t.group_bands)
        assert sorted(bands.tolist()) == list(range(n_bands))


def test_multirate_log_scale_and_bad_decimation(rng):
    from pyfasst_jax.tf.erblet import MultiRateERBLet

    t = MultiRateERBLet(fs=16000, n_bands=48, scale="log")
    x = rng.standard_normal(8000).astype(np.float32)
    y = np.asarray(t.invertTransform(t.computeTransform(x)))
    assert np.abs(y - x).max() / np.abs(x).max() < 1e-5
    with pytest.raises(ValueError, match="power of two"):
        MultiRateERBLet(fs=16000, max_decimation=3)


def test_multirate_band_energy_matches_uniform(rng):
    """Coefficient amplitudes are rate-normalized: a band's total energy
    (sum |c|^2 * d, i.e. per-signal-sample) matches the uniform-hop
    transform's for the same band."""
    from pyfasst_jax.tf.erblet import ERBLetTransform, MultiRateERBLet

    fs, n_bands, T = 16000, 48, 16000
    x = rng.standard_normal(T).astype(np.float32)
    tu = ERBLetTransform(fs=fs, n_bands=n_bands)
    tm = MultiRateERBLet(fs=fs, n_bands=n_bands, hop=tu.hop)
    Cu = np.asarray(tu.computeTransform(x))
    Cs = tm.computeTransform(x)
    Eu = (np.abs(Cu) ** 2).sum(axis=1)                 # (B,)
    geo = tm._geometry(T)
    for g, Cb in zip(geo["groups"], Cs):
        Cb = np.asarray(Cb)
        for r_, b in enumerate(g["bands_np"]):
            Em = (np.abs(Cb[r_]) ** 2).sum() * g["d"]
            # the two transforms pad to slightly different lengths (N0
            # rounds up to a multiple of max_decimation), so band windows
            # sit on slightly different bin grids; allow a few %
            assert abs(Em - Eu[b]) <= 0.08 * max(Eu[b], 1e-9), (b, Em, Eu[b])
