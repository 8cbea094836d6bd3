"""Blind reverberant separation pipeline (models/reverb.py).

The quality claim (configs[2] target: min-SDR median >= 8 dB over fixture
draws) is validated on hardware by tools/reverb_robustness.py; these tests
pin the mechanism at small shapes: the selection order, the reseed vote
extraction, and the end-to-end pipeline contract (shapes, conservation of
the winner's statistics, acceptance monotonicity of the rule).
"""
import numpy as np
import pytest

from pyfasst_jax.models.reverb import (
    _hard_votes_from_sep, blind_reverb_separate, selection_key,
)


def test_selection_key_order():
    healthy = {"name": "raw", "envcorr": 0.3, "min_share": 0.2,
               "final_ll": 10.0}
    healthier = {"name": "merge(0,1)+split(0)", "envcorr": 0.2,
                 "min_share": 0.2, "final_ll": 5.0}
    dup = {"name": "raw", "envcorr": 0.9, "min_share": 0.2,
           "final_ll": 100.0}
    vanished = {"name": "raw", "envcorr": 0.1, "min_share": 0.001,
                "final_ll": 100.0}
    # lower envcorr beats higher ll (the measured ranking); any veto loses
    order = sorted([dup, vanished, healthy, healthier], key=selection_key)
    assert order[0] is healthier and order[1] is healthy
    assert selection_key(dup)[0] and selection_key(vanished)[0]
    # ll breaks exact envcorr ties
    a = {"name": "raw", "envcorr": 0.3, "min_share": 0.2, "final_ll": 10.0}
    b = {"name": "raw", "envcorr": 0.3, "min_share": 0.2, "final_ll": 20.0}
    assert selection_key(b) < selection_key(a)
    # tier: an unvetoed direction-split run loses to ANY unvetoed tier-0
    # run (measured: dirs candidates game the envelope statistic via
    # frequency interleaving), but still beats vetoed runs
    decoy = {"name": "dirs3+alloc(2, 1, 1)#s0", "envcorr": 0.01,
             "min_share": 0.1, "final_ll": 100.0}
    assert selection_key(healthy) < selection_key(decoy)
    assert selection_key(decoy) < selection_key(dup)
    explicit = {"name": "whatever", "tier": 1, "envcorr": 0.01,
                "min_share": 0.1, "final_ll": 100.0}
    assert selection_key(explicit)[1] == 1


def test_selection_key_consistency_mode():
    """select='consistency' orders unvetoed same-tier runs by DESCENDING
    cross-seed consistency; veto and tier still dominate; runs without
    the statistic rank after any run that has it; envcorr then ll break
    ties (design.md §6g)."""
    hi = {"name": "bandem", "envcorr": 0.3, "min_share": 0.2,
          "final_ll": 5.0, "consistency": 0.95}
    lo = {"name": "raw", "envcorr": 0.1, "min_share": 0.2,
          "final_ll": 50.0, "consistency": 0.7}
    none = {"name": "single", "envcorr": 0.05, "min_share": 0.2,
            "final_ll": 99.0}
    vetoed = {"name": "dup", "envcorr": 0.9, "min_share": 0.2,
              "final_ll": 99.0, "consistency": 0.99}
    tier1 = {"name": "dirs2+alloc(1, 1)#s0", "envcorr": 0.01,
             "min_share": 0.2, "final_ll": 99.0, "consistency": 0.999}
    key = lambda r: selection_key(r, select="consistency")
    order = sorted([lo, vetoed, none, hi, tier1], key=key)
    assert order == [hi, lo, none, tier1, vetoed]
    # default mode ignores the consistency field entirely
    assert selection_key(lo) < selection_key(hi)
    # ties fall through to envcorr then ll
    a = dict(hi, envcorr=0.2)
    assert key(a) < key(hi)


def test_blind_reverb_consistency_select():
    """select='consistency' end to end: every candidate runs >= 2 spectral
    seeds in one chunk, the cross-seed statistic is computed and the
    winner carries it. Mechanism test; the quality evidence (speech +
    family-1 gate) lives in tools/bandem_pool_lab.py + design.md §6g."""
    X = _reverb_mixture(seed=9)
    Y, info = blind_reverb_separate(
        X, J=2, iters=30, em_seeds=2, reseed_rounds=1, nmf_comps=3,
        chunk=4, n_seeds=3, select="consistency")
    assert Y.shape == (2,) + X.shape
    assert np.all(np.isfinite(Y.view(np.float64)))
    assert "consistency" in info
    assert -1.0 <= info["consistency"] <= 1.0


def test_blind_reverb_select_auto_resolution():
    """select=None auto-resolves to 'consistency' ONLY at its measured
    operating point — em_seeds >= 2 AND band-EM candidates in the pool
    (VERDICT r4 item 7; the round-5 gate re-run measured BARE-pool
    consistency collapsing draw 102 to 0.31 dB, so the bare pool keeps
    'envcorr'). The resolved rule is recorded in info['select']."""
    X = _reverb_mixture(seed=9)
    _, info2 = blind_reverb_separate(
        X, J=2, iters=20, em_seeds=2, reseed_rounds=0, nmf_comps=3,
        chunk=4, n_seeds=3, band_em=16)
    assert info2["select"] == "consistency"
    assert "consistency" in info2
    _, info_bare = blind_reverb_separate(
        X, J=2, iters=20, em_seeds=2, reseed_rounds=0, nmf_comps=3,
        chunk=4, n_seeds=3)
    assert info_bare["select"] == "envcorr"
    _, info1 = blind_reverb_separate(
        X, J=2, iters=20, em_seeds=1, reseed_rounds=0, nmf_comps=3,
        chunk=4, n_seeds=3)
    assert info1["select"] == "envcorr"


def test_blind_reverb_guarded_reseed_acceptance():
    """reseed_select='envcorr' under select='consistency': reseed rounds
    are accepted only when the envelope-correlation key improves (a
    warm-restart reseed's cross-seed consistency is structurally
    inflated, design.md §6g). Every reseed history entry records the
    accept/reject decision; keep_pool_sep exposes the pool-stage winner
    so labs can score both stages from ONE pool run."""
    X = _reverb_mixture(seed=9)
    Y, info = blind_reverb_separate(
        X, J=2, iters=30, em_seeds=2, reseed_rounds=2, nmf_comps=3,
        chunk=4, n_seeds=3, select="consistency", reseed_select="envcorr",
        keep_pool_sep=True)
    assert Y.shape == (2,) + X.shape
    assert np.all(np.isfinite(Y.view(np.float64)))
    assert info["pool_picked"] == info["history"][0]["picked"]
    assert info["pool_Y"].shape == Y.shape
    reseed_stages = [h for h in info["history"]
                     if h["stage"].startswith("reseed")]
    assert reseed_stages, "at least one reseed round must have run"
    for h in reseed_stages:
        assert "accepted" in h and "candidate" in h
        if not h["accepted"]:
            # rejected reseed leaves the pick unchanged
            assert h["picked"] == info["history"][0]["picked"] or any(
                p["accepted"] for p in reseed_stages
                if p["stage"] < h["stage"])
    if not any(h["accepted"] for h in reseed_stages):
        assert info["picked"] == info["pool_picked"]
        np.testing.assert_allclose(Y, info["pool_Y"], rtol=0, atol=0)


def test_hard_votes_from_sep():
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    Y = rng.standard_normal((3, 5, 7, 2)) + 1j * rng.standard_normal(
        (3, 5, 7, 2))
    votes = _hard_votes_from_sep(jnp.asarray(Y), 3)
    want = np.argmax(np.sum(np.abs(Y) ** 2, axis=3), axis=0)
    assert votes.shape == (5, 7, 3)
    assert np.array_equal(votes.argmax(-1), want)
    assert np.array_equal(votes.sum(-1), np.ones((5, 7)))


def test_band_coherence_flags_interleaving():
    """A stem assembled from per-frequency permutation errors interleaves
    sources across bands -> low within-stem band coherence; honest stems
    (each one source, all bands co-modulating) score high."""
    import jax.numpy as jnp

    from pyfasst_jax.models.spatial_init import _min_band_coherence

    rng = np.random.default_rng(1)
    F, N = 64, 200
    e1 = 1.0 + 0.9 * np.sin(2 * np.pi * np.arange(N) / 23.0)
    e2 = 1.0 + 0.9 * (np.sin(2 * np.pi * np.arange(N) / 7.0) > 0)
    s1 = rng.standard_normal((F, N)) * e1[None, :]
    s2 = rng.standard_normal((F, N)) * e2[None, :]

    def stem(mag):
        z = mag * np.exp(1j * rng.uniform(0, 2 * np.pi, mag.shape))
        return np.stack([z, 0.8 * z], -1)            # (F, N, 2)

    honest = jnp.asarray(np.stack([stem(s1), stem(s2)]))
    # interleaved: alternate 8-bin bands between the two sources
    m = (np.arange(F) // 8) % 2 == 0
    i1 = np.where(m[:, None], s1, s2)
    i2 = np.where(m[:, None], s2, s1)
    inter = jnp.asarray(np.stack([stem(i1), stem(i2)]))
    c_honest = float(_min_band_coherence(honest))
    c_inter = float(_min_band_coherence(inter))
    assert c_honest > 0.6
    assert c_inter < c_honest - 0.3


def _reverb_mixture(F=65, N=96, J=2, seed=0):
    """Two spectrally+spatially distinct sources with per-frequency
    mixing wobble (mild reverberant part)."""
    rng = np.random.default_rng(seed)
    a = np.array([[1.0, 0.3], [0.25, 1.0]], complex)
    wob = np.exp(1j * 0.5 * np.sin(np.arange(F) / 5.0))
    A = np.stack([np.stack([a[j, 0] * np.ones(F), a[j, 1] * wob ** (j + 1)],
                           -1) for j in range(J)])   # (J, F, 2)
    on = ((np.arange(N) // 12) % 2 == 0)
    gain = np.stack([np.where(on, 1.0, 0.05), np.where(on, 0.05, 1.0)])
    band = np.stack([np.exp(-((np.arange(F) - 18) / 12.0) ** 2),
                     np.exp(-((np.arange(F) - 44) / 12.0) ** 2)]) + 0.05
    s = (rng.standard_normal((J, F, N)) + 1j * rng.standard_normal(
        (J, F, N))) * gain[:, None, :] * band[:, :, None]
    X = np.einsum('jfi,jfn->fni', A, s)
    return X


def test_blind_reverb_separate_end_to_end():
    X = _reverb_mixture()
    Y, info = blind_reverb_separate(
        X, J=2, iters=40, em_seeds=1, reseed_rounds=1, nmf_comps=3,
        chunk=4, n_seeds=3)
    assert Y.shape == (2,) + X.shape
    assert np.all(np.isfinite(Y.view(np.float64)))
    # the winner's blind stats are recorded and coherent (envcorr is a
    # CENTERED correlation: anti-correlated alternating sources go to -1)
    assert -1.0 <= info["envcorr"] <= 1.0
    assert 0.0 <= info["min_share"] <= 0.5
    assert len(info["history"]) >= 1
    # separated energy is a sane fraction of the mixture's
    pm = float(np.sum(np.abs(X) ** 2))
    ps = float(np.sum(np.abs(Y) ** 2))
    assert 0.2 * pm < ps < 3.0 * pm


def _mini_configs2_fixture(seed, fs=8000, dur=4.0):
    """Miniature configs[2]-family draw: three spectrally distinct
    amplitude-modulated sources (harmonic / gated low noise / modulated
    high noise -- the same kinds as tools/validate_hw.py::_sources) mixed
    through short exponential-decay random stereo filters. Small enough
    for CPU (F = 257, 4 s) yet reverberant enough that blind quality
    regressions in the pipeline surface without hardware."""
    rng = np.random.default_rng(seed)
    n = int(fs * dur)
    t = np.arange(n) / fs
    harm = sum(np.sin(2 * np.pi * 220 * (k + 1) * t) / (k + 1)
               for k in range(5)) * (1 + 0.4 * np.sin(2 * np.pi * 2 * t))
    lo = np.convolve(rng.standard_normal(n), np.ones(24) / 24, "same") \
        * (np.sin(2 * np.pi * 1.3 * t) > 0)
    w = rng.standard_normal(n)
    hi = (w - np.convolve(w, np.ones(8) / 8, "same")) \
        * (1 + 0.5 * np.sin(2 * np.pi * 0.7 * t + 1))
    srcs = [s / (np.std(s) + 1e-9) for s in (harm, lo, hi)]
    ys = []
    for j, s in enumerate(srcs):
        chs = []
        for ch in range(2):
            h = rng.standard_normal(60) * np.exp(-np.arange(60) / 12.0)
            h[0] += 1.5 if ch == (j % 2) else 0.4
            chs.append(np.convolve(s, h, "same"))
        ys.append(np.stack(chs, 1))
    ys = np.stack(ys)
    return ys.sum(0), ys


@pytest.mark.slow
def test_blind_reverb_mini_quality_cpu():
    """A miniature configs[2] draw the BLIND pipeline must actually
    separate on CPU (min SDR well above 0) -- the other tests here pin
    mechanism only, so without this a blind-quality collapse would stay
    invisible until a hardware run. Measured 6.3 dB min SDR at this
    configuration (~90 s on one CPU core); the 3 dB bar leaves margin
    for platform jitter while still failing on any real regression."""
    from itertools import permutations

    from pyfasst_jax.tf.stft import STFT

    fs = 8000
    mix, ys_true = _mini_configs2_fixture(102, fs=fs)
    n = mix.shape[0]
    tft = STFT(wlen=512, fs=fs)
    X = np.asarray(tft.computeTransform(mix.astype(np.float32)))
    Y, info = blind_reverb_separate(X, J=3, iters=120, em_seeds=1,
                                    reseed_rounds=1, n_seeds=4, chunk=8,
                                    nmf_comps=4)
    ys = np.stack([np.asarray(tft.invertTransform(Y[j], nsamples=n))
                   for j in range(3)])

    def sdr(e, r):
        return 10 * np.log10(np.sum(r ** 2)
                             / max(np.sum((e - r) ** 2), 1e-12))

    best = max(min(sdr(ys[p[j]], ys_true[j]) for j in range(3))
               for p in permutations(range(3)))
    assert best > 3.0, f"blind mini-configs[2] min SDR {best:.2f} dB"


def test_blind_reverb_band_em_and_noalign_candidates():
    """The round-4 pool extensions run end-to-end: `band_em` adds the
    band-local-EM vote candidate (spatial_init.band_em_votes), `noalign`
    the alignment-free consensus candidate. Mechanism test (tiny shapes);
    the quality evidence lives in tools/ labs + docs/design.md §6g."""
    X = _reverb_mixture(seed=3)
    Y, info = blind_reverb_separate(
        X, J=2, iters=30, em_seeds=1, reseed_rounds=0, nmf_comps=3,
        chunk=4, n_seeds=3, band_em=16, noalign=True)
    assert Y.shape == (2,) + X.shape
    assert np.all(np.isfinite(Y.view(np.float64)))
    # all three new candidates entered the pool (bandem envelope-aligned
    # + bandem init-anchored + noalign) over the run without the flags
    _, info_base = blind_reverb_separate(
        X, J=2, iters=30, em_seeds=1, reseed_rounds=0, nmf_comps=3,
        chunk=4, n_seeds=3)
    assert (info["history"][0]["pool"]
            == info_base["history"][0]["pool"] + 3)


def test_consensus_votes_align_none():
    """align='none' returns a valid vote distribution from the raw
    warm-started labels (no spectral alignment stage)."""
    from pyfasst_jax.models.spatial_init import consensus_votes

    X = _reverb_mixture(seed=5)
    v = consensus_votes(X, 2, n_seeds=3, align="none")
    assert v.shape == X.shape[:2] + (2,)
    assert np.all(v >= 0) and np.all(v <= 1)
    np.testing.assert_allclose(v.sum(-1), 1.0, atol=1e-9)


def test_blind_reverb_pool_sharded_selection_matches(rng8=None):
    """The candidate pool sharded over the full virtual 8-device mesh
    (n_devices=8: DP over (candidate, seed) runs, chunks padded to the dp
    axis) must make the SAME selection as the single-device run and
    return numerically close separations -- the pool is the library's
    most expensive workload and the mesh must not change its answer."""
    import jax

    if jax.device_count() < 8:
        pytest.skip("needs the 8-virtual-device CPU backend")
    X = _reverb_mixture(seed=7)
    kw = dict(iters=30, em_seeds=1, reseed_rounds=1, nmf_comps=3,
              chunk=4, n_seeds=3)
    Y1, info1 = blind_reverb_separate(X, J=2, n_devices=1, **kw)
    Y8, info8 = blind_reverb_separate(X, J=2, n_devices=8, **kw)
    assert info8["picked"] == info1["picked"]
    assert [h["picked"] for h in info8["history"]] == \
        [h["picked"] for h in info1["history"]]
    np.testing.assert_allclose(info8["final_ll"], info1["final_ll"],
                               rtol=1e-4)
    np.testing.assert_allclose(
        np.abs(Y8), np.abs(Y1), rtol=2e-2,
        atol=2e-3 * float(np.abs(Y1).max()))


def _time_mixture(fs=4000, dur=1.5, seed=0):
    """Stereo time-domain mixture: two amplitude-gated, band-limited
    sources at distinct pans with short random mixing filters (mild
    reverberant part). Gate periods differ so envelope permutation
    alignment has signal at the fine grid."""
    rng = np.random.default_rng(seed)
    n = int(fs * dur)
    t = np.arange(n) / fs
    s1 = np.sin(2 * np.pi * 220 * t) * (1 + 0.3 * np.sin(
        2 * np.pi * 660 * t))
    s1 *= (np.sin(2 * np.pi * 3.1 * t) > -0.2)
    w = rng.standard_normal(n)
    s2 = (w - np.convolve(w, np.ones(8) / 8, "same"))
    s2 *= (np.sin(2 * np.pi * 1.3 * t + 1.0) > 0.1)
    ys = []
    for j, (s, pan) in enumerate(((s1, 0.8), (s2, 0.2))):
        chs = []
        for ch in range(2):
            h = rng.standard_normal(24) * np.exp(-np.arange(24) / 5.0) * 0.2
            h[0] += pan if ch == 0 else 1.0 - pan
            chs.append(np.convolve(s, h, "same"))
        ys.append(np.stack(chs, 1))
    ys = np.stack(ys)
    return ys.sum(0).astype(np.float32), ys


def test_blind_reverb_multiscale_end_to_end():
    """The multiscale ladder at tiny shapes: fine-grid pipeline, vote
    remap through time-domain images, coarse-grid EM; contract checks."""
    from pyfasst_jax.models.reverb import blind_reverb_separate_multiscale

    mix, ys_true = _time_mixture()
    Y, info = blind_reverb_separate_multiscale(
        mix, J=2, fs=4000, wlen_fine=128, wlen_coarse=512, iters=40,
        em_seeds=1, reseed_rounds=1, nmf_comps=3, chunk=4, n_seeds=3)
    F_c = 512 // 2 + 1
    assert Y.shape[0] == 2 and Y.shape[1] == F_c and Y.shape[3] == 2
    assert np.all(np.isfinite(Y.view(np.float64)))
    # coarse stage ran from a ladder candidate (or its guarded reseeds)
    assert info["picked"].split("|")[0].startswith(("ladder", "reseed"))
    assert info["fine"]["picked"]                 # fine stage recorded
    assert "params" not in info["fine"]
    # the installed coarse transform inverts the images to time domain
    tft = info["transform"]
    y0 = np.asarray(tft.invertTransform(Y[0], nsamples=mix.shape[0]))
    assert y0.shape == mix.shape


def test_model_multiscale_entry():
    """FASST.estim_param_blind_reverb(multiscale_wlen=...) installs
    coarse-grid parameters compatible with separated_images, and guards
    bad arguments."""
    import pytest

    from pyfasst_jax.models import MultiChanNMFConv

    mix, ys_true = _time_mixture(seed=1)
    m = MultiChanNMFConv(mix, fs=4000, wlen=512, iter_num=40, nbComps=2,
                         nbNMFComps=3, spatial_rank=2, seed=0)
    info = m.estim_param_blind_reverb(
        reseed_rounds=1, em_seeds=1, multiscale_wlen=128, chunk=4,
        n_seeds=3)
    ys = m.separated_images()
    assert ys.shape == (2, mix.shape[0], 2)
    assert np.all(np.isfinite(ys))
    assert info["fine"]["picked"]
    with pytest.raises(ValueError, match="finer"):
        m.estim_param_blind_reverb(multiscale_wlen=512)


def test_blind_reverb_rank_transform_and_realigned_reseeds():
    """Pipeline contract with env_transform='rank' and the realigned-reseed
    hypothesis enabled (the coverage is the parameter plumbing + the extra
    pool candidate; the quality claims live in tools/ labs)."""
    X = _reverb_mixture(seed=3)
    Y, info = blind_reverb_separate(
        X, J=2, iters=40, em_seeds=1, reseed_rounds=1, nmf_comps=3,
        chunk=4, n_seeds=3, env_transform="rank", realign_reseeds=True)
    assert Y.shape == (2,) + X.shape
    assert np.all(np.isfinite(Y.view(np.float64)))
    assert len(info["history"]) >= 1
    # the module default must be untouched by parameter threading
    import pyfasst_jax.models.spatial_init as si
    assert si._ENV_TRANSFORM == "log1p"


def test_blind_reverb_dual_transform_pool():
    """env_transform='both' doubles the clustering-derived pool (log1p +
    rank candidates, rank-prefixed names) and the selection picks one."""
    X = _reverb_mixture(seed=5)
    Y, info = blind_reverb_separate(
        X, J=2, iters=30, em_seeds=1, reseed_rounds=1, nmf_comps=3,
        chunk=4, n_seeds=3, env_transform="both")
    assert Y.shape == (2,) + X.shape
    assert np.all(np.isfinite(Y.view(np.float64)))
    # winner is a real candidate name from either transform family
    base = info["picked"].split("|")[0]
    assert base.startswith(("raw", "rank:", "merge", "split", "realign",
                            "reseed", "dirs"))


def test_blind_reverb_learned_candidate_and_judge():
    """Round-5 pool extensions (models/binfeat): `learned=True` adds the
    learned-vote candidate; select='learned' orders runs by agreement of
    their converged stem-dominance planes with the learned votes.
    Mechanism test with a tiny untrained net (explicit params) -- the
    quality evidence lives in tools/train_binfeat.py + design.md §6j."""
    from pyfasst_jax.models.binfeat import init_params

    tiny = init_params(seed=0, c_in=5, width=8, emb_dim=4,
                       layers=((3, 3, 1, 1), (3, 3, 2, 2)))
    X = _reverb_mixture(seed=5)
    Y, info = blind_reverb_separate(
        X, J=2, iters=30, em_seeds=1, reseed_rounds=0, nmf_comps=3,
        chunk=4, n_seeds=3, learned=True, learned_params=tiny,
        select="learned")
    assert Y.shape == (2,) + X.shape
    assert np.all(np.isfinite(Y.view(np.float64)))
    assert info["select"] == "learned"
    # the learned agreement statistic was computed for the winner
    names = [h["picked"] for h in info["history"]]
    assert names, names


def test_blind_reverb_on_warped_plane():
    """The FLAT blind pipeline is front-end agnostic (VERDICT r4 weak-6):
    `estim_param_blind_reverb` runs on the model's own plane whatever the
    transform, and round 5 lifted the CLI's blanket STFT-only raise (only
    the multiscale ladder, which builds its own STFT grids, still
    requires one). Drive the pipeline on a REAL ERBlet analysis plane
    (uniform-hop painless NSGT, tf/erblet.py) of a panned two-source
    mixture: the contract (shapes, finiteness, recorded stats) must hold
    on the warped grid, where F is the band axis."""
    from pyfasst_jax.tf.erblet import ERBLetTransform

    rng = np.random.default_rng(3)
    fs, n = 4000, 4096
    t = np.arange(n) / fs
    gate1 = ((np.arange(n) // 600) % 2 == 0).astype(float)
    gate2 = 1.0 - 0.9 * gate1
    s1 = np.sin(2 * np.pi * 150.0 * t) * gate1
    s2 = rng.standard_normal(n) * gate2
    s2 -= np.convolve(s2, np.ones(9) / 9.0, "same")  # high-pass-ish
    mix = (np.outer(s1, [1.0, 0.25]) + np.outer(s2, [0.3, 1.0]))
    tft = ERBLetTransform(fs=fs, n_bands=12, fmin=40.0)
    X = np.asarray(tft.computeTransform(
        mix.astype(np.float32))).astype(np.complex128)
    assert X.ndim == 3 and X.shape[-1] == 2
    Y, info = blind_reverb_separate(
        X, J=2, iters=25, em_seeds=1, reseed_rounds=0, nmf_comps=3,
        chunk=4, n_seeds=3)
    assert Y.shape == (2,) + X.shape
    assert np.all(np.isfinite(Y.view(np.float64)))
    assert info["picked"]
    # and the separated warped planes invert through the exact dual
    y0 = np.asarray(tft.invertTransform(Y[0], nsamples=n))
    assert y0.shape == (n, 2) and np.all(np.isfinite(y0))
