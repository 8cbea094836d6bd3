"""Class-level API contract: every reference model variant constructs, runs
a short GEM, and separates, straight from audio (the user surface)."""
import numpy as np
import pytest

import pyfasst_jax
from pyfasst_jax.models import (
    MultiChanHMM, MultiChanNMFConv, MultiChanNMFInst_FASST,
    multiChanSourceF0Filter,
)


@pytest.fixture
def stereo_audio(rng):
    fs, n = 8000, 8000
    t = np.arange(n) / fs
    s1 = 0.4 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(2 * np.pi * 440 * t)
    s2 = 0.2 * rng.standard_normal(n)
    mix = np.stack([0.9 * s1 + 0.3 * s2, 0.3 * s1 + 0.9 * s2], axis=1)
    return mix.astype(np.float32), fs


def _run_and_check(model, tmp_path, expect_sources):
    ll = model.estim_param_a_posteriori()
    assert np.all(np.isfinite(ll))
    # The model must improve the fit at some point of the run. (The FINAL
    # loglik legitimately dives for constrained models -- a fixed smooth
    # ERB/filter basis cannot fit narrow harmonics exactly, and the
    # residual misfit costs ~P_resid/sigma as sigma anneals to its floor.)
    assert np.max(ll) > ll[0]
    paths = model.separate_spat_comps(str(tmp_path))
    assert len(paths) == expect_sources
    import os
    assert all(os.path.exists(p) for p in paths)
    ys = model.retrieveSubsrcSignals()
    assert ys.shape[0] == expect_sources
    assert np.all(np.isfinite(ys))
    return ll


def test_inst_nmf_class(stereo_audio, tmp_path):
    mix, fs = stereo_audio
    m = MultiChanNMFInst_FASST(mix, fs=fs, wlen=512, iter_num=50,
                               nbComps=2, nbNMFComps=4)
    _run_and_check(m, tmp_path, 2)


def test_inst_nmf_erb_basis(stereo_audio, tmp_path):
    mix, fs = stereo_audio
    m = MultiChanNMFInst_FASST(mix, fs=fs, wlen=512, iter_num=50,
                               nbComps=2, nbNMFComps=4, freq_basis="erb",
                               n_bands=24)
    assert m.params.spec[0].free[0] is False      # ERB FB fixed
    _run_and_check(m, tmp_path, 2)


def test_conv_class(stereo_audio, tmp_path):
    mix, fs = stereo_audio
    m = MultiChanNMFConv(mix, fs=fs, wlen=512, iter_num=50, nbComps=2,
                         nbNMFComps=3)
    assert m.params.spat[0].mix_type == "conv"
    _run_and_check(m, tmp_path, 2)


def test_conv_full_rank_class(stereo_audio, tmp_path):
    mix, fs = stereo_audio
    m = MultiChanNMFConv(mix, fs=fs, wlen=512, iter_num=50, nbComps=2,
                         nbNMFComps=3, spatial_rank=2)
    assert m.params.spat[0].rank == 2
    _run_and_check(m, tmp_path, 2)


@pytest.mark.parametrize("sparsity", ["HMM", "GMM"])
def test_hmm_class(stereo_audio, tmp_path, sparsity):
    mix, fs = stereo_audio
    m = MultiChanHMM(mix, fs=fs, wlen=512, iter_num=50, nbComps=2,
                     nbStates=4, sparsity=sparsity)
    assert m.params.spec[0].constraint == sparsity
    _run_and_check(m, tmp_path, 2)


def test_source_filter_class(stereo_audio, tmp_path):
    mix, fs = stereo_audio
    m = multiChanSourceF0Filter(mix, fs=fs, wlen=512, iter_num=50,
                                nbComps=2, n_f0=30, f0_min=150, f0_max=500)
    assert m.params.spec[0].FB2 is not None       # true SIMM lead
    _run_and_check(m, tmp_path, 2)


def test_spatial_filter_separation(stereo_audio, tmp_path):
    mix, fs = stereo_audio
    m = MultiChanNMFInst_FASST(mix, fs=fs, wlen=512, iter_num=50)
    m.estim_param_a_posteriori()
    paths = m.separate_spatial_filter_comp(str(tmp_path))
    import os
    assert len(paths) == 2 and all(os.path.exists(p) for p in paths)


def test_seed_varies_spatial_init(stereo_audio):
    """Model-level `seed=` must vary the INST mixing init, not only the
    spectra (round-2 verdict: init_inst_mixing used to ignore its key)."""
    mix, fs = stereo_audio
    m0 = MultiChanNMFInst_FASST(mix, fs=fs, wlen=512, seed=0)
    m1 = MultiChanNMFInst_FASST(mix, fs=fs, wlen=512, seed=1)
    a0 = np.asarray(m0.params.spat[0].A)
    a1 = np.asarray(m1.params.spat[0].A)
    assert not np.allclose(a0, a1)
    # same seed -> identical init (reproducibility)
    m0b = MultiChanNMFInst_FASST(mix, fs=fs, wlen=512, seed=0)
    assert np.array_equal(a0, np.asarray(m0b.params.spat[0].A))
    # conv variant: both the base directions and the phase jitter move
    c0 = MultiChanNMFConv(mix, fs=fs, wlen=512, seed=0, nbComps=2)
    c1 = MultiChanNMFConv(mix, fs=fs, wlen=512, seed=1, nbComps=2)
    assert not np.allclose(np.asarray(c0.params.spat[0].A),
                           np.asarray(c1.params.spat[0].A))


def test_float64_cpu_parity_mode(stereo_audio, tmp_path):
    """SURVEY §7 hard parts: the x64 CPU bit-parity mode through the class."""
    from jax import enable_x64
    mix, fs = stereo_audio
    with enable_x64():
        m = MultiChanNMFInst_FASST(mix, fs=fs, wlen=512, iter_num=20,
                                   dtype="float64")
        assert m.Xs.dtype == np.complex128
        assert m.params.spec[0].FB.dtype == np.float64
        ll = m.estim_param_a_posteriori()
        assert np.all(np.isfinite(ll))
        ys = m.separated_images()
        assert ys.dtype == np.float64

    # requesting float64 without x64 enabled must error clearly
    import pytest as _pytest
    with _pytest.raises(RuntimeError, match="x64"):
        MultiChanNMFInst_FASST(mix, fs=fs, wlen=512, dtype="float64")
