"""Pre-wired FASST model variants.

Reference parity (pyfasst/audioModel.py subclasses, UNVERIFIED; mount empty,
see SURVEY.md §2):

    MultiChanNMFInst_FASST  -- instantaneous mixing, NMF spectra
    MultiChanNMFConv        -- convolutive (per-frequency complex) mixing
    MultiChanHMM            -- GSMM/HMM spectral states
    multiChanSourceF0Filter -- source/filter (SIMM) spectral model with a
                               harmonic-comb F0 dictionary (WF0) and a smooth
                               filter dictionary (WGAMMA)

Constructor kwarg names (`nbComps`, `nbNMFComps`, `spatial_rank`) follow the
reference for drop-in familiarity.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from pyfasst_jax.models.components import (
    CONV, GMM, HMM, INST, FasstParams, SpatialComp, SpectralComp,
    init_inst_mixing, init_nmf_comp,
)
from pyfasst_jax.models.fasst import FASST
from pyfasst_jax.tf.filterbank import spectral_basis


def _split(key, n):
    return list(jax.random.split(key, n))


class MultiChanNMFInst_FASST(FASST):
    """Instantaneous multichannel NMF (BASELINE.json configs[0])."""

    def __init__(self, audio, nbComps: int = 2, nbNMFComps: int = 4,
                 spatial_rank: int = 1, freq_basis: Optional[str] = None,
                 n_bands: int = 40, **kw):
        super().__init__(audio, **kw)
        keys = _split(self.key, nbComps)
        fixed_FB = None
        if freq_basis in ("erb", "mel"):
            fixed_FB = spectral_basis(freq_basis, n_bands, self.F, self.fs,
                                      self.stft_wlen)
        A_list = init_inst_mixing(self.seed, self.nchannels, spatial_rank,
                                  nbComps, dtype=self.dtype)
        spat = tuple(SpatialComp(A=A, mix_type=INST, free=True)
                     for A in A_list)
        spec = tuple(
            init_nmf_comp(keys[j], self.F, self.N, nbNMFComps, spat_ind=j,
                          fixed_FB=fixed_FB, dtype=self.dtype)
            for j in range(nbComps))
        self.params = FasstParams(spat=spat, spec=spec)


class MultiChanNMFConv(FASST):
    """Convolutive multichannel NMF (anechoic/reverberant; configs[1]/[2]).

    spatial_rank == nchannels gives the full-rank spatial covariance model.
    Initial mixing defaults to broadside-ish complex directions; pass
    `init_mixing` (J, F, I, R) to seed from DEMIX.
    """

    def __init__(self, audio, nbComps: int = 3, nbNMFComps: int = 4,
                 spatial_rank: int = 1, init_mixing: Optional[np.ndarray] = None,
                 freq_basis: Optional[str] = None, n_bands: int = 40, **kw):
        super().__init__(audio, **kw)
        keys = _split(self.key, nbComps)
        fixed_FB = None
        if freq_basis in ("erb", "mel"):
            fixed_FB = spectral_basis(freq_basis, n_bands, self.F, self.fs,
                                      self.stft_wlen)
        if init_mixing is not None:
            init_mixing = np.asarray(init_mixing)
            if init_mixing.shape[-1] < spatial_rank:
                # rank expansion (e.g. DEMIX rank-1 directions seeding a
                # full-rank model): append small orthogonal columns so the
                # extra spatial degrees of freedom start near-anechoic and
                # grow only if the data asks for them.
                a = init_mixing[..., 0]                     # (J, F, 2)
                orth = np.stack([-np.conj(a[..., 1]),
                                 np.conj(a[..., 0])], axis=-1)
                norm = np.linalg.norm(a, axis=-1, keepdims=True) + 1e-12
                cols = [init_mixing] + [
                    (0.2 * orth / norm)[..., None]
                    for _ in range(spatial_rank - init_mixing.shape[-1])]
                init_mixing = np.concatenate(cols, axis=-1)
            A0 = jnp.asarray(
                init_mixing, jnp.complex128 if self.dtype == jnp.float64
                else jnp.complex64)
        else:
            cdt = np.complex128 if self.dtype == jnp.float64 else np.complex64
            base = np.stack(
                [np.tile(a[None], (self.F, 1, 1)) for a in
                 init_inst_mixing(self.seed, self.nchannels, spatial_rank,
                                  nbComps)]
            ).astype(cdt)
            rng = np.random.default_rng(self.seed)
            base = base * np.exp(
                1j * 0.05 * rng.standard_normal(base.shape)).astype(cdt)
            A0 = jnp.asarray(
                base, jnp.complex128 if self.dtype == jnp.float64
                else jnp.complex64)
        spat = tuple(SpatialComp(A=A0[j], mix_type=CONV, free=True)
                     for j in range(nbComps))
        spec = tuple(
            init_nmf_comp(keys[j], self.F, self.N, nbNMFComps, spat_ind=j,
                          fixed_FB=fixed_FB, dtype=self.dtype)
            for j in range(nbComps))
        self.params = FasstParams(spat=spat, spec=spec)


class MultiChanHMM(FASST):
    """GSMM/HMM spectral-state model (BASELINE.json configs[3]).

    Each source has nbStates spectral templates (columns of FB); per frame one
    state is active with a free gain. sparsity='GMM' uses i.i.d. state priors,
    'HMM' a transition matrix (persistence prior).
    """

    def __init__(self, audio, nbComps: int = 2, nbStates: int = 8,
                 spatial_rank: int = 1, sparsity: str = "HMM",
                 self_trans: float = 0.9, mix_type: str = INST,
                 decode: str = "soft", **kw):
        super().__init__(audio, **kw)
        keys = _split(self.key, nbComps)
        if mix_type == INST:
            A_list = init_inst_mixing(self.seed, self.nchannels, spatial_rank,
                                      nbComps, dtype=self.dtype)
            spat = tuple(SpatialComp(A=A, mix_type=INST, free=True)
                         for A in A_list)
        else:
            cdt = np.complex128 if self.dtype == jnp.float64 else np.complex64
            base = np.stack(
                [np.tile(a[None], (self.F, 1, 1)) for a in
                 init_inst_mixing(self.seed, self.nchannels, spatial_rank,
                                  nbComps)]
            ).astype(cdt)
            spat = tuple(SpatialComp(A=jnp.asarray(base[j]),
                                     mix_type=CONV, free=True)
                         for j in range(nbComps))
        Q = nbStates
        if sparsity == "HMM":
            trans = (self_trans * np.eye(Q)
                     + (1.0 - self_trans) / max(Q - 1, 1) * (1 - np.eye(Q)))
        else:                      # GMM/GSMM: i.i.d. state prior
            trans = np.full(Q, 1.0 / Q)
        spec = []
        for j in range(nbComps):
            FB = 0.5 + jax.random.uniform(keys[j], (self.F, Q))
            TW = 0.5 + jax.random.uniform(
                jax.random.fold_in(keys[j], 1), (Q, self.N))
            spec.append(SpectralComp(
                FB=FB.astype(self.dtype), TW=TW.astype(self.dtype),
                trans=jnp.asarray(trans, self.dtype), spat_ind=j,
                free=(True, False, True, False),
                constraint=(HMM if sparsity == "HMM" else GMM),
                decode=decode))
        self.params = FasstParams(spat=spat, spec=tuple(spec))


def generate_WF0(F: int, fs: int, wlen: int, n_f0: int = 60,
                 f0_min: float = 80.0, f0_max: float = 500.0,
                 rolloff: float = 1.0) -> np.ndarray:
    """Harmonic-comb source dictionary (F, n_f0) on a log-F0 grid.

    Each column is a Gaussian-blurred harmonic comb with 1/h^rolloff
    amplitude decay -- a simple pitched-source atom family. The reference's
    glottal-pulse atoms (and chirped variants) are generate_WF0_chirped
    below; this lighter comb is kept as an option.
    """
    freqs = np.arange(F) * fs / wlen
    f0s = np.geomspace(f0_min, f0_max, n_f0)
    W = np.zeros((F, n_f0))
    bw = fs / wlen  # one-bin Gaussian width
    for i, f0 in enumerate(f0s):
        n_harm = int(np.floor((fs / 2) / f0))
        for h in range(1, n_harm + 1):
            W[:, i] += (h ** -rolloff) * np.exp(
                -0.5 * ((freqs - h * f0) / bw) ** 2)
    W /= np.maximum(W.sum(axis=0, keepdims=True), 1e-12)
    return W


def odgd_harmonic_amplitudes(n_harm: int, Oq: float = 0.6,
                             oversample: int = 4096) -> np.ndarray:
    """Complex Fourier coefficients c_1..c_n_harm of the KLGLOTT88
    derivative-glottal-flow waveform (open quotient Oq).

    The waveform over one normalized period t in [0, 1):

        g(t) = 27/(4 Oq^2) t^2 - 27/(4 Oq^3) t^3   for t < Oq, else 0

    (normalized so max g = 1 at t = 2 Oq / 3; g(Oq) = 0). Coefficients are
    computed numerically (FFT of a densely sampled period) instead of the
    closed form -- identical to ~1e-10 at this oversampling and immune to
    the small-m cancellation in the analytic expression. Reference parity:
    SeparateLeadStereo's ODGD spectrum generator (UNVERIFIED; mount empty).
    """
    t = np.arange(oversample) / oversample
    g = np.where(t < Oq,
                 27.0 / (4 * Oq ** 2) * t ** 2
                 - 27.0 / (4 * Oq ** 3) * t ** 3, 0.0)
    C = np.fft.rfft(g) / oversample
    return C[1:n_harm + 1]


def generate_WF0_chirped(F: int, fs: int, wlen: int, n_f0: int = 60,
                         f0_min: float = 80.0, f0_max: float = 500.0,
                         chirp_per_f0: int = 1,
                         chirp_semitones: float = 0.5,
                         Oq: float = 0.6,
                         window: Optional[np.ndarray] = None) -> np.ndarray:
    """Glottal-source dictionary (F, n_f0 * chirp_per_f0), chirped atoms.

    Reference parity: SeparateLeadStereo's generate_WF0_chirped (UNVERIFIED):
    each atom is the power spectrum of a windowed KLGLOTT88 glottal pulse
    train at fundamental f0, including chirped variants whose F0 glides by
    up to +-chirp_semitones across the analysis window (vibrato/portamento
    energy smears across bins; un-chirped combs misfit it). Atoms are
    ordered f0-major: columns [i*chirp_per_f0 : (i+1)*chirp_per_f0] all
    belong to f0s[i] (melody tracking pools them).

    Host-side init-time code (numpy): runs once per model build.
    """
    if window is None:
        n = np.arange(wlen)
        window = np.sin(np.pi * (n + 0.5) / wlen)   # STFT sine window
    f0s = np.geomspace(f0_min, f0_max, n_f0)
    tt = np.arange(wlen) / fs
    Tw = wlen / fs
    n_fft = 2 * (F - 1)
    W = np.zeros((F, n_f0 * chirp_per_f0))
    if chirp_per_f0 == 1:
        rates = np.array([0.0])
    else:
        rates = np.linspace(-1.0, 1.0, chirp_per_f0)
    for i, f0 in enumerate(f0s):
        n_harm = max(int(np.floor((fs / 2) / (f0 * 2 ** (
            chirp_semitones / 12.0)))), 1)
        C = odgd_harmonic_amplitudes(n_harm, Oq=Oq)
        m = np.arange(1, n_harm + 1)
        for c_idx, r in enumerate(rates):
            # F0 glides from f0 to f0 * 2^(r * semitones / 12) over the
            # window: linear-in-time frequency, quadratic phase.
            f1 = f0 * 2.0 ** (r * chirp_semitones / 12.0)
            slope = (f1 - f0) / Tw
            phase = np.outer(m, f0 * tt + 0.5 * slope * tt * tt)
            x = (C[:, None] * np.exp(2j * np.pi * phase)).sum(axis=0).real
            spec = np.fft.rfft(window * x, n_fft)[:F]
            W[:, i * chirp_per_f0 + c_idx] = np.abs(spec) ** 2
    W /= np.maximum(W.sum(axis=0, keepdims=True), 1e-12)
    return W


class multiChanSourceF0Filter(FASST):
    """Source/filter (SIMM) lead + NMF accompaniment model.

    Source 0 (lead) has the true MULTIPLICATIVE source-filter PSD
        v_0 = (WF0 @ HF0) * (WGAMMA @ HGAMMA)
    (WF0 glottal-source dictionary fixed -- chirped KLGLOTT88 atoms by
    default, generate_WF0_chirped; HF0 free F0 activations; WGAMMA smooth
    filter dictionary fixed, HGAMMA free envelope activations); sources 1..
    are plain NMF components. Reference parity:
    pyfasst/audioModel.py::multiChanSourceF0Filter + SeparateLeadStereo
    dictionaries (UNVERIFIED).
    """

    def __init__(self, audio, nbComps: int = 2, nbNMFComps: int = 4,
                 n_f0: int = 60, n_filter_bands: int = 20,
                 spatial_rank: int = 1, f0_min: float = 80.0,
                 f0_max: float = 500.0, init_from_lead: bool = False,
                 lead_iters: int = 30, glottal: bool = True,
                 chirp_per_f0: int = 1, **kw):
        super().__init__(audio, **kw)
        keys = _split(self.key, nbComps + 2)
        A_list = init_inst_mixing(self.seed, self.nchannels, spatial_rank,
                                  nbComps, dtype=self.dtype)
        spat = tuple(SpatialComp(A=A, mix_type=INST, free=True)
                     for A in A_list)
        if glottal:
            WF0 = generate_WF0_chirped(self.F, self.fs, self.stft_wlen,
                                       n_f0=n_f0, f0_min=f0_min,
                                       f0_max=f0_max,
                                       chirp_per_f0=chirp_per_f0)
        else:
            WF0 = generate_WF0(self.F, self.fs, self.stft_wlen, n_f0=n_f0,
                               f0_min=f0_min, f0_max=f0_max)
        U = WF0.shape[1]
        WGAMMA = spectral_basis("mel", n_filter_bands, self.F, self.fs,
                                self.stft_wlen)
        TW0 = 0.5 + jax.random.uniform(keys[0], (U, self.N), self.dtype)
        TW20 = 0.5 + jax.random.uniform(
            keys[1], (n_filter_bands, self.N), self.dtype)
        if init_from_lead:
            # reference flow: run the SeparateLeadStereo pipeline first and
            # seed the lead source's F0/envelope activations from its
            # melody-constrained SIMM estimate (same WF0/WGAMMA grids: the
            # dictionaries are built by the same functions and parameters)
            from pyfasst_jax.models.lead import SeparateLeadStereoTF
            sep = SeparateLeadStereoTF(
                audio=self.audio.data, fs=self.fs, wlen=self.stft_wlen,
                hop=self.tft.hop, n_f0=n_f0, f0_min=f0_min, f0_max=f0_max,
                n_filter=n_filter_bands, niter=lead_iters,
                glottal=glottal, chirp_per_f0=chirp_per_f0)
            sep.runDecomposition()
            # seed with a RELATIVE floor: the melody constraint leaves hard
            # zeros off the Viterbi corridor, and multiplicative updates
            # cannot regrow from exact zero -- as the annealing noise
            # shrinks, bins the constrained lead cannot reach must remain
            # reachable by SOME component or the likelihood collapses.
            HF0 = jnp.asarray(sep.HF0, self.dtype)
            HG = jnp.asarray(sep.HG, self.dtype)
            TW0 = HF0 + 1e-2 * jnp.mean(HF0)
            TW20 = HG + 1e-2 * jnp.mean(HG)
            self.lead_melody = sep.melody
        lead = SpectralComp(
            FB=jnp.asarray(WF0, self.dtype),
            TW=TW0,
            FB2=jnp.asarray(WGAMMA, self.dtype),
            TW2=TW20,
            spat_ind=0, free=(False, False, True, False),
            free2=(False, True))
        spec = [lead]
        for j in range(1, nbComps):
            spec.append(init_nmf_comp(keys[2 + j], self.F, self.N,
                                      nbNMFComps, spat_ind=j,
                                      dtype=self.dtype))
        self.params = FasstParams(spat=spat, spec=tuple(spec))
