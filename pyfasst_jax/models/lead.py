"""SeparateLeadStereo: source/filter (SIMM) lead / accompaniment separation.

Reference parity: pyfasst/SeparateLeadStereo/SeparateLeadStereoTF.py
(UNVERIFIED; mount empty, see SURVEY.md §3.5), implementing Durrieu's
smoothed instantaneous mixture model -- STEREO form: each channel's power
spectrogram is modelled with per-source panning gains,

    |X_L|^2 ~ V_L = gL * (WF0 @ HF0) * (WGAMMA @ HGAMMA) + WM @ diag(bL) @ HM
    |X_R|^2 ~ V_R = gR * (WF0 @ HF0) * (WGAMMA @ HGAMMA) + WM @ diag(bR) @ HM

with (gL, gR) the lead's channel power gains (alpha^2 in the reference) and
(bL, bR) per-accompaniment-component power gains (beta^2) -- all estimated
by IS-divergence multiplicative updates jointly with the factors. WF0 holds
chirped KLGLOTT88 glottal-source atoms (variants.generate_WF0_chirped);
melody is Viterbi-tracked over the chirp-pooled F0 activations, then a
melody-constrained second pass re-estimates, and per-channel Wiener masks
synthesize the stems. Device shape: the update loop is one jitted
lax.fori_loop of pure GEMMs + elementwise ops; Viterbi is a lax.scan;
masks/ISTFT reuse the framework front-end.
"""
from __future__ import annotations

import functools
import os
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pyfasst_jax.audio import AudioObject
from pyfasst_jax.models.variants import generate_WF0, generate_WF0_chirped
from pyfasst_jax.tf.filterbank import spectral_basis
from pyfasst_jax.tf.stft import STFT


# -- jitted SIMM core ---------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("niter",))
@jax.default_matmul_precision("highest")
def simm_updates(P, WF0, WG, HF0, HG, WM, HM, niter: int, eps=1e-12):
    """IS-NMF multiplicative updates of the SIMM factors against P = |X|^2.

    Shapes: P (F, N); WF0 (F, U); HF0 (U, N); WG (F, G); HG (G, N);
    WM (F, M); HM (M, N). Returns updated (HF0, HG, WM, HM). Uses the same
    float32 guards as the GEM engine (mstep.py): model PSD floored RELATIVE
    to the observed scale, multiplicative ratios clamped (dead components
    otherwise 0/0-swing the model).
    """
    from pyfasst_jax.ops.mstep import _mul_upd

    v_floor = 1e-12 * jnp.mean(P) + eps

    def nd(V):
        Vc = jnp.maximum(V, v_floor)
        return P / (Vc * Vc), 1.0 / Vc

    def body(_, carry):
        HF0, HG, WM, HM = carry
        SF0 = WF0 @ HF0
        SPHI = WG @ HG
        num, den = nd(SF0 * SPHI + WM @ HM)
        HF0 = _mul_upd(HF0, WF0.T @ (SPHI * num), WF0.T @ (SPHI * den), eps)
        SF0 = WF0 @ HF0
        num, den = nd(SF0 * SPHI + WM @ HM)
        HG = _mul_upd(HG, WG.T @ (SF0 * num), WG.T @ (SF0 * den), eps)
        SPHI = WG @ HG
        num, den = nd(SF0 * SPHI + WM @ HM)
        HM = _mul_upd(HM, WM.T @ num, WM.T @ den, eps)
        num, den = nd(SF0 * SPHI + WM @ HM)
        WM = _mul_upd(WM, num @ HM.T, den @ HM.T, eps)
        return HF0, HG, WM, HM

    return jax.lax.fori_loop(0, niter, body, (HF0, HG, WM, HM))


@functools.partial(jax.jit, static_argnames=("niter",))
@jax.default_matmul_precision("highest")
def simm_updates_stereo(PL, PR, WF0, WG, HF0, HG, WM, HM,
                        gL, gR, bL, bR, niter: int, eps=1e-12):
    """Stereo IS-NMF multiplicative updates of the SIMM factors AND the
    per-source panning gains against (PL, PR) = (|X_L|^2, |X_R|^2).

    Shapes: PL/PR (F, N); WF0 (F, U); HF0 (U, N); WG (F, G); HG (G, N);
    WM (F, M); HM (M, N); gL/gR scalar lead power gains; bL/bR (M,)
    accompaniment power gains. Every update is the exact IS-divergence
    multiplicative rule for the summed two-channel divergence
    D(PL|V_L) + D(PR|V_R); gradients from both channels add in the
    numerator/denominator. Scale indeterminacies are pinned each iteration:
    gL + gR = 1 (scale into HF0) and bL + bR = 1 per component (scale into
    HM rows). Returns (HF0, HG, WM, HM, gL, gR, bL, bR).

    Float32 guards as the GEM engine (mstep.py): model PSD floored RELATIVE
    to the observed scale, multiplicative ratios clamped.
    """
    from pyfasst_jax.ops.mstep import _mul_upd

    v_floor = 1e-12 * 0.5 * (jnp.mean(PL) + jnp.mean(PR)) + eps

    def nd(V, P):
        Vc = jnp.maximum(V, v_floor)
        return P / (Vc * Vc), 1.0 / Vc

    def body(_, carry):
        HF0, HG, WM, HM, gL, gR, bL, bR = carry

        def acc(b):
            return WM @ (b[:, None] * HM)

        def lead_nd(S):
            VL = gL * S + acc(bL)
            VR = gR * S + acc(bR)
            nL, dL = nd(VL, PL)
            nR, dR = nd(VR, PR)
            return nL, dL, nR, dR

        # -- lead chain ---------------------------------------------------
        SF0 = WF0 @ HF0
        SPHI = WG @ HG
        nL, dL, nR, dR = lead_nd(SF0 * SPHI)
        num = WF0.T @ (SPHI * (gL * nL + gR * nR))
        den = WF0.T @ (SPHI * (gL * dL + gR * dR))
        HF0 = _mul_upd(HF0, num, den, eps)

        SF0 = WF0 @ HF0
        nL, dL, nR, dR = lead_nd(SF0 * SPHI)
        num = WG.T @ (SF0 * (gL * nL + gR * nR))
        den = WG.T @ (SF0 * (gL * dL + gR * dR))
        HG = _mul_upd(HG, num, den, eps)
        SPHI = WG @ HG
        S = SF0 * SPHI

        # -- accompaniment ------------------------------------------------
        nL, dL, nR, dR = lead_nd(S)
        num = bL[:, None] * (WM.T @ nL) + bR[:, None] * (WM.T @ nR)
        den = bL[:, None] * (WM.T @ dL) + bR[:, None] * (WM.T @ dR)
        HM = _mul_upd(HM, num, den, eps)

        nL, dL, nR, dR = lead_nd(S)
        num = nL @ (bL[:, None] * HM).T + nR @ (bR[:, None] * HM).T
        den = dL @ (bL[:, None] * HM).T + dR @ (bR[:, None] * HM).T
        WM = _mul_upd(WM, num, den, eps)

        # -- panning gains ------------------------------------------------
        nL, dL, nR, dR = lead_nd(S)
        gL = _mul_upd(gL, jnp.sum(S * nL), jnp.sum(S * dL), eps)
        gR = _mul_upd(gR, jnp.sum(S * nR), jnp.sum(S * dR), eps)
        bL = _mul_upd(bL, jnp.sum((WM.T @ nL) * HM, axis=1),
                      jnp.sum((WM.T @ dL) * HM, axis=1), eps)
        bR = _mul_upd(bR, jnp.sum((WM.T @ nR) * HM, axis=1),
                      jnp.sum((WM.T @ dR) * HM, axis=1), eps)

        # -- pin the scale indeterminacies --------------------------------
        s = jnp.maximum(gL + gR, eps)
        HF0 = HF0 * s
        gL, gR = gL / s, gR / s
        sm = jnp.maximum(bL + bR, eps)
        HM = HM * sm[:, None]
        bL, bR = bL / sm, bR / sm
        return HF0, HG, WM, HM, gL, gR, bL, bR

    return jax.lax.fori_loop(0, niter, body,
                             (HF0, HG, WM, HM, gL, gR, bL, bR))


@jax.jit
def viterbi_melody(salience, jump_penalty: float = 0.8):
    """Viterbi path over F0 salience (U, N) with quadratic jump penalty.

    Reference parity: the melody tracking stage of SeparateLeadStereo
    (UNVERIFIED). Returns the melody index path (N,) int32.
    """
    U, N = salience.shape
    logS = jnp.log(jnp.maximum(salience, 1e-12))
    idx = jnp.arange(U)
    pen = -jump_penalty * (idx[:, None] - idx[None, :]) ** 2 / U

    def fwd(carry, ls):
        score = carry                       # (U,)
        cand = score[:, None] + pen         # from u -> to u'
        best = jnp.max(cand, axis=0)
        arg = jnp.argmax(cand, axis=0)
        return best + ls, arg

    score0 = logS[:, 0]
    final, args = jax.lax.scan(fwd, score0, logS.T[1:])
    last = jnp.argmax(final)

    def bwd(carry, arg):
        nxt = carry
        cur = arg[nxt]
        return cur, cur

    _, path_rev = jax.lax.scan(bwd, last, args[::-1])
    return jnp.concatenate([path_rev[::-1], jnp.array([last])]).astype(
        jnp.int32)


class SeparateLeadStereoTF:
    """Lead / accompaniment separation pipeline (Durrieu SIMM).

    Usage mirrors the reference:
        sep = SeparateLeadStereoTF("song.wav")
        sep.runDecomposition()
        sep.writeSeparatedSignals("out_dir")   # lead + accompaniment WAVs
    """

    def __init__(self, inputAudioFilename=None, audio=None, fs: int = 44100,
                 wlen: int = 2048, hop: Optional[int] = None,
                 n_f0: int = 120, f0_min: float = 80.0, f0_max: float = 800.0,
                 n_filter: int = 30, n_acc: int = 16,
                 niter: int = 50, melody_halfwidth: int = 2, seed: int = 0,
                 glottal: bool = True, chirp_per_f0: int = 1,
                 chirp_semitones: float = 0.5):
        if audio is not None:
            self.audio = AudioObject(data=np.asarray(audio), samplerate=fs)
        else:
            self.audio = AudioObject(inputAudioFilename)
        self.fs = self.audio.samplerate
        self.tft = STFT(wlen=wlen, hop=hop, fs=self.fs)
        self.niter = niter
        self.melody_halfwidth = melody_halfwidth
        self.n_f0 = n_f0
        self.chirp_per_f0 = chirp_per_f0 if glottal else 1
        data = self.audio.data.astype(np.float32)
        if data.shape[1] == 1:
            data = np.repeat(data, 2, axis=1)
        self.X = np.asarray(self.tft.computeTransform(data))  # (F, N, 2)
        F, N = self.X.shape[:2]
        self.F, self.N = F, N
        if glottal:
            WF0 = generate_WF0_chirped(
                F, self.fs, wlen, n_f0=n_f0, f0_min=f0_min, f0_max=f0_max,
                chirp_per_f0=chirp_per_f0, chirp_semitones=chirp_semitones)
        else:
            WF0 = generate_WF0(F, self.fs, wlen, n_f0=n_f0, f0_min=f0_min,
                               f0_max=f0_max)
        self.WF0 = jnp.asarray(WF0, jnp.float32)
        U = self.WF0.shape[1]
        self.WG = jnp.asarray(
            spectral_basis("mel", n_filter, F, self.fs, wlen), jnp.float32)
        rng = np.random.default_rng(seed)
        self.HF0 = jnp.asarray(0.5 + rng.random((U, N)), jnp.float32)
        self.HG = jnp.asarray(0.5 + rng.random((n_filter, N)), jnp.float32)
        self.WM = jnp.asarray(0.5 + rng.random((F, n_acc)), jnp.float32)
        self.HM = jnp.asarray(0.5 + rng.random((n_acc, N)), jnp.float32)
        # panning power gains: lead (gL, gR) scalar, accompaniment per
        # component (bL, bR); pinned gL+gR = 1, bL+bR = 1
        self.gL = jnp.float32(0.5)
        self.gR = jnp.float32(0.5)
        self.bL = jnp.full((n_acc,), 0.5, jnp.float32)
        self.bR = jnp.full((n_acc,), 0.5, jnp.float32)
        self.melody: Optional[np.ndarray] = None

    # -- pipeline -------------------------------------------------------------
    def runDecomposition(self) -> np.ndarray:
        """Two-pass stereo SIMM estimation with Viterbi melody constraint.

        Pass 1 estimates all factors + panning gains on (|X_L|^2, |X_R|^2);
        the melody is Viterbi-tracked over the chirp-pooled F0 activations;
        pass 2 re-estimates with activations constrained to a corridor
        around the melody. Returns the melody path (F0-grid indices per
        frame, length N).
        """
        PL = jnp.asarray(np.abs(self.X[..., 0]) ** 2, jnp.float32)
        PR = jnp.asarray(np.abs(self.X[..., 1]) ** 2, jnp.float32)
        scale = jnp.maximum(0.5 * (jnp.mean(PL) + jnp.mean(PR)), 1e-30)
        PL, PR = PL / scale, PR / scale
        state = simm_updates_stereo(
            PL, PR, self.WF0, self.WG, self.HF0, self.HG, self.WM, self.HM,
            self.gL, self.gR, self.bL, self.bR, self.niter)
        HF0, HG, WM, HM, gL, gR, bL, bR = state
        path = viterbi_melody(self._pool_chirps(HF0))
        # melody-constrained second pass: zero F0 activations away from the
        # path (corridor in f0-grid units; all chirp variants of an allowed
        # f0 stay allowed)
        dist = jnp.abs(jnp.arange(self.n_f0)[:, None] - path[None, :])
        mask = (dist <= self.melody_halfwidth).astype(HF0.dtype)
        mask = jnp.repeat(mask, self.chirp_per_f0, axis=0)
        HF0 = HF0 * mask + 1e-12
        state = simm_updates_stereo(
            PL, PR, self.WF0, self.WG, HF0, HG, WM, HM,
            gL, gR, bL, bR, self.niter)
        (self.HF0, self.HG, self.WM, self.HM,
         self.gL, self.gR, self.bL, self.bR) = state
        self.melody = np.asarray(path)
        return self.melody

    def _pool_chirps(self, HF0: jnp.ndarray) -> jnp.ndarray:
        """Pool atom activations (U, N) over chirp variants -> (n_f0, N)."""
        if self.chirp_per_f0 == 1:
            return HF0
        return HF0.reshape(self.n_f0, self.chirp_per_f0, -1).sum(axis=1)

    @property
    def f0_activations(self) -> jnp.ndarray:
        """Chirp-pooled F0 activations (n_f0, N) -- the melody salience."""
        return self._pool_chirps(self.HF0)

    @property
    def alpha(self) -> Tuple[float, float]:
        """Lead amplitude panning (alpha_L, alpha_R), alpha^2 = power gain."""
        return (float(jnp.sqrt(self.gL)), float(jnp.sqrt(self.gR)))

    def lead_mask(self) -> jnp.ndarray:
        """Per-channel Wiener mask of the lead source, (F, N, 2) in [0, 1]."""
        S = (self.WF0 @ self.HF0) * (self.WG @ self.HG)
        VaL = self.WM @ (self.bL[:, None] * self.HM)
        VaR = self.WM @ (self.bR[:, None] * self.HM)
        mL = self.gL * S / jnp.maximum(self.gL * S + VaL, 1e-30)
        mR = self.gR * S / jnp.maximum(self.gR * S + VaR, 1e-30)
        return jnp.stack([mL, mR], axis=-1)

    def separated_signals(self) -> Tuple[np.ndarray, np.ndarray]:
        """(lead, accompaniment) time-domain stereo signals."""
        mask = np.asarray(self.lead_mask())
        n = self.audio.nsamples
        lead = np.asarray(self.tft.invertTransform(self.X * mask, nsamples=n))
        acc = np.asarray(self.tft.invertTransform(self.X * (1.0 - mask),
                                                  nsamples=n))
        return lead, acc

    def writeSeparatedSignals(self, dir_results: str,
                              suffix: str = "") -> Tuple[str, str]:
        os.makedirs(dir_results, exist_ok=True)
        lead, acc = self.separated_signals()
        stem = os.path.splitext(os.path.basename(
            self.audio.filename or "input"))[0] + suffix
        p1 = os.path.join(dir_results, f"{stem}_lead.wav")
        p2 = os.path.join(dir_results, f"{stem}_accompaniment.wav")
        for p, sig in ((p1, lead), (p2, acc)):
            peak = np.max(np.abs(sig))
            AudioObject(data=sig / peak if peak > 1 else sig,
                        samplerate=self.fs)._write(p)
        return p1, p2
