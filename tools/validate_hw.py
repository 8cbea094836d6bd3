"""Validation matrix: the five BASELINE.json acceptance configs and the
added scenarios at full iteration counts on one accelerator, SDR-scored
against synthetic ground truth.

Writes docs/validation.md (separation quality) and prints one JSON line
per scenario, wall times included.

Scoring is plain per-image SDR (no allowed-distortion filters): the Wiener
estimates target the source IMAGES, so exact-image SDR is well-defined for
every scenario including the reverberant one.
"""
from __future__ import annotations

import itertools
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp

from pyfasst_jax.models.components import (
    CONV, FasstParams, SpatialComp, SpectralComp, init_inst_mixing,
    init_nmf_comp,
)
from pyfasst_jax.ops.gem import annealing_endpoints, run_gem
from pyfasst_jax.ops.wiener import separate_sources
from pyfasst_jax.tf.stft import STFT
from pyfasst_jax.tf.filterbank import spectral_basis
from pyfasst_jax.utils.config import GEMConfig

FS = 16000
DUR = 6.0
WLEN = 1024


def _sources(rng, n, kinds):
    """Time-domain test sources: spectrally distinct, amplitude-modulated."""
    t = np.arange(n) / FS
    out = []
    for kind in kinds:
        if kind == "harm":
            s = sum(np.sin(2 * np.pi * 220 * (k + 1) * t) / (k + 1)
                    for k in range(5)) * (1 + 0.4 * np.sin(2 * np.pi * 2 * t))
        elif kind.startswith("band:"):       # dense band-limited noise
            from scipy.signal import butter, lfilter
            lo, hi = (float(x) for x in kind.split(":")[1].split("-"))
            b, a = butter(4, [lo, hi], btype="band")
            s = lfilter(b, a, rng.standard_normal(n))
        elif kind == "noise_lo":
            s = np.convolve(rng.standard_normal(n), np.ones(24) / 24,
                            "same") * (np.sin(2 * np.pi * 1.3 * t) > 0)
        elif kind == "noise_hi":
            w = rng.standard_normal(n)
            s = (w - np.convolve(w, np.ones(8) / 8, "same")) \
                * (1 + 0.5 * np.sin(2 * np.pi * 0.7 * t + 1))
        elif kind == "tone_switch":   # state-switching spectra (HMM target)
            seg = int(0.25 * FS)
            freqs = [330, 660, 495]
            s = np.concatenate([
                np.sin(2 * np.pi * freqs[i % 3]
                       * np.arange(seg) / FS) for i in range(n // seg + 1)
            ])[:n]
        elif kind == "clicks":
            s = np.zeros(n)
            s[::int(0.21 * FS)] = 1.0
            s = np.convolve(s, np.hanning(64), "same") \
                * rng.standard_normal(n) * 0.5 + s
        out.append(s / (np.std(s) + 1e-9))
    return out


def _music_sources(rng, n, fs):
    """Music-like stems: bass line, chord pad, lead melody, drum kit.

    VERDICT r2 'what's missing' #3: the synthetic validation fixtures are
    short and toy-like vs the reference's SiSEC regime (no network access
    for the real corpus). These stems have the structure that makes music
    hard: shared harmonic series (bass/pad/lead all tonal, overlapping
    partials), broadband percussive onsets crossing every band, note-level
    nonstationarity, and realistic relative levels.
    """
    t = np.arange(n) / fs

    def note_seq(freq_of_i, dur, wave, attack, decay):
        seg = int(dur * fs)
        out = np.zeros(n)
        for k, i in enumerate(range(0, n, seg)):
            L = min(seg, n - i)
            tt = np.arange(L) / fs
            env = np.minimum(1.0, tt / attack) * np.exp(-tt / decay)
            out[i:i + L] = wave(freq_of_i(k), tt) * env
        return out

    def saw(f, tt):
        return sum(np.sin(2 * np.pi * f * h * tt) / h for h in range(1, 9))

    def organ(f, tt):
        return sum(np.sin(2 * np.pi * f * h * tt) / h ** 0.5
                   for h in (1, 2, 3, 4))

    roots = [55.0, 41.2, 43.65, 49.0]                 # A1 E1 F1 G1
    bass = note_seq(lambda k: roots[k % 4], 0.5, saw, 0.01, 0.4)
    chords = [(220.0, 277.2, 329.6), (164.8, 207.7, 246.9),
              (174.6, 220.0, 261.6), (196.0, 246.9, 293.7)]
    pad = note_seq(lambda k: 0.0, 2.0,
                   lambda f, tt: 0.0 * tt, 0.3, 4.0)  # filled below
    seg = int(2.0 * fs)
    for k, i in enumerate(range(0, n, seg)):
        L = min(seg, n - i)
        tt = np.arange(L) / fs
        env = np.minimum(1.0, tt / 0.3) * np.exp(-tt / 4.0)
        pad[i:i + L] = sum(organ(f, tt) for f in chords[k % 4]) * env
    pent = [440.0, 493.9, 554.4, 659.3, 740.0]
    mel = rng.integers(0, len(pent), size=n // int(0.25 * fs) + 1)

    def lead_wave(f, tt):
        vib = 1.0 + 0.012 * np.sin(2 * np.pi * 5.5 * tt)
        return (np.sin(2 * np.pi * f * vib * tt)
                + 0.4 * np.sin(2 * np.pi * 2 * f * vib * tt))

    lead = note_seq(lambda k: pent[mel[k]], 0.25, lead_wave, 0.01, 0.25)
    drums = np.zeros(n)
    beat = int(0.5 * fs)
    for i in range(0, n, beat):                       # kick
        L = min(int(0.12 * fs), n - i)
        tt = np.arange(L) / fs
        drums[i:i + L] += np.sin(
            2 * np.pi * (55 + 60 * np.exp(-tt / 0.02)) * tt) \
            * np.exp(-tt / 0.06) * 2.0
    for i in range(beat // 2, n, beat):               # snare (offbeat)
        L = min(int(0.1 * fs), n - i)
        tt = np.arange(L) / fs
        drums[i:i + L] += rng.standard_normal(L) * np.exp(-tt / 0.04)
    w = rng.standard_normal(n)
    hat_env = np.zeros(n)
    for i in range(0, n, beat // 2):                  # hats (8ths)
        L = min(int(0.04 * fs), n - i)
        hat_env[i:i + L] = np.exp(-np.arange(L) / (0.01 * fs))
    drums += (w - np.convolve(w, np.ones(5) / 5, "same")) * hat_env * 0.7
    levels = {"bass": 1.0, "pad": 0.8, "lead": 0.9, "drums": 1.1}
    out = []
    for name, s in (("bass", bass), ("pad", pad), ("lead", lead),
                    ("drums", drums)):
        out.append(levels[name] * s / (np.std(s) + 1e-9))
    return out


def _speech_sources(rng, n, fs, n_spk=3):
    """Speech-like stems: glottal-sawtooth-excited formant resonators with
    syllabic gating, unvoiced fricatives, and pauses.

    This is the SiSEC "underdetermined reverberant speech" stand-in (the
    reference's headline regime -- SURVEY.md §6; no network access for the
    real corpus). The structural properties that matter for the blind
    pipeline are reproduced: speaker-distinct pitch and formant draws,
    independent syllable timing (unlike the beat-locked music stems, the
    envelopes genuinely decorrelate -- the design regime of the
    envelope-based alignment and selection statistics), broadband
    fricative bursts, and ~4 Hz syllabic modulation.
    """
    from scipy.signal import lfilter

    vowels = [(730, 1090, 2440), (270, 2290, 3010), (300, 870, 2240),
              (660, 1720, 2410), (530, 1840, 2480)]   # a i u ae eh
    pitches = [115.0, 205.0, 150.0, 180.0]

    def resonator(x, fc, bw):
        r = np.exp(-np.pi * bw / fs)
        th = 2 * np.pi * fc / fs
        return lfilter([1.0 - r], [1.0, -2 * r * np.cos(th), r * r], x)

    out = []
    for spk in range(n_spk):
        f0 = pitches[spk % len(pitches)] * (1 + 0.06 * rng.uniform(-1, 1))
        s = np.zeros(n)
        i = int(rng.uniform(0, 0.25) * fs)            # desynchronized start
        while i < n:
            kind = rng.choice(["v", "v", "v", "f", "p"])
            dur = rng.uniform(0.12, 0.35) if kind == "v" \
                else rng.uniform(0.06, 0.2)
            L = min(int(dur * fs), n - i)
            tt = np.arange(L) / fs
            env = np.minimum(1.0, tt / 0.03) \
                * np.minimum(1.0, (L / fs - tt) / 0.05)
            if kind == "v":
                f0i = f0 * (1 + 0.12 * np.sin(
                    2 * np.pi * rng.uniform(1.5, 3.5) * tt
                    + rng.uniform(0, 6)))
                ph = 2 * np.pi * np.cumsum(f0i) / fs
                nh = max(2, int(fs / 2 / (f0 * 1.2)))
                exc = sum(np.sin(h * ph) / h for h in range(1, nh + 1))
                fset = vowels[rng.integers(0, len(vowels))]
                seg = sum(resonator(exc, fc * (1 + 0.04 * rng.uniform(-1, 1)),
                                    80 + 30 * k)
                          for k, fc in enumerate(fset))
                s[i:i + L] = seg * env
            elif kind == "f":
                w = rng.standard_normal(L)
                hp = w - np.convolve(w, np.ones(5) / 5, "same")
                s[i:i + L] = 0.35 * hp * env
            i += L
        out.append(s / (np.std(s) + 1e-9))
    return out


def _best_perm_sdr(ys, ys_true):
    """(min, mean) over sources of the image SDR at the best permutation.

    The permutation maximizes the TOTAL SDR; min is the harshest view
    (everything must separate), mean is the literature's usual summary.
    """
    J = len(ys_true)

    def sdr(a, b):
        return 10 * np.log10(np.sum(b ** 2)
                             / max(np.sum((a - b) ** 2), 1e-12))

    best, best_perm = None, None
    for p in itertools.permutations(range(J)):
        tot = sum(sdr(ys[p[j]], ys_true[j]) for j in range(J))
        if best is None or tot > best:
            best, best_perm = tot, p
    per = [sdr(ys[best_perm[j]], ys_true[j]) for j in range(J)]
    return min(per), float(np.mean(per))


def _estimate_and_separate(params, X_host, cfg):
    """X_host complex (F, N, 2) -> (params, logliks, images (J,F,N,2))."""
    X = jnp.asarray(X_host)
    scale = float(np.sqrt(np.mean(np.abs(X_host) ** 2)))
    X = X / scale
    t0 = time.perf_counter()
    params, lls = run_gem(params, X, cfg)
    _, sigma1 = annealing_endpoints(X, cfg)
    Y = separate_sources(params, X, sigma1)
    Yh = np.asarray(Y) * scale
    wall = time.perf_counter() - t0
    return params, np.asarray(lls), Yh, wall


def _istft_images(tft, Yh, nsamples):
    return np.stack([np.asarray(tft.invertTransform(Yh[j], nsamples=nsamples))
                     for j in range(Yh.shape[0])])


def _report(name, sdrs, wall, iters, extra=None, images=None):
    """images, if given, is (ys, ys_true) (J, T, 2) pairs: adds BSS-Eval
    image SDR at the literature operating point (filt_len=512, Vincent et
    al.) so numbers are comparable to FASST-paper tables -- the exact-image
    SDR columns are the harsher in-house gate (no allowed distortion)."""
    mn, mean = sdrs
    rec = {"scenario": name, "min_sdr_db": round(float(mn), 2),
           "mean_sdr_db": round(float(mean), 2),
           "wall_s": round(wall, 3), "iters": iters, **(extra or {})}
    if images is not None:
        from pyfasst_jax.utils.metrics import bss_eval_images
        out = bss_eval_images(images[0], images[1], filt_len=512)
        rec["bss512_min_sdr_db"] = round(float(out["sdr"].min()), 2)
        rec["bss512_mean_sdr_db"] = round(float(out["sdr"].mean()), 2)
    print(json.dumps(rec), flush=True)
    return rec


def scenario_inst(rng):
    """configs[0]: stereo instantaneous, 2 sources, 500 iters."""
    n = int(FS * DUR)
    s1, s2 = _sources(rng, n, ["harm", "noise_hi"])
    A = np.array([[0.95, 0.31], [0.31, 0.95]])
    ys_true = np.stack([np.outer(s1, A[:, 0]), np.outer(s2, A[:, 1])])
    mix = ys_true.sum(0)
    tft = STFT(wlen=WLEN, fs=FS)
    X = np.asarray(tft.computeTransform(mix.astype(np.float32)))
    F, N = X.shape[:2]
    key = jax.random.PRNGKey(0)
    spat = tuple(SpatialComp(A=a) for a in init_inst_mixing(None, 2, 1, 2))
    spec = tuple(init_nmf_comp(k, F, N, 8, spat_ind=j)
                 for j, k in enumerate(jax.random.split(key, 2)))
    cfg = GEMConfig(niter=500)
    _, lls, Yh, wall = _estimate_and_separate(
        FasstParams(spat=spat, spec=spec), X, cfg)
    ys = _istft_images(tft, Yh, n)
    return _report("configs[0] inst 2src", _best_perm_sdr(ys, ys_true),
                   wall, 500, {"final_ll": round(float(lls[-1]), 1)},
                   images=(ys, ys_true))


def scenario_anechoic(rng):
    """configs[1]: anechoic conv, 3 sources, rank-1 + ERB basis, 400 iters.

    Sources are spectrally dense (band-limited noises): DEMIX's lagged
    phase-slope features need in-band frequency pairs, so sparse comb
    spectra are out of its design envelope (documented in demix.py).
    """
    n = int(FS * DUR)
    srcs = _sources(rng, n, ["band:0.01-0.2", "band:0.15-0.55",
                             "band:0.45-0.95"])
    gains = [0.5, 1.0, 1.8]
    delays = [-4, 0, 5]                      # integer samples: exact images
    ys_true = []
    for s, g, d in zip(srcs, gains, delays):
        ch1 = g * np.roll(s, d)
        ys_true.append(np.stack([s, ch1], 1))
    ys_true = np.stack(ys_true)
    mix = ys_true.sum(0)
    tft = STFT(wlen=WLEN, fs=FS)
    X = np.asarray(tft.computeTransform(mix.astype(np.float32)))
    F, N = X.shape[:2]

    # DEMIX-initialized anechoic mixing
    from pyfasst_jax.models.demix import DEMIX
    dm = DEMIX(X=X, wlen=WLEN)
    dm.comp_parameters(K=3)
    A0 = dm.mixing(F)                                        # (3, F, 2, 1)
    key = jax.random.PRNGKey(1)
    FB_erb = jnp.asarray(spectral_basis("erb", 32, F, FS, WLEN), jnp.float32)
    spat = tuple(SpatialComp(A=jnp.asarray(A0[j]), mix_type=CONV)
                 for j in range(3))
    rng2 = np.random.default_rng(5)
    spec = tuple(SpectralComp(
        FB=FB_erb, FW=jnp.asarray(0.5 + rng2.random((32, 6)), jnp.float32),
        TW=jnp.asarray(0.5 + rng2.random((6, N)), jnp.float32),
        free=(False, True, True, False), spat_ind=j) for j in range(3))
    # hold the (refined sub-sample) DEMIX mixing while spectra adapt --
    # same recipe as the reverberant scenario; measured +1 dB here
    cfg = GEMConfig(niter=400, spatial_hold_frac=0.3)
    _, lls, Yh, wall = _estimate_and_separate(
        FasstParams(spat=spat, spec=spec), X, cfg)
    ys = _istft_images(tft, Yh, n)
    return _report("configs[1] anechoic 3src ERB+DEMIX",
                   _best_perm_sdr(ys, ys_true), wall, 400,
                   {"final_ll": round(float(lls[-1]), 1)},
                   images=(ys, ys_true))


def scenario_erblet(rng):
    """ERBlet front-end END TO END on hardware (VERDICT r4 item 2): the
    configs[1]-style anechoic 3-source scenario separated entirely on the
    perfect-reconstruction ERBlet grid (FASST(transform=ERBLetTransform),
    GEM on warped subbands, inverse NSGT synthesis). Exercises the
    f*2^k FFT geometry (tf/erblet.py: Tp/N rounded to f*2^k sizes)."""
    n = int(FS * DUR)
    srcs = _sources(rng, n, ["band:0.01-0.2", "band:0.15-0.55",
                             "band:0.45-0.95"])
    dirs = [(0.95, 0.31), (0.31, 0.95), (0.71, 0.71)]
    ys_true = np.stack([np.stack([a * s, b * s], 1)
                        for s, (a, b) in zip(srcs, dirs)])
    mix = ys_true.sum(0)

    from pyfasst_jax.models.variants import MultiChanNMFInst_FASST
    from pyfasst_jax.tf.erblet import ERBLetTransform

    t0 = time.perf_counter()
    model = MultiChanNMFInst_FASST(
        mix.astype(np.float32), fs=FS, nbComps=3, nbNMFComps=8,
        iter_num=400, seed=0, verbose=0,
        transform=ERBLetTransform(fs=FS, n_bands=48))
    lls = model.estim_param_a_posteriori()
    ys = np.asarray(model.separated_images())
    wall = time.perf_counter() - t0
    return _report("erblet front-end anechoic 3src (end-to-end warped "
                   "grid)", _best_perm_sdr(ys[:, :n], ys_true), wall, 400,
                   {"final_ll": round(float(np.asarray(lls)[-1]), 1)},
                   images=(ys[:, :n], ys_true))


def reverb_mixture(rng):
    """configs[2] fixture: 4 sources, 16 kHz, 6 s, each convolved with a
    100-tap decaying per-channel response. Returns (mix (T, 2),
    ys_true (4, T, 2))."""
    n = int(FS * DUR)
    srcs = _sources(rng, n, ["harm", "noise_lo", "noise_hi", "clicks"])
    ys_true = []
    for j, s in enumerate(srcs):
        chs = []
        for ch in range(2):
            h = rng.standard_normal(100) * np.exp(-np.arange(100) / 20.0)
            h[0] += 1.5 if ch == (j % 2) else 0.4   # direction + reverb tail
            chs.append(np.convolve(s, h, "same"))
        ys_true.append(np.stack(chs, 1))
    ys_true = np.stack(ys_true)
    return ys_true.sum(0), ys_true


def scenario_reverb(rng):
    """configs[2]: reverberant full-rank, 4 sources, rank-2, 400 iters."""
    n = int(FS * DUR)
    mix, ys_true = reverb_mixture(rng)
    tft = STFT(wlen=WLEN, fs=FS)
    X = np.asarray(tft.computeTransform(mix.astype(np.float32)))
    # the full blind reverberant pipeline (models/reverb.py) at the
    # round-5 `--preset reverb` point: candidate pool + LEARNED vote
    # candidate, learned-judge selection, EM posterior reseeding.
    # Measured across the gate draws 102-106 (round 5,
    # tools/reverb_robustness.py --learned --select learned): min SDR
    # worst/median/best 10.42 / 11.33 / 12.92 dB (round-4 consistency+
    # bandem recipe: 8.02/8.73/11.44; round 2's init+single-fit:
    # 1.9/2.4/5.4; round 1's DEMIX rank-expansion: 0.3; design.md §6j).
    from pyfasst_jax.models.reverb import blind_reverb_separate
    t0 = time.perf_counter()
    Y, info = blind_reverb_separate(X, J=4, iters=400, em_seeds=2,
                                    learned=True, select="learned")
    ys = _istft_images(tft, Y, n)
    wall = time.perf_counter() - t0
    return _report("configs[2] reverberant full-rank 4src (blind "
                   "pipeline)", _best_perm_sdr(ys, ys_true), wall, 400,
                   {"picked": info["picked"],
                    "final_ll": round(float(info["final_ll"]), 1)},
                   images=(ys, ys_true))


def _music_mix(rng, srcs, n, fs, t60, pans):
    from scipy.signal import fftconvolve

    taps = int(fs * t60)
    ys_true = []
    for j, s in enumerate(srcs):
        az, g = pans[j]
        itd = int(round(az * 8))                     # +-8-sample ITD max
        chs = []
        for ch in range(2):
            h = rng.standard_normal(taps) * np.exp(
                -3.0 * np.log(10) * np.arange(taps) / taps) * 0.08
            d = max(0, itd if ch == 0 else -itd)
            h[d] += g * (1.2 - 0.4 * np.sign(az) * (1 if ch else -1))
            chs.append(fftconvolve(s, h)[:n])
        ys_true.append(np.stack(chs, 1))
    return np.stack(ys_true)


def _music_run(rng, kinds, t60, pans, tag):
    """Blind separation via the MULTISCALE ladder at the round-5
    `--preset music` point: learned fine-stage candidate + learned
    fine-stage selection (models/binfeat), alignment evidence at wlen
    2048 (46 ms), model capacity at wlen 8192 (oracle-init ceiling 13.1
    vs 7.1 dB). Measured over 3-stem draws 100-104:
    min SDR 5.18/8.67/10.74 worst/median/best (design.md §6j; the
    round-4 hand-feature ladder: min ~0, mean ~2.2)."""
    from pyfasst_jax.models.reverb import blind_reverb_separate_multiscale

    fs = 44100
    n = int(fs * 20.0)
    srcs = _music_sources(rng, n, fs)
    srcs = [srcs[k] for k in kinds]
    ys_true = _music_mix(rng, srcs, n, fs, t60, pans)
    mix = ys_true.sum(0)
    t0 = time.perf_counter()
    Y, info = blind_reverb_separate_multiscale(
        mix.astype(np.float32), J=len(kinds), fs=fs, wlen_fine=2048,
        wlen_coarse=8192, iters=400, em_seeds=2, chunk=12,
        learned=True, select="learned")
    ys = _istft_images(info["transform"], Y, n)
    wall = time.perf_counter() - t0
    return _report(tag, _best_perm_sdr(ys, ys_true), wall, 400,
                   {"picked": info["picked"],
                    "fine_picked": info["fine"]["picked"]},
                   images=(ys, ys_true))


def scenario_music(rng):
    """Stretch scenarios (no BASELINE config): 20 s, 44.1 kHz music-like
    mixtures, blind pipeline -- a difficulty gradient.

    Both rows are harder than configs[2]: real RIR lengths (0.12-0.25 s
    T60 = 5k-11k taps vs configs[2]'s 100), shared harmonic series
    between tonal stems, broadband percussion, 4x the spectrogram.
    Report-only (documents the honest capability boundary on music-like
    material); the 4-stem row is expected to fail (3 tonal stems share
    harmonics under heavy reverb -- beyond blind separation of this
    model family), the 3-stem row shows the partial-capability regime."""
    r1 = _music_run(rng, [0, 2, 3], 0.12,
                    [(0.9, 1.0), (-0.9, 1.0), (0.0, 1.0)],
                    "music 3-stem (bass/lead/drums) T60=0.12s (multiscale "
                    "ladder)")
    r2 = _music_run(rng, [0, 1, 2, 3], 0.25,
                    [(0.0, 1.3), (0.8, 0.5), (-0.8, 0.5), (0.0, 0.9)],
                    "music 4-stem (+pad) T60=0.25s (multiscale ladder)")
    return [r1, r2]


def scenario_speech(rng):
    """SiSEC-regime stand-in (no BASELINE config): 3 simultaneous
    speech-like speakers (speaker-distinct pitch/formants, independent
    syllable timing) under T60=0.25 s reverb, 2 channels, 10 s — the
    reference's headline campaign regime (SURVEY.md §6: underdetermined
    reverberant speech; no network access for the real corpus). Blind
    pipeline at the SHIPPED round-5 `--preset speech` operating point
    (band-EM pool + LEARNED vote candidate + learned-judge selection,
    no reseeds — design.md §6j). Measured min SDR over seeds 120-124:
    {9.46, 9.25, 6.84, 12.77, 11.38} — worst 6.84 / median 9.46 (the
    round-4 hand-feature preset: {9.47, 0.60, 0.20, 0.64, 0.34})."""
    import speech_lab

    mix, ys_true, n = speech_lab._fixture(3, 0.25, 120)
    tft = STFT(wlen=2048, fs=speech_lab.FS)
    X = np.asarray(tft.computeTransform(mix.astype(np.float32)))
    from pyfasst_jax.models.reverb import blind_reverb_separate
    t0 = time.perf_counter()
    Y, info = blind_reverb_separate(X, J=3, iters=400, em_seeds=2,
                                    reseed_rounds=0, band_em=32,
                                    select="learned", learned=True,
                                    chunk=12)
    ys = _istft_images(tft, Y, n)
    wall = time.perf_counter() - t0
    return _report("speech 3-spk T60=0.25s 2ch (SiSEC-regime stand-in, "
                   "blind pipeline)", _best_perm_sdr(ys, ys_true), wall,
                   400, {"picked": info["picked"]},
                   images=(ys, ys_true))


def _state_switch_fixture(rng, n):
    """Two Markov state-switching sources at nearly co-located directions
    (35 vs 60 deg): spatial cues barely help and the templates overlap
    across sources, so the spectral STATE structure is what identifies
    the sources. The hardware-scale twin of
    tests/test_hmm.py::_state_switching_mixture (round-2 verdict item 6:
    configs[3] must show state modelling winning at non-trivial SDR)."""
    t = np.arange(n) / FS

    def markov_states(dwell_s, n_states):
        out = np.zeros(n, int)
        pos = 0
        q = rng.integers(n_states)
        while pos < n:
            d = int(FS * rng.uniform(0.7 * dwell_s, 1.3 * dwell_s))
            out[pos:pos + d] = q
            pos += d
            q = (q + rng.integers(1, n_states)) % n_states
        return out

    def tone(f0, harmonics):
        x = sum(np.sin(2 * np.pi * f0 * h * t + rng.uniform(0, 2 * np.pi))
                / h for h in harmonics)
        return x / np.max(np.abs(x))

    def noiseband(lo, hi):
        x = rng.standard_normal(n)
        Xf = np.fft.rfft(x)
        f = np.fft.rfftfreq(n, 1 / FS)
        Xf[(f < lo) | (f > hi)] = 0
        x = np.fft.irfft(Xf, n)
        return x / np.max(np.abs(x))

    TA = [tone(250, [2, 6, 10]), tone(330, [1, 3, 5])]
    TB = [tone(250, [2, 8, 14]), noiseband(900, 1800)]
    sA = np.where(markov_states(0.45, 2) == 0, TA[0], TA[1])
    sB = np.where(markov_states(0.6, 2) == 0, TB[0], TB[1])
    aA = np.array([np.cos(np.deg2rad(35)), np.sin(np.deg2rad(35))])
    aB = np.array([np.cos(np.deg2rad(60)), np.sin(np.deg2rad(60))])
    ys_true = np.stack([sA[:, None] * aA, sB[:, None] * aB])
    return ys_true.sum(0).astype(np.float32), ys_true


def scenario_hmm(rng):
    """configs[3]: HMM spectral states. Two rows:

    1. the canonical easy fixture (well-separated directions) -- proves
       the HMM path runs at full scale and converges cleanly;
    2. a near-co-located state-switching mixture where spatial cues
       barely help: the HMM (Viterbi decode) is compared against an
       equal-K plain NMF on the SAME mixture, and the NMF's number is
       recorded in the row -- state modelling must win at a non-trivial
       operating point (mirrors test_hmm_beats_nmf_on_state_structured
       _material at hardware scale)."""
    from pyfasst_jax.models.variants import MultiChanHMM, \
        MultiChanNMFInst_FASST

    n = int(FS * DUR)
    s1, s2 = _sources(rng, n, ["tone_switch", "noise_hi"])
    A = np.array([[0.9, 0.35], [0.35, 0.9]])
    ys_true = np.stack([np.outer(s1, A[:, 0]), np.outer(s2, A[:, 1])])
    mix = ys_true.sum(0)
    model = MultiChanHMM(mix, fs=FS, nbComps=2, nbStates=6, wlen=WLEN,
                         iter_num=300, sparsity="HMM")
    t0 = time.perf_counter()
    model.estim_param_a_posteriori()
    ys = model.separated_images()
    wall = time.perf_counter() - t0
    r1 = _report("configs[3] HMM 2src", _best_perm_sdr(ys, ys_true),
                 wall, 300, {"final_ll": round(float(model.logliks[-1]), 1)},
                 images=(ys, ys_true))

    mix2, ys2_true = _state_switch_fixture(rng, n)
    kw = dict(fs=FS, wlen=512, iter_num=300, nbComps=2, seed=0)
    t0 = time.perf_counter()
    hmm = MultiChanHMM(mix2, nbStates=2, sparsity="HMM", self_trans=0.97,
                       decode="viterbi", **kw)
    hmm.estim_param_a_posteriori()
    ys_h = hmm.separated_images()
    wall = time.perf_counter() - t0
    nmf = MultiChanNMFInst_FASST(mix2, nbNMFComps=2, **kw)
    nmf.estim_param_a_posteriori()
    ys_n = nmf.separated_images()
    nmf_min, _ = _best_perm_sdr(ys_n, ys2_true)
    r2 = _report("configs[3] HMM hard (co-located state-switch; equal-K "
                 f"NMF gets {nmf_min:.2f})",
                 _best_perm_sdr(ys_h, ys2_true), wall, 300,
                 {"nmf_min_sdr_db": round(float(nmf_min), 2)},
                 images=(ys_h, ys2_true))
    return [r1, r2]


def scenario_general_I(rng):
    """General-I engine on real hardware (rounds 1-2 were stereo-only;
    the I != 2 path is the unrolled square-root engine
    ops/engine_general.py): a 3-channel instantaneous mixture and a MONO
    spectral-only separation, both through the public model API."""
    from pyfasst_jax.models.variants import MultiChanNMFInst_FASST

    n = int(FS * DUR)
    s1, s2 = _sources(rng, n, ["harm", "noise_hi"])
    a1 = np.array([0.9, 0.5, 0.2])
    a2 = np.array([0.25, 0.6, 0.95])
    ys_true = np.stack([np.outer(s1, a1), np.outer(s2, a2)])
    mix = ys_true.sum(0).astype(np.float32)
    model = MultiChanNMFInst_FASST(mix, fs=FS, nbComps=2, nbNMFComps=8,
                                   wlen=WLEN, iter_num=300, seed=0)
    t0 = time.perf_counter()
    model.estim_param_a_posteriori()
    ys = model.separated_images()
    wall = time.perf_counter() - t0
    r1 = _report("3-channel inst 2src (general-I engine)",
                 _best_perm_sdr(ys, ys_true), wall, 300,
                 images=(ys, ys_true))

    s1m, s2m = _sources(rng, n, ["harm", "noise_lo"])
    ys_true_m = np.stack([s1m[:, None], s2m[:, None]])
    mix_m = ys_true_m.sum(0).astype(np.float32)
    model = MultiChanNMFInst_FASST(mix_m, fs=FS, nbComps=2, nbNMFComps=6,
                                   wlen=WLEN, iter_num=300, seed=0)
    t0 = time.perf_counter()
    # production blind-mono path (models/mono.py nmf_cluster_init):
    # random init measured 3.2 dB on this fixture vs 11.4 from the
    # mixture-NMF envelope-clustering init (tools/mono_ceiling.py,
    # design.md §6h)
    model.estim_param_blind_mono()
    ys = model.separated_images()
    wall = time.perf_counter() - t0
    r2 = _report("mono 2src blind (spectral-only, nmf-cluster init)",
                 _best_perm_sdr(ys, ys_true_m), wall, 300,
                 images=(ys, ys_true_m))
    return [r1, r2]


def scenario_lead(rng):
    """Lead/accompaniment (SeparateLeadStereoTF) at hardware scale: a
    vibrato melody (1 semitone @ 0.7 Hz -- exercises the chirped KLGLOTT88
    atoms) over a drone+colored-noise accompaniment, distinctly panned.
    First hardware row for the SIMM pipeline (rounds 1-3 validated it on
    CPU only, tests/test_lead.py)."""
    from scipy.signal import lfilter

    from pyfasst_jax.models.lead import SeparateLeadStereoTF

    n = int(FS * DUR)
    t = np.arange(n) / FS
    f0 = 220 * 2 ** (0.25 * np.sin(2 * np.pi * 0.7 * t))
    phase = 2 * np.pi * np.cumsum(f0) / FS
    lead = sum((0.5 / h) * np.sin(h * phase) for h in range(1, 6))
    acc = lfilter([1], [1, -0.95], 0.05 * rng.standard_normal(n))
    acc += 0.15 * np.sin(2 * np.pi * 110 * t)
    y_lead = np.stack([0.8 * lead, 0.6 * lead], 1)
    y_acc = np.stack([0.7 * acc, 0.8 * acc], 1)
    mix = (y_lead + y_acc).astype(np.float32)
    model = SeparateLeadStereoTF(audio=mix, fs=FS, wlen=2048, niter=60)
    t0 = time.perf_counter()
    model.runDecomposition()
    est_lead, est_acc = model.separated_signals()
    wall = time.perf_counter() - t0
    ys = np.stack([est_lead, est_acc])
    ys_true = np.stack([y_lead, y_acc])
    return _report("lead/accompaniment SIMM (vibrato lead over drone)",
                   _best_perm_sdr(ys, ys_true), wall, 60,
                   images=(ys, ys_true))


def scenario_streaming(rng):
    """Long-form bounded-memory streaming separation (SURVEY §5
    long-context row, first hardware quality number for it).

    A 120 s stereo mixture is streamed OFF DISK (native codec block
    reads -> STFT.stream_blocks -> ops.online.online_block): estimation
    never materializes the full (F, N) plane on device -- per-block
    planes are (F, Nb). Pass 1 learns (A, FB) with exponential
    forgetting; pass 2 freezes them, re-estimates the block's TW under
    the frozen parameters (the streaming-inference operating mode of the
    online-FASST lineage, arXiv:1112.6178), and Wiener-separates the
    block. Synthesis here collects the masked block spectra and inverts
    once for SDR scoring (a deployment would OLA per block with a
    wlen-hop tail carry). Reports exact-image SDR over full stems,
    streaming xRT (both passes, steady-state), and the block-vs-full
    frame ratio that bounds device memory.
    """
    import tempfile

    from pyfasst_jax.audio import wavwrite
    from pyfasst_jax.models.components import init_inst_mixing
    from pyfasst_jax.ops.online import online_block, online_init

    dur = 120.0
    n = int(FS * dur)
    J, K, Nb = 2, 8, 64
    # dense band-limited sources: a sparse comb (5 active bins) leaves
    # the per-frequency rank-1 mixing unidentifiable at the other bins --
    # measured: comb+noise collapses both A_j to the broadband direction
    # and the masks split the mixture ~50/50 (0 dB); dense bands reach
    # ~6.7 dB fully blind (the online-EM operating point, not batch EM)
    s1, s2 = _sources(rng, n, ["band:0.02-0.3", "band:0.25-0.8"])
    A_true = np.array([[0.95, 0.31], [0.31, 0.95]])
    ys_true = np.stack([np.outer(s1, A_true[:, 0]),
                        np.outer(s2, A_true[:, 1])])
    mix = ys_true.sum(0)
    mix = mix / (np.max(np.abs(mix)) * 1.05)
    ys_true = ys_true / (np.max(np.abs(ys_true.sum(0))) * 1.05)
    with tempfile.NamedTemporaryFile(suffix=".wav", delete=False) as fh:
        path = fh.name
    wavwrite(mix, FS, path)

    tft = STFT(wlen=WLEN, fs=FS)
    F = tft.F
    A0 = jnp.stack([jnp.broadcast_to(
        jnp.asarray(np.asarray(a)[:, 0], jnp.float32).astype(jnp.complex64),
        (F, 2)) for a in init_inst_mixing(None, 2, 1, J)])
    rng2 = np.random.default_rng(7)
    FB0 = jnp.asarray(0.5 + rng2.random((J, F, K)), jnp.float32)
    TW0 = jnp.asarray(0.5 + rng2.random((J, K, Nb)), jnp.float32)

    blocks = [Xb for Xb in tft.stream_blocks(path, Nb)
              if Xb.shape[1] == Nb]                # drop the ragged tail
    sigma = jnp.full((F,), 1e-3 * float(
        jnp.mean(jnp.abs(blocks[0]) ** 2)), jnp.float32)

    def sep_block(A, FB, TWb, Xb, sigma):
        """One block through the PRODUCTION Wiener path (the naive
        adjugate re-derivation here was measured to blow up exactly as
        ops/wiener.py's docstring predicts -- det cancellation)."""
        spat = tuple(SpatialComp(A=A[j][..., None], mix_type=CONV)
                     for j in range(J))
        spec = tuple(SpectralComp(FB=FB[j], TW=TWb[j], spat_ind=j)
                     for j in range(J))
        return separate_sources(FasstParams(spat=spat, spec=spec),
                                Xb, sigma)

    def run_passes():
        state = online_init(A0, FB0)
        for Xb in blocks:                          # pass 1: learn A, FB
            state, (_, ll) = online_block(state, Xb, TW0, sigma,
                                          forgetting=0.95, inner_iters=6)
        outs = []
        for Xb in blocks:                          # pass 2: frozen params
            _, (TWb, _) = online_block(state, Xb, TW0, sigma,
                                       forgetting=0.95, inner_iters=6)
            outs.append(sep_block(state.A, state.FB, TWb, Xb, sigma))
        return state, outs, ll

    run_passes()                                   # compile both programs
    t0 = time.perf_counter()
    state, outs, ll = jax.block_until_ready(run_passes())
    wall = time.perf_counter() - t0

    Y = jnp.concatenate(outs, axis=2)              # (J, F, n_blocks*Nb, 2)
    n_exp = tft.n_frames(n)                        # pad the dropped ragged
    pad = n_exp - Y.shape[2]                       # tail with zero frames
    if pad > 0:
        Y = jnp.concatenate(
            [Y, jnp.zeros(Y.shape[:2] + (pad, 2), Y.dtype)], axis=2)
    # score strictly inside the streamed region (the last wlen of samples
    # before the tail boundary depends on the zero-padded frames)
    n_sep = min(n, len(blocks) * Nb * tft.hop - tft.wlen)
    ys = np.stack([np.asarray(tft.invertTransform(Y[j], nsamples=n))
                   for j in range(J)])[:, :n_sep]
    sdrs = _best_perm_sdr(ys, ys_true[:, :n_sep])
    rows = [_report(
        "long-form streaming 120s (online GEM, block-paged off disk)",
        sdrs, wall, len(blocks),
        {"stream_xrt": round(dur / wall, 1),
         "block_frames": Nb, "total_frames": len(blocks) * Nb,
         "final_ll": round(float(jnp.real(ll)), 1)},
        images=(ys, ys_true[:, :n_sep]))]

    # round-5 (VERDICT r4 item 9): the SAME 120 s fixture through the
    # PUBLIC bounded-memory pipeline with the blind prefix init
    # (models/streaming._blind_prefix_init: DEMIX anechoic directions
    # from the first 12 s; memory stays O(prefix))
    from pyfasst_jax.models.streaming import separate_streaming
    t0 = time.perf_counter()
    ys_b, info_b = separate_streaming(path, J=J, K=K, wlen=WLEN,
                                      frames_per_block=Nb, init="blind",
                                      verbose=0)
    wall_b = time.perf_counter() - t0
    os.unlink(path)
    sdrs_b = _best_perm_sdr(ys_b[:, :n_sep], ys_true[:, :n_sep])
    rows.append(_report(
        "long-form streaming 120s blind init (public pipeline, DEMIX "
        "prefix seed)", sdrs_b, wall_b, info_b["blocks"],
        {"stream_xrt": round(dur / wall_b, 1),
         "final_ll": round(info_b["logliks"][-1], 1)},
        images=(ys_b[:, :n_sep], ys_true[:, :n_sep])))
    return rows


def scenario_streaming_fullrank(rng):
    """Full-rank streaming (per-block Duong covariance re-estimation,
    ops/online._fullrank_block_step) end to end through the public
    separate_streaming pipeline -- disk in, stems out, bounded memory.

    Fixture: 60 s stereo, each source is TWO decorrelated same-band
    signals with different pannings, i.e. a genuinely rank-2 per-bin
    spatial covariance (a diffuse source) -- the case the full-rank
    streaming mode exists for. The rank-1 streaming model on the same
    file is reported alongside (it cannot represent the second spatial
    dimension; measured ~4 dB behind on the CPU fixture family,
    tests/test_online.py::test_online_fullrank_beats_rank1_on_diffuse).
    """
    import tempfile

    from pyfasst_jax.audio import wavwrite
    from pyfasst_jax.models.streaming import separate_streaming

    dur = 60.0
    n = int(FS * dur)
    s1a, s1b = _sources(rng, n, ["band:0.02-0.3", "band:0.02-0.3"])
    s2a, s2b = _sources(rng, n, ["band:0.25-0.8", "band:0.25-0.8"])
    pans = [(np.array([0.95, 0.31]), np.array([0.55, -0.45])),
            (np.array([0.31, 0.95]), np.array([-0.45, 0.55]))]
    ys_true = np.stack([
        np.outer(s1a, pans[0][0]) + 0.6 * np.outer(s1b, pans[0][1]),
        np.outer(s2a, pans[1][0]) + 0.6 * np.outer(s2b, pans[1][1])])
    mix = ys_true.sum(0)
    sc = np.max(np.abs(mix)) * 1.05
    mix, ys_true = mix / sc, ys_true / sc
    with tempfile.NamedTemporaryFile(suffix=".wav", delete=False) as fh:
        path = fh.name
    wavwrite(mix, FS, path)

    separate_streaming(path, J=2, K=8, wlen=WLEN,       # compile both
                       frames_per_block=64, spatial_rank=-1, verbose=0)
    t0 = time.perf_counter()                            # warm timing
    ys, info = separate_streaming(path, J=2, K=8, wlen=WLEN,
                                  frames_per_block=64, spatial_rank=-1,
                                  verbose=0)
    wall = time.perf_counter() - t0
    sdrs = _best_perm_sdr(ys, ys_true)
    ys_r1, _ = separate_streaming(path, J=2, K=8, wlen=WLEN,
                                  frames_per_block=64, spatial_rank=1,
                                  verbose=0)
    r1_min, r1_mean = _best_perm_sdr(ys_r1, ys_true)
    os.unlink(path)
    return _report(
        "full-rank streaming 60s (diffuse rank-2 sources, Duong online EM)",
        sdrs, wall, info["blocks"],
        {"stream_xrt": round(dur / wall, 1),
         "rank1_min_sdr_db": round(float(r1_min), 2),
         "rank1_mean_sdr_db": round(float(r1_mean), 2),
         "final_ll": round(info["logliks"][-1], 1)},
        images=(ys, ys_true))


def scenario_batch(rng):
    """configs[4]: batched separation of 8 variable-length clips (one chip;
    the 8-device sharded path is validated on the CPU mesh in tests)."""
    from pyfasst_jax.parallel.batch import batch_separate
    from pyfasst_jax.parallel.sharding import make_mesh

    tft = STFT(wlen=WLEN, fs=FS)
    Xs, total_audio = [], 0.0
    for i in range(8):
        dur = 4.0 + 0.5 * i
        n = int(FS * dur)
        total_audio += dur
        s1, s2 = _sources(rng, n, ["harm", "noise_hi"])
        mix = np.outer(s1, [0.95, 0.31]) + np.outer(s2, [0.31, 0.95])
        Xs.append(np.asarray(tft.computeTransform(
            mix.astype(np.float32))))
    F = Xs[0].shape[0]

    def make_params(F, Npad, i):
        key = jax.random.PRNGKey(i)
        spat = tuple(SpatialComp(A=a)
                     for a in init_inst_mixing(None, 2, 1, 2))
        spec = tuple(init_nmf_comp(k, F, Npad, 8, spat_ind=j)
                     for j, k in enumerate(jax.random.split(key, 2)))
        return FasstParams(spat=spat, spec=spec)

    cfg = GEMConfig(niter=300)
    mesh = make_mesh(1)
    # warm-up pass compiles one executable per frame bucket; time the
    # second pass (steady-state throughput, same methodology as bench.py).
    # The end-to-end wall includes fetching the stem spectra to the host;
    # the device-path throughput is reported beside it.
    batch_separate(Xs, make_params, cfg, mesh=mesh, granularity=256)
    t0 = time.perf_counter()
    imgs, lls = batch_separate(Xs, make_params, cfg, mesh=mesh,
                               granularity=256)
    wall = time.perf_counter() - t0

    from pyfasst_jax.ops.gem import endpoints_from_power
    from pyfasst_jax.parallel.batch import _pad_frames
    from pyfasst_jax.parallel.sharding import (
        batch_params, batched_run_gem, sharded_batch_separate,
    )

    Npad = max(256, -(-max(x.shape[1] for x in Xs) // 256) * 256)
    X_b = jnp.asarray(np.stack(
        [_pad_frames(np.asarray(x, np.complex64), Npad) for x in Xs]))
    params_b = batch_params([make_params(F, Npad, i) for i in range(8)])
    Pm = jnp.asarray(np.stack([
        np.mean(np.abs(np.asarray(x)) ** 2, axis=(1, 2))
        for x in Xs]).astype(np.float32))
    se = jax.vmap(lambda p: endpoints_from_power(p, cfg))(Pm)

    def device_path():
        pb, ll = batched_run_gem(params_b, X_b, cfg, mesh,
                                 sigma_endpoints_b=tuple(se))
        jax.block_until_ready(
            (ll, sharded_batch_separate(pb, X_b, se[1], mesh)))

    device_path()
    t0 = time.perf_counter()
    device_path()
    dev_wall = time.perf_counter() - t0

    finite = all(np.all(np.isfinite(l)) for l in lls) and \
        all(np.all(np.isfinite(y)) for y in imgs)
    rec = {"scenario": "configs[4] batch 8 clips (1 chip)",
           "total_audio_s": total_audio, "wall_s": round(wall, 2),
           "batched_xrt": round(total_audio / dev_wall, 1),
           "end_to_end_xrt": round(total_audio / wall, 1),
           "iters": 300, "all_finite": bool(finite)}
    print(json.dumps(rec), flush=True)
    return rec


_NOTES = """\
Notes (multi-draw context for the single-fixture rows above; 400
iters, round 5 — docs/design.md §6j):

- The blind rows (configs[2], music, speech) run the shipped round-5
  operating points: LEARNED per-bin vote candidate + learned-judge
  selection (`models/binfeat`, CLI presets `reverb|music|speech`).
- configs[2] gate draws 102-106: min-SDR worst/median/best
  **10.42 / 11.33 / 12.92** (round-4 consistency+bandem recipe:
  8.02/8.73/11.44; round-3 74-candidate pool-ORACLE: 6.3-10.3).
- music 3-stem draws 100-104 (ladder + learned): **5.18 / 8.67 /
  10.74** (round-4 hand-feature ladder: min ~0, mean ~2.2). The flat
  coarse-grid learned probe measures -0.46/1.44/6.15 — the ladder is
  still load-bearing.
- speech seeds 120-124: **{9.46, 9.25, 6.84, 12.77, 11.38}** — worst
  6.84 / median 9.46 / best 12.77 (round-4 preset: best 9.47 / median
  0.60 / worst 0.20).
- mono row: the nmf-cluster init wins on THIS fixture (10.65 vs ~3.2
  random) but the 5-draw sweep is NEGATIVE (worst/median -1.36/2.05 vs
  random 0.37/3.75, design.md §6h) — the init is opt-in, not default.

## Second fixture family: image-method rooms (round 5)

`tools/fixtures2.py` (Allen-Berkley image method, Sabine T60 law,
speech-modulated sources — the threshold-transfer family, design.md
§6f/§6j). 5 draws (seeds 202-206), 400 iters, learned pipeline
(`--learned --select learned`), min-SDR worst/median/best:

| variant | blind pipeline (round 5, learned) | round-4 hand recipe | oracle-EM ceiling (same draws) |
|---|---|---|---|
| ORTF cardioid pair (family default) | **9.70 / 9.81 / 11.32** | -0.56 / -0.29 / +0.74 | 7.91 / 10.47 / 11.12 (min) |
| omni pair (time-only cues, hard variant) | **9.26 / 9.90 / 11.21** | -0.33 / -0.12 / +1.35 | same draws |

Both variants now sit AT the oracle-vote EM ceiling measured in round
4 — the learned embedding closed the entire vote-quality gap that
defined this family's boundary.
"""


def main():
    print(json.dumps({"backend": jax.default_backend()}), flush=True)
    # per-scenario deterministic rngs: each fixture is reproducible by
    # running its scenario standalone (a shared sequential rng made every
    # fixture depend on every earlier scenario's draw count)
    # explicit per-scenario seeds: the original five keep their round-2
    # values (rows stay comparable across rounds); additions get fresh
    # seeds instead of shifting everyone after them
    scens = [(scenario_inst, 100), (scenario_anechoic, 101),
             (scenario_reverb, 102), (scenario_hmm, 103),
             (scenario_general_I, 110), (scenario_lead, 111),
             (scenario_streaming, 112), (scenario_streaming_fullrank, 113),
             (scenario_batch, 104), (scenario_music, 105),
             (scenario_speech, 120), (scenario_erblet, 130)]
    # optional substring filter for standalone scenario development:
    #   python tools/validate_hw.py streaming
    # (filtered runs print rows but do NOT rewrite docs/validation.md)
    only = sys.argv[1] if len(sys.argv) > 1 else None
    if only:
        scens = [(s, seed) for s, seed in scens if only in s.__name__]
    recs = []
    for s, seed in scens:
        r = s(np.random.default_rng(seed))
        recs.extend(r if isinstance(r, list) else [r])
    if only:
        return
    lines = [
        "# Validation matrix",
        "",
        "Generated by `tools/validate_hw.py` on one "
        f"{jax.devices()[0].device_kind}: the five BASELINE.json "
        "acceptance configs and the added scenarios at full iteration "
        "counts, SDR over sources at the best permutation, scored against "
        "exact synthetic source images. Separation quality only: times "
        "are in the script's JSON lines, speed is bench.py's metric.",
        "",
        "| scenario | min SDR (dB) | mean SDR (dB) | BSS-Eval-512 "
        "min/mean (dB) | iters |",
        "|---|---|---|---|---|",
    ]
    for r in recs:
        if "min_sdr_db" in r:
            b = (f"{r['bss512_min_sdr_db']} / {r['bss512_mean_sdr_db']}"
                 if "bss512_min_sdr_db" in r else "--")
            lines.append(f"| {r['scenario']} | {r['min_sdr_db']} | "
                         f"{r['mean_sdr_db']} | {b} | {r['iters']} |")
        else:
            lines.append(f"| {r['scenario']} | (finite={r['all_finite']}) "
                         f"| -- | -- | {r['iters']} |")
    lines.append("")
    lines.append(_NOTES)
    out = os.path.join(os.path.dirname(__file__), "..", "docs",
                       "validation.md")
    with open(out, "w") as fh:
        fh.write("\n".join(lines))
    print(json.dumps({"wrote": "docs/validation.md"}), flush=True)


if __name__ == "__main__":
    main()
