"""The FASST host API class.

Reference parity: pyfasst/audioModel.py::FASST (UNVERIFIED; mount empty, see
SURVEY.md §3). Same user-facing flow as the reference:

    model = MultiChanNMFInst_FASST("mix.wav", nbComps=2, nbNMFComps=4)
    model.estim_param_a_posteriori()          # run the GEM loop
    model.separate_spat_comps("out_dir/")     # per-source WAVs on disk

The class is a thin host wrapper: audio I/O and WAV writing stay on the host;
the transform, the whole GEM loop, and separation are jitted device programs
(pyfasst_jax.ops). Parameters live in an immutable FasstParams pytree
(`self.params`), replaced wholesale after each estimation call.
"""
from __future__ import annotations

import os
import time
from typing import List, Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from pyfasst_jax.audio import AudioObject
from pyfasst_jax.models.components import FasstParams
from pyfasst_jax.ops import wiener
from pyfasst_jax.ops.gem import (
    annealing_endpoints, observed_covariance, run_gem,
)
from pyfasst_jax.tf.stft import STFT
from pyfasst_jax.utils.config import GEMConfig


class FASST:
    """Base class: holds the mixture transform and the parameter pytree.

    Subclasses (variants.py) construct `self.params`. kwargs mirror the
    reference's constructor knobs: `wlen`, `hop`, `iter_num`, annealing mode,
    `verbose`.
    """

    def __init__(self,
                 audio: Union[str, AudioObject, np.ndarray],
                 fs: int = 44100,
                 wlen: int = 1024,
                 hop: Optional[int] = None,
                 iter_num: int = 200,
                 annealing: str = "ann",
                 sigma_start_frac: float = 1e-2,
                 sigma_end_frac: float = 3e-6,
                 verbose: int = 0,
                 tf_method: str = "fft",
                 dtype: str = "float32",
                 seed: int = 0,
                 spatial_hold_frac: Optional[float] = None,
                 transform: Optional[object] = None):
        if isinstance(audio, AudioObject):
            self.audio = audio
        elif isinstance(audio, (str, os.PathLike)):
            self.audio = AudioObject(audio)
        else:
            self.audio = AudioObject(data=np.asarray(audio), samplerate=fs)
        self.fs = self.audio.samplerate
        self.verbose = verbose
        self.seed = int(seed)
        self.key = jax.random.PRNGKey(seed)
        # dtype='float64' is the CPU bit-parity mode (SURVEY.md §7 hard
        # parts); it requires jax_enable_x64 (else jax silently downcasts).
        if dtype not in ("float32", "float64"):
            raise ValueError(f"dtype must be float32/float64, got {dtype!r}")
        if dtype == "float64" and not jax.config.jax_enable_x64:
            raise RuntimeError(
                "dtype='float64' requires jax_enable_x64 (the CPU parity "
                "mode); enable it via jax.config or the enable_x64 context")
        self.dtype = jnp.float64 if dtype == "float64" else jnp.float32
        self.np_dtype = np.float64 if dtype == "float64" else np.float32

        # Pluggable analysis/synthesis front-end, mirroring the reference's
        # transform choice (pyfasst FASST runs over STFT, MinQT, or the
        # vendored NSGT/ERBlet -- SURVEY.md §3.1, UNVERIFIED). Any object
        # with computeTransform((T, I)) -> complex (F, N, I) and
        # invertTransform(Y, nsamples) works; tf_method='erblet' is the
        # built-in shortcut to the perfect-reconstruction ERB front-end.
        # The GEM engine is front-end-agnostic (it sees an (F, N, 2)
        # complex plane); STFT-bin-specific features (freq_basis, WF0
        # atoms) guard on `self.tft.wlen` existing.
        if transform is not None:
            self.tft = transform
        elif tf_method == "erblet":
            from pyfasst_jax.tf.erblet import ERBLetTransform
            self.tft = ERBLetTransform(fs=self.fs)
        else:
            self.tft = STFT(wlen=wlen, hop=hop, fs=self.fs, method=tf_method)
        self.Xs = None       # (F, N, I) complex device array
        self.comp_transf_Cx()

        # spatial_hold_frac: fraction of iterations with the mixing frozen
        # while the spectra adapt (GEMConfig default 0.1). Raising it to
        # ~0.3 is the measured robustness lever for hard blind full-rank
        # inits (models/spatial_init.py): the consensus spatial estimate
        # must not be dragged off by statistics of still-random spectra.
        hold = {} if spatial_hold_frac is None else \
            {"spatial_hold_frac": float(spatial_hold_frac)}
        self.cfg = GEMConfig(niter=iter_num, annealing=annealing,
                             sigma_start_frac=sigma_start_frac,
                             sigma_end_frac=sigma_end_frac, **hold)
        self.params: Optional[FasstParams] = None
        self.logliks: Optional[np.ndarray] = None

    # -- transform ----------------------------------------------------------
    @property
    def F(self) -> int:
        return int(self.Xs.shape[0])

    @property
    def N(self) -> int:
        return int(self.Xs.shape[1])

    @property
    def nchannels(self) -> int:
        return self.audio.channels

    @property
    def stft_wlen(self) -> int:
        """Window length of the STFT front-end.

        Features that map LINEAR rfft bins -- ERB/Mel `freq_basis` factors
        (tf/filterbank.spectral_basis) and the WF0 comb dictionaries
        (variants.generate_WF0*) -- are meaningless on an already
        frequency-warped front-end (erblet/minqt); they guard through this
        property so the failure is a clear error at construction.
        """
        wlen = getattr(self.tft, "wlen", None)
        if wlen is None or getattr(self.tft, "name", "stft") != "stft":
            name = getattr(self.tft, "name", type(self.tft).__name__)
            raise ValueError(
                "freq_basis / F0-dictionary features map linear STFT bins "
                f"and require the STFT front-end; the '{name}' transform "
                "is already frequency-warped")
        return int(wlen)

    def comp_transf_Cx(self) -> None:
        """Analysis transform + packed empirical mixture covariance.

        Reference parity: FASST.comp_transf_Cx (UNVERIFIED). The spectra are
        normalized to unit mean power (scale restored at separation time):
        the GEM engine runs in float32 on the device, and O(1)-centered statistics
        keep every intermediate inside float32 range regardless of the input
        recording level.
        """
        data = self.audio.data.astype(self.np_dtype)
        if data.shape[1] < 1:
            raise ValueError("mixture has no channels")
        # I == 2 runs the packed-Hermitian fast path; any other channel
        # count dispatches to the general unrolled-Cholesky engine
        # (ops/engine_general.py) inside the same jitted GEM loop.
        X = self.tft.computeTransform(data)            # (F, N, I) complex64
        mean_pow = float(jnp.mean(jnp.abs(X) ** 2))
        self._scale = np.sqrt(max(mean_pow, 1e-30))
        self.Xs = X / self._scale

    @property
    def Cx(self) -> jnp.ndarray:
        """Packed (F, N, 4) empirical mixture covariance, computed on demand.

        The GEM engine consumes Xs directly; Cx is an inspection/parity
        convenience. It is a property (not stored) so long/streaming clips
        don't hold an extra F x N x 4 float plane for the model's lifetime.
        The packed encoding is stereo-only; for other channel counts use
        jnp.einsum("fni,fnk->fnik", Xs, Xs.conj()) directly.
        """
        if self.Xs.shape[-1] != 2:
            raise ValueError("packed Cx is defined for stereo input only")
        return observed_covariance(self.Xs)

    # -- estimation ----------------------------------------------------------
    def estim_param_a_posteriori(self, niter: Optional[int] = None,
                                 start_iter: int = 0,
                                 checkpoint_path: Optional[str] = None,
                                 checkpoint_every: Optional[int] = None
                                 ) -> np.ndarray:
        """Run the GEM loop (THE entry point; one compiled fori_loop).

        Returns the per-iteration log-likelihoods. start_iter > 0 resumes an
        interrupted run (see load_checkpoint): the annealing schedule is a
        pure function of the iteration index against the FULL niter, so the
        resumed trajectory is exactly the uninterrupted one (run with the
        same niter as the original).

        checkpoint_path + checkpoint_every=K persist the parameters every K
        iterations (same compiled executable across chunks: the loop bounds
        are traced). Non-finite log-likelihood in a chunk triggers the
        failure path (SURVEY §5): parameters roll back to the last
        checkpoint and a RuntimeError names the diverging iteration.
        """
        if self.params is None:
            raise RuntimeError("model parameters not initialized "
                               "(use a concrete FASST variant)")
        cfg = self.cfg if niter is None else \
            GEMConfig(**{**self.cfg.__dict__, "niter": int(niter)})
        every = int(checkpoint_every or 0)
        if every and not checkpoint_path:
            raise ValueError("checkpoint_every requires checkpoint_path")
        t0 = time.perf_counter()
        lls = np.zeros(cfg.niter, np.float64)
        s = int(start_iter)
        params = self.params
        while s < cfg.niter:
            e = min(s + every, cfg.niter) if every else cfg.niter
            new_params, logliks = run_gem(params, self.Xs, cfg,
                                          start_iter=s, end_iter=e)
            chunk = np.asarray(jax.block_until_ready(logliks))[s:e]
            if not np.all(np.isfinite(chunk)):
                bad = s + int(np.argmin(np.isfinite(chunk)))
                self.params = params        # last good (checkpointed) state
                raise RuntimeError(
                    f"GEM diverged (non-finite log-likelihood) at iteration "
                    f"{bad}; parameters rolled back to iteration {s}"
                    + (f" (checkpoint: {checkpoint_path})"
                       if checkpoint_path else ""))
            lls[s:e] = chunk
            params = new_params
            if checkpoint_path and (every or e == cfg.niter):
                self.params = params
                self.save_checkpoint(checkpoint_path, iteration=e)
            s = e
        self._gem_seconds = time.perf_counter() - t0
        self.params = params
        self.logliks = lls
        if self.verbose:
            print(f"GEM {cfg.niter} iters in {self._gem_seconds:.3f}s, "
                  f"final loglik {self.logliks[-1]:.6g}")
        return self.logliks

    # -- separation ----------------------------------------------------------
    def _final_sigma(self) -> jnp.ndarray:
        _, sigma1 = annealing_endpoints(self.Xs, self.cfg)
        return sigma1

    def estim_param_blind_reverb(self, reseed_rounds: int = 2,
                                 em_seeds: int = 2, verbose: bool = False,
                                 multiscale_wlen: Optional[int] = None,
                                 **kw) -> dict:
        """Blind reverberant estimation via the models/reverb.py pipeline.

        Replaces `estim_param_a_posteriori` for reverberant mixtures with
        unknown spatial structure: runs the full candidate pool (consensus
        spatial clustering + structural repairs) to convergence in batched
        device programs, selects by blind degeneracy statistics, applies
        `reseed_rounds` of EM-in-the-loop posterior reseeding, and installs
        the winning run's parameters on the model -- separation and
        checkpointing then behave as after a normal fit. The model's own
        spectral/spatial init is ignored. Any channel count: the clustering
        features are the I*I normalized covariance entries and the EM
        dispatches to the general engine for I != 2. Returns the pipeline
        info dict (winner name, blind statistics, stage history).

        multiscale_wlen: when set, runs the MULTISCALE ladder
        (models/reverb.py::blind_reverb_separate_multiscale): the full
        blind pipeline first executes on a finer STFT grid of this window
        length -- where envelope-based permutation alignment still carries
        signal on onset-locked material -- and its winning separation
        re-seeds the model's own (coarse) grid through time-domain
        dominance votes. Requires an STFT front-end on the model (the
        coarse stage runs on the model's grid so the installed parameters
        match `separated_images`).
        """
        from pyfasst_jax.models.reverb import (
            blind_reverb_separate, blind_reverb_separate_multiscale,
        )

        J = len(self.params.spat)
        rank = self.params.spat[0].A.shape[-1]
        nmf_comps = self.params.spec[0].FB.shape[1]
        if multiscale_wlen is not None:
            if not hasattr(self.tft, "wlen"):
                raise ValueError("multiscale_wlen requires an STFT "
                                 "front-end (the coarse stage runs on the "
                                 "model's own grid)")
            if multiscale_wlen >= self.tft.wlen:
                raise ValueError(
                    f"multiscale_wlen ({multiscale_wlen}) must be finer "
                    f"than the model's window ({self.tft.wlen})")
            _, info = blind_reverb_separate_multiscale(
                self.audio.data.astype(np.float32), J, fs=self.fs,
                wlen_fine=int(multiscale_wlen),
                transform_coarse=self.tft, iters=self.cfg.niter,
                em_seeds=em_seeds, reseed_rounds=reseed_rounds, rank=rank,
                nmf_comps=nmf_comps, verbose=verbose, **kw)
            info.pop("transform", None)
            self.params = info["params"]
            return info
        # Xs is already unit-mean-power; the pipeline re-normalizes by its
        # own RMS (== 1 here), so the returned parameters match Xs' scale
        _, info = blind_reverb_separate(
            np.asarray(self.Xs), J, iters=self.cfg.niter,
            em_seeds=em_seeds, reseed_rounds=reseed_rounds, rank=rank,
            nmf_comps=nmf_comps, verbose=verbose, **kw)
        self.params = info["params"]
        return info

    def estim_param_blind_mono(self, nmf_iters: int = 200,
                               n_seeds: int = 4, seed: int = 0):
        """Blind MONO estimation: mixture-NMF + envelope-clustering init
        (models/mono.py), then the normal GEM fit.

        Mono input has no spatial cues, so the spatial-clustering blind
        pipeline (estim_param_blind_reverb) has nothing to cluster on and
        a random spectral init is the whole quality gap (measured 3.2 dB
        random vs 11.5 from this init on the validation mono fixture —
        above the per-source oracle-FB ceiling; docs/design.md §6h).
        Returns the GEM log-likelihood trace.
        """
        from pyfasst_jax.models.mono import apply_mono_init, nmf_cluster_init

        if int(self.Xs.shape[-1]) != 1:
            raise ValueError("estim_param_blind_mono needs mono input; "
                             "use estim_param_blind_reverb for I >= 2")
        nmf_comps = int(self.params.spec[0].FB.shape[1])
        init = nmf_cluster_init(
            np.asarray(self.Xs), len(self.params.spec),
            nmf_comps, nmf_iters=nmf_iters, n_seeds=n_seeds, seed=seed)
        self.params = apply_mono_init(self.params, init)
        return self.estim_param_a_posteriori()

    def separated_images(self) -> np.ndarray:
        """Posterior-mean source images, time domain: (J, nsamples, I)."""
        Y = wiener.separate_sources(self.params, self.Xs, self._final_sigma())
        n = self.audio.nsamples
        ys = [np.asarray(self.tft.invertTransform(Y[j], nsamples=n))
              for j in range(Y.shape[0])]
        return np.stack(ys) * self._scale

    def separate_spat_comps(self, dir_results: Optional[str] = None,
                            suffix: str = "est") -> List[str]:
        """Wiener-separate every spatial component and write WAVs.

        Reference parity: FASST.separate_spat_comps (UNVERIFIED). Returns the
        written file paths (or in-memory arrays via `separated_images`).
        """
        ys = self.separated_images()
        return self._write_sources(ys, dir_results, suffix)

    def separate_spatial_filter_comp(self, dir_results: Optional[str] = None,
                                     suffix: str = "sf") -> List[str]:
        """Spatial-filter (PSD-independent) separation variant."""
        sigma = self._final_sigma()
        Y = wiener.separate_spatial_filter(self.params, self.Xs, sigma)
        n = self.audio.nsamples
        ys = np.stack([np.asarray(self.tft.invertTransform(Y[j], nsamples=n))
                       for j in range(Y.shape[0])]) * self._scale
        return self._write_sources(ys, dir_results, suffix)

    # -- checkpoint / resume ---------------------------------------------------
    def save_checkpoint(self, path: str, iteration: Optional[int] = None
                        ) -> str:
        """Persist the current parameters (utils.checkpoint .npz format)."""
        from pyfasst_jax.utils.checkpoint import save_params
        it = self.cfg.niter if iteration is None else int(iteration)
        return save_params(path, self.params, iteration=it)

    def load_checkpoint(self, path: str) -> int:
        """Restore parameters; returns the saved iteration index, to pass as
        estim_param_a_posteriori(start_iter=...) for an exact resume."""
        from pyfasst_jax.utils.checkpoint import load_params
        params, it, _ = load_params(path)
        self.params = params
        return it

    def retrieveSubsrcSignals(self) -> np.ndarray:
        """Alias kept for reference API parity: the separated source images."""
        return self.separated_images()

    def _write_sources(self, ys: np.ndarray, dir_results: Optional[str],
                       suffix: str) -> List[str]:
        if dir_results is None:
            return []
        os.makedirs(dir_results, exist_ok=True)
        stem = os.path.splitext(os.path.basename(
            self.audio.filename or "mixture"))[0]
        paths = []
        for j in range(ys.shape[0]):
            path = os.path.join(dir_results, f"{stem}_{suffix}_{j}.wav")
            peak = np.max(np.abs(ys[j]))
            data = ys[j] / peak if peak > 1.0 else ys[j]
            AudioObject(data=data, samplerate=self.fs)._write(path)
            paths.append(path)
        return paths
