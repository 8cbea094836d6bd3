"""Perfect-reconstruction ERBlet transform (uniform-hop, static shapes).

Reference parity: pyfasst vendors Grill's NSGT (pyfasst/tftransforms/nsgt/,
UNVERIFIED; mount empty) for an ERB-scale *invertible* transform. The NSGT
samples each band at its own rate (ragged shapes -- hostile to XLA). This
module keeps the NSGT's "painless" frame construction but samples EVERY band
at the SAME rate N = ceil(T / hop), chosen so the widest band still satisfies
the painless condition (support <= N DFT bins). The price is time-domain
oversampling of the narrow bands; the payoff is a dense (B, N) coefficient
array, batched FFTs, and an EXACT closed-form dual -- true perfect
reconstruction, not the band-limited projection of tf/filterbank.ERBTransform.

Measured cost of the uniform hop (vs the reference NSGT's per-band minimal
rates, i.e. sum of band support lengths): redundancy factor ~8x at 16 kHz
and ~10-12x at 44.1 kHz, approximately INDEPENDENT of n_bands -- halving
the per-band width doubles the band count but halves N, so total
coefficient count stays ~constant (e.g. 10 s at 44.1 kHz: 4.2M complex64
coefficients ~ 34 MB at n_bands in {48, 96}; analysis ~0.3 s, synthesis
~0.2 s on host CPU). The overhead is a flat constant factor, not a
function of resolution; it buys static shapes and batched device FFTs.
When the storage/bandwidth matters more than one rectangular plane,
`MultiRateERBLet` (below) recovers the NSGT's per-band rates to within
~2x using power-of-2 decimation groups (measured: 0.15-0.19x the uniform
coefficient count at auditory band counts) while every group stays a
static dense array.

Construction (finite, circular over the padded length Tp ~ N * hop; both
Tp and N are independently rounded up to FFT-friendly sizes — PR never
needs Tp = N * hop, only band support <= N):

    analysis:  C_b = fold_N( rfft(x) * W_b ),    c_b = ifft_N(C_b)
    synthesis: X^[k] = sum_b unfold_b( fft_N(c_b) )[k] * W_b[k] / S[k],
               S[k] = sum_b W_b[k]^2,            x = irfft(X^)

Each band's support is a contiguous run of <= N rfft bins, so fold_N (alias
the support into N bins) is INVERTIBLE per band: every output bin m receives
exactly one support bin k. Unfolding therefore recovers rfft(x)[k] * W_b[k]
exactly, and the diagonal division by S finishes exact PR for any signal with
S[k] > 0 everywhere (guaranteed by shelf-extended edge bands). No matrix
inverse, no pinv truncation; the dual is computed once on host in O(K).

Windows are Hann-profile bumps on ERB-spaced centers (Glasberg & Moore),
first/last extended flat to DC/Nyquist. All shapes are static per signal
length; geometry is cached per (Tp,).
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pyfasst_jax.tf.filterbank import erb_to_hz, hz_to_erb

# Full-signal FFT lengths are rounded up to f * 2^k with f in
# {1, 3, 5, 9, 15}: every such length is a product of radix-2/3/5 stages,
# the fast case of cuFFT and of XLA's CPU FFT alike, and the set of plan
# sizes stays small. The cost is at most 25% zero-padding.
_FFT_FRIENDLY_ODD = (1, 3, 5, 9, 15)


def _fft_friendly(n: int) -> int:
    """Smallest m >= n of the form f * 2^k with f in _FFT_FRIENDLY_ODD."""
    n = max(int(n), 1)
    best = None
    for f in _FFT_FRIENDLY_ODD:
        m = f
        while m < n:
            m *= 2
        if best is None or m < best:
            best = m
    return best


class ERBLetTransform:
    """Invertible ERB-scale transform: computeTransform / invertTransform.

    Parameters
    ----------
    fs : sample rate.
    n_bands : number of ERB-spaced bands covering [0, fs/2].
    hop : subband sample period in signal samples; None picks the largest
        hop that keeps the painless condition (widest band support <= N)
        with a safety factor of 2 for typical signal lengths.
    fmin : lowest band center (Hz); below it the first band is a shelf.
    scale : 'erb' (auditory spacing) or 'log' (geometric spacing = a
        perfect-reconstruction constant-Q transform).
    """

    name = "erblet"

    def __init__(self, fs: int = 44100, n_bands: int = 64,
                 hop: Optional[int] = None, fmin: float = 50.0,
                 scale: str = "erb"):
        self.fs = int(fs)
        self.n_bands = int(n_bands)
        self.fmin = float(fmin)
        self.scale = scale
        # Scaled band centers; spacing sets each Hann's half-width.
        # 'erb': Glasberg & Moore auditory spacing (the NSGT-ERBlet analog);
        # 'log': geometric spacing, i.e. a perfect-reconstruction
        # constant-Q transform (the NSGT-CQ analog -- reference vendors
        # both scales in pyfasst/tftransforms/nsgt/, UNVERIFIED).
        if scale == "erb":
            e_lo, e_hi = hz_to_erb(fmin), hz_to_erb(fs / 2)
            interior = erb_to_hz(np.linspace(e_lo, e_hi, n_bands - 1))
        elif scale == "log":
            interior = np.geomspace(fmin, fs / 2, n_bands - 1)
        else:
            raise ValueError(f"scale must be 'erb' or 'log', got {scale!r}")
        self.centers_hz = np.concatenate([[0.0], interior])
        self.centers_hz[-1] = fs / 2
        if hop is None:
            # widest band: last interior band, half-width = center gap
            max_bw_hz = 2.0 * (self.centers_hz[-1] - self.centers_hz[-2])
            hop = max(int(self.fs / (2.0 * max_bw_hz)), 1)
        self.hop = int(hop)
        self._cache: dict = {}
        self._nsamples: Optional[int] = None

    # -- geometry (host, cached per padded length) ---------------------------
    def _geometry(self, T: int):
        # Both FFT sizes are rounded up to FFT-friendly lengths
        # (_fft_friendly). The construction never needs Tp = N * hop:
        # perfect reconstruction only requires Tp >= T (zero-pad) and
        # every band support <= N (fold injectivity); the effective
        # subband period becomes Tp / N in [hop, 1.25 * hop).
        N = _fft_friendly(-(-T // self.hop))  # subband samples (frames)
        Tp = _fft_friendly(N * self.hop)
        key = (Tp, N)
        if key in self._cache:
            return self._cache[key]
        K = Tp // 2 + 1                        # rfft bins
        df = self.fs / Tp
        c = self.centers_hz
        B = self.n_bands
        # Hann bumps: band b spans (c[b-1], c[b+1]); edges become shelves
        lo_hz = np.concatenate([[0.0], c[:-1]])
        hi_hz = np.concatenate([c[1:], [self.fs / 2]])
        lo = np.floor(lo_hz / df).astype(np.int64)
        hi = np.minimum(np.ceil(hi_hz / df).astype(np.int64) + 1, K)
        Lmax = int((hi - lo).max())
        if Lmax > N:
            raise ValueError(
                f"hop={self.hop} too large for perfect reconstruction: "
                f"widest band needs {Lmax} bins > N={N} subband samples; "
                f"use hop <= {self.hop * N // Lmax}")
        j = np.arange(Lmax)
        idx = lo[:, None] + j[None, :]                     # (B, Lmax)
        valid = idx < hi[:, None]
        idx = np.minimum(idx, K - 1)
        freqs = idx * df
        W = np.zeros((B, Lmax))
        for b in range(B):
            f = freqs[b]
            up = (f - lo_hz[b]) / max(c[b] - lo_hz[b], 1e-9)
            down = (hi_hz[b] - f) / max(hi_hz[b] - c[b], 1e-9)
            if b == 0:
                up = np.ones_like(f)                        # DC shelf
            if b == B - 1:
                down = np.ones_like(f)                      # Nyquist shelf
            r = np.clip(np.minimum(up, down), 0.0, 1.0)
            W[b] = np.sin(0.5 * np.pi * r) ** 2             # Hann profile
        W *= valid
        # diagonal frame operator S[k] = sum_b W_b[k]^2 over the full grid
        S = np.zeros(K)
        np.add.at(S, idx.ravel(), (W ** 2).ravel())
        assert S.min() > 1e-6, "ERBlet coverage hole (frame not invertible)"
        Wd = W / S[np.minimum(idx, K - 1)]                  # dual windows
        geo = dict(
            N=N, Tp=Tp, K=K,
            idx=jnp.asarray(idx), m=jnp.asarray(idx % N),
            W=jnp.asarray(W, jnp.float32),
            Wd=jnp.asarray(Wd, jnp.float32),
            b_idx=jnp.asarray(np.broadcast_to(np.arange(B)[:, None],
                                              idx.shape)),
        )
        self._cache[key] = geo
        return geo

    # -- transform -----------------------------------------------------------
    def computeTransform(self, data) -> jnp.ndarray:
        """(T[, I]) real -> complex subband coefficients (B, N[, I])."""
        x = jnp.asarray(np.asarray(data, np.float32))
        T = int(x.shape[0])
        self._nsamples = T
        g = self._geometry(T)
        xp = jnp.pad(x, ((0, g["Tp"] - T),) + ((0, 0),) * (x.ndim - 1))
        X = jnp.fft.rfft(xp, axis=0)                       # (K[, I])
        vals = X[g["idx"]] * (g["W"][..., None] if x.ndim == 2
                              else g["W"])                 # (B, Lmax[, I])
        shape = (self.n_bands, g["N"]) + x.shape[1:]
        C = jnp.zeros(shape, vals.dtype).at[g["b_idx"], g["m"]].add(vals)
        return jnp.fft.ifft(C, axis=1)                     # (B, N[, I])

    def invertTransform(self, Cb, nsamples: Optional[int] = None
                        ) -> jnp.ndarray:
        """Exact dual synthesis: (B, N[, I]) -> (nsamples[, I]) real."""
        n = nsamples if nsamples is not None else self._nsamples
        if n is None:
            raise ValueError("call computeTransform first or pass nsamples")
        Cb = jnp.asarray(Cb)
        g = self._geometry(n)
        C = jnp.fft.fft(Cb, axis=1)                        # (B, N[, I])
        vals = C[g["b_idx"], g["m"]]                       # (B, Lmax[, I])
        vals = vals * (g["Wd"][..., None] if Cb.ndim == 3 else g["Wd"])
        Kshape = (g["K"],) + Cb.shape[2:]
        X = jnp.zeros(Kshape, vals.dtype).at[g["idx"]].add(vals)
        y = jnp.fft.irfft(X, n=g["Tp"], axis=0)
        return y[:n]

    forward = computeTransform
    inverse = invertTransform

    # -- conveniences --------------------------------------------------------
    def band_centers(self) -> np.ndarray:
        """Band center frequencies in Hz, (n_bands,)."""
        return self.centers_hz.copy()

    def frame_bounds(self, T: int) -> Tuple[float, float]:
        """(A, B) frame bounds of the analysis system for length T:
        A = min_k S[k] / hop-normalization, B = max_k. Ratio B/A near 1
        means a snug frame (well-conditioned even without the dual)."""
        g = self._geometry(T)
        W = np.asarray(g["W"])
        idx = np.asarray(g["idx"])
        S = np.zeros(g["K"])
        np.add.at(S, idx.ravel(), (W ** 2).ravel())
        return float(S.min()), float(S.max())


class MultiRateERBLet(ERBLetTransform):
    """Per-band-rate ERBlet: the reference NSGT's storage efficiency with
    static, XLA-friendly shapes.

    The uniform-hop ERBLetTransform samples every band at the WIDEST
    band's rate -- measured redundancy ~8-12x over the NSGT's per-band
    minimal rates (class docstring above). This variant recovers the
    NSGT's efficiency while keeping static shapes: bands are grouped into
    power-of-2 DECIMATION GROUPS (group g holds every band whose support
    fits N0 / 2**g aliasing bins, i.e. narrow bands are sampled at
    exponentially lower rates), and each group is one dense (B_g, N_g)
    coefficient array -- a handful of rectangular device FFTs instead of
    the NSGT's per-band ragged lists (hostile to XLA) or the uniform-hop
    version's one oversampled plane. Within-group rate waste is < 2x by
    construction (a band in group g needs more than N_g/2 bins), so total
    coefficients land within ~2x of the per-band minimum.

    The fold/unfold perfect-reconstruction argument is UNCHANGED: each
    band's support is a contiguous run of L_b <= N_g rfft bins, so
    aliasing it into N_g bins is injective per band, and the global
    diagonal dual W / S (S summed over ALL groups) finishes exact PR.

    computeTransform returns a LIST of (B_g, N_g[, I]) complex arrays
    (empty groups omitted); `group_bands` maps each array row back to its
    band index. invertTransform consumes that list. The rectangular model
    path stays on ERBLetTransform; this class is the analysis/synthesis
    (storage, streaming, coding) equivalent of the reference's vendored
    NSGT rates (pyfasst/tftransforms/nsgt/, UNVERIFIED -- mount empty).
    """

    name = "erblet_multirate"

    def __init__(self, *args, max_decimation: int = 64, **kw):
        super().__init__(*args, **kw)
        g = int(max_decimation)
        if g < 1 or (g & (g - 1)):
            raise ValueError("max_decimation must be a power of two")
        self.max_decimation = g

    def _geometry(self, T: int):
        N0 = -(-T // self.hop)
        Gmax = self.max_decimation
        while Gmax > 1 and N0 < 2 * Gmax:      # keep at least 2 rows/group
            Gmax //= 2
        # friendly multiple of every rate: _fft_friendly gives f * 2^k,
        # so N0 = f * 2^k * Gmax and every group size N0 / d (d <= Gmax,
        # power of two) stays FFT-friendly; Tp rounds independently
        # (PR never needs Tp = N0 * hop, see ERBLetTransform._geometry)
        N0 = _fft_friendly(-(-N0 // Gmax)) * Gmax
        Tp = _fft_friendly(N0 * self.hop)
        key = (Tp, N0)
        if key in self._cache:
            return self._cache[key]
        K = Tp // 2 + 1
        df = self.fs / Tp
        c = self.centers_hz
        B = self.n_bands
        lo_hz = np.concatenate([[0.0], c[:-1]])
        hi_hz = np.concatenate([c[1:], [self.fs / 2]])
        lo = np.floor(lo_hz / df).astype(np.int64)
        hi = np.minimum(np.ceil(hi_hz / df).astype(np.int64) + 1, K)
        L = hi - lo
        if int(L.max()) > N0:
            raise ValueError(
                f"hop={self.hop} too large for perfect reconstruction: "
                f"widest band needs {int(L.max())} bins > N={N0}")
        # per-band decimation: largest power of two d <= Gmax with
        # N0 / d >= L_b  (support still fits the aliasing modulus)
        dec = np.minimum(Gmax, 2 ** np.floor(np.log2(
            np.maximum(N0 / np.maximum(L, 1), 1.0))).astype(np.int64))
        # global dual normalization over ALL bands (grouping-independent)
        S = np.zeros(K)
        Wfull = []
        for b in range(B):
            f = (lo[b] + np.arange(L[b])) * df
            up = (f - lo_hz[b]) / max(c[b] - lo_hz[b], 1e-9)
            down = (hi_hz[b] - f) / max(hi_hz[b] - c[b], 1e-9)
            if b == 0:
                up = np.ones_like(f)
            if b == B - 1:
                down = np.ones_like(f)
            r = np.clip(np.minimum(up, down), 0.0, 1.0)
            w = np.sin(0.5 * np.pi * r) ** 2
            Wfull.append(w)
            S[lo[b]:hi[b]] += w ** 2
        assert S.min() > 1e-6, "ERBlet coverage hole (frame not invertible)"
        groups = []
        for d in sorted(set(int(x) for x in dec)):
            bands = np.nonzero(dec == d)[0]
            Ng = N0 // d
            Lg = int(L[bands].max())
            j = np.arange(Lg)
            idx = lo[bands][:, None] + j[None, :]
            valid = idx < hi[bands][:, None]
            idx = np.minimum(idx, K - 1)
            Wg = np.zeros((len(bands), Lg))
            Wdg = np.zeros((len(bands), Lg))
            for r_, b in enumerate(bands):
                Wg[r_, :L[b]] = Wfull[b]
                Wdg[r_, :L[b]] = Wfull[b] / S[lo[b]:hi[b]]
            Wg *= valid
            Wdg *= valid
            groups.append(dict(
                d=d, N=Ng, bands=jnp.asarray(bands),
                bands_np=bands,
                idx=jnp.asarray(idx), m=jnp.asarray(idx % Ng),
                W=jnp.asarray(Wg, jnp.float32),
                Wd=jnp.asarray(Wdg, jnp.float32),
                r_idx=jnp.asarray(np.broadcast_to(
                    np.arange(len(bands))[:, None], idx.shape)),
            ))
        geo = dict(N0=N0, Tp=Tp, K=K, groups=groups)
        self._cache[key] = geo
        return geo

    @property
    def group_bands(self):
        """List of band-index arrays, one per coefficient array (after a
        computeTransform; geometry of the last length)."""
        geo = self._cache[max(self._cache)] if self._cache else None
        if geo is None:
            raise ValueError("call computeTransform first")
        return [g["bands_np"] for g in geo["groups"]]

    def computeTransform(self, data):
        """(T[, I]) real -> [ (B_g, N_g[, I]) complex ] per rate group."""
        x = jnp.asarray(np.asarray(data, np.float32))
        T = int(x.shape[0])
        self._nsamples = T
        geo = self._geometry(T)
        xp = jnp.pad(x, ((0, geo["Tp"] - T),) + ((0, 0),) * (x.ndim - 1))
        X = jnp.fft.rfft(xp, axis=0)
        out = []
        for g in geo["groups"]:
            vals = X[g["idx"]] * (g["W"][..., None] if x.ndim == 2
                                  else g["W"])
            shape = (len(g["bands_np"]), g["N"]) + x.shape[1:]
            C = jnp.zeros(shape, vals.dtype).at[g["r_idx"], g["m"]].add(vals)
            out.append(jnp.fft.ifft(C, axis=1) / g["d"])
        return out

    def invertTransform(self, Cs, nsamples: Optional[int] = None):
        """Exact dual synthesis from the rate-group list."""
        n = nsamples if nsamples is not None else self._nsamples
        if n is None:
            raise ValueError("call computeTransform first or pass nsamples")
        geo = self._geometry(n)
        X = None
        for g, Cb in zip(geo["groups"], Cs):
            Cb = jnp.asarray(Cb)
            C = jnp.fft.fft(Cb * g["d"], axis=1)
            vals = C[g["r_idx"], g["m"]]
            vals = vals * (g["Wd"][..., None] if Cb.ndim == 3 else g["Wd"])
            Kshape = (geo["K"],) + Cb.shape[2:]
            acc = jnp.zeros(Kshape, vals.dtype).at[g["idx"]].add(vals)
            X = acc if X is None else X + acc
        y = jnp.fft.irfft(X, n=geo["Tp"], axis=0)
        return y[:n]

    forward = computeTransform
    inverse = invertTransform

    def redundancy(self, T: int) -> float:
        """Total coefficients / uniform-hop coefficients for length T
        (< 1 = saving; the uniform version is B * N0)."""
        geo = self._geometry(T)
        total = sum(len(g["bands_np"]) * g["N"] for g in geo["groups"])
        return total / float(self.n_bands * geo["N0"])
