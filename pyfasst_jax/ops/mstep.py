"""GEM M-step: spatial mixing updates and IS-NMF spectral updates.

Reference parity: pyfasst/audioModel.py::update_spat_comps /
update_spec_comps (UNVERIFIED; mount empty, see SURVEY.md §3.2 and §A):

  - spatial: the exact M-step is a JOINT least-squares over the stacked
    sub-sources of all sources (x = sum_j A_j s_j + b). We solve it by
    Gauss-Seidel block-coordinate ascent, one source at a time:

        A_j <- (R^_xs,j - sum_{j'!=j} A_j' R^_ss[j',j]) @ R^_ss[j,j]^-1

    which is exact coordinate ascent on the same quadratic Q-function (the
    statistics are fixed posterior moments), is monotone in the likelihood,
    and uniformly handles mixed inst/conv/fixed components. 'inst' components
    pool the solve over frequency with 1/sigma(f) weights (the exact weighting
    when the annealed noise PSD varies across frequency); 'conv' components
    (full-rank = conv with R == I) solve per frequency. The reference solves
    the joint system in one shot (UNVERIFIED) -- same fixed point.

  - spectral free factors: IS-NMF multiplicative updates against the
    posterior PSD xi_j with the current model PSD V_j, factors updated
    sequentially with V_j refreshed after each update (monotone in the IS
    divergence for fixed xi).

The blocks come pre-assembled in sub-source coordinates from the E-step
(estep.SuffStats: Txs, Tss, T4, T7); the per-f solves touch only (F, R, R)
arrays -- negligible next to the E-step.
"""
from __future__ import annotations

from typing import List, Tuple

import jax.numpy as jnp

from pyfasst_jax.models.components import (
    INST, NMF, FasstParams, SpatialComp, SpectralComp,
)
from pyfasst_jax.ops import herm
from pyfasst_jax.ops.estep import SuffStats


# -- spatial ------------------------------------------------------------------

def _as_conv_A(comp: SpatialComp, F: int) -> jnp.ndarray:
    """A as complex (F, I, R) regardless of mixing type (see
    SpatialComp.conv_mixing; kept as a function for the ops-layer callers)."""
    return comp.conv_mixing(F)


def update_spatial(params: FasstParams, stats: SuffStats,
                   sigma: jnp.ndarray, eps: float = 1e-12,
                   enabled=None) -> FasstParams:
    """One spatial M-step: Gauss-Seidel sweep over free spatial components.

    The posterior moments are FIXED E-step statistics already expressed in
    sub-source coordinates (estep.py):

        R^_ss[j,j] = Tss_jj + T4_j,   R^_ss[k,j] = Tss_kj - T7_kj,
        A_j <- (Txs_j - sum_{k != j} A_k R^_ss[k,j]) @ R^_ss[j,j]^-1

    with only the left-multiplying A_k at current Gauss-Seidel iterates --
    exact block-coordinate ascent on the Q-function.

    sigma is the current annealed noise PSD (F,), used as the exact 1/sigma
    frequency weighting for pooled 'inst' solves (weights normalized to unit
    mean -- the solution is weight-scale invariant and raw 1/sigma overflows
    float32). `enabled` (traced bool or None) gates the update: when False
    the old mixing is kept (used for the spatial hold-off phase).
    """
    F = stats.Txs[0].shape[0]
    J = len(params.spat)
    A_all = [_as_conv_A(c, F) for c in params.spat]   # complex (F, I, Rj)
    new_spat: List[SpatialComp] = list(params.spat)
    w = 1.0 / jnp.maximum(sigma, 1e-30)
    w = w / jnp.mean(w)

    for j, comp in enumerate(params.spat):
        if not comp.free:
            continue
        R = comp.rank
        target = stats.Txs[j]                          # (F, 2, R)
        for k in range(J):
            if k == j:
                continue
            block = stats.Tss[k][j] - stats.T7[k][j]   # R^_ss[k, j] (F,Rk,R)
            target = target - jnp.einsum("fik,fkr->fir", A_all[k], block)
        if R >= 2:
            # 2x2 engine packs T4 as Hermitian (F, 4); the general-I engine
            # (ops/engine_general.py) emits complex (F, R, R) directly.
            T4j = stats.T4[j]
            post = T4j if T4j.ndim == 3 else herm.herm_to_complex(T4j)
        else:
            post = stats.T4[j][:, None, None].astype(target.dtype)
        Rss = stats.Tss[j][j] + post                    # (F, R, R)
        if comp.mix_type == INST:
            wf = w[:, None, None]
            target_p = jnp.real(jnp.sum(wf * target, axis=0))
            Rss_p = jnp.real(jnp.sum(wf * Rss, axis=0))
            Rss_p = Rss_p + eps * jnp.trace(Rss_p) * jnp.eye(R, dtype=Rss_p.dtype)
            A_new = jnp.linalg.solve(Rss_p.T, target_p.T).T
        else:  # conv / full-rank: per-frequency solve
            # Proximal ridge toward the current mixing: frequencies where
            # this source has (near-)zero posterior energy otherwise get
            # A = tiny/tiny garbage that compounds into unbounded growth
            # (the global renormalization cannot fix per-frequency scale
            # runaway). MAP-regularizing toward A_old leaves data-rich bins
            # untouched (ridge << Rss there) and freezes starved bins.
            A = A_all[j]
            tr = jnp.einsum("frr->f", Rss).real
            ridge = (eps * tr + 1e-4 * jnp.mean(tr) + 1e-30).astype(tr.dtype)
            target = target + ridge[:, None, None] * A
            Rss = Rss + ridge[:, None, None] * jnp.eye(R, dtype=A.dtype)
            A_new = jnp.linalg.solve(jnp.swapaxes(Rss, 1, 2),
                                     jnp.swapaxes(target, 1, 2))
            A_new = jnp.swapaxes(A_new, 1, 2)
            # Per-frequency norm floor against the renormalization
            # ratchet: starved bins sit at the ridge-frozen A_old, which
            # the global conv renormalization divides by sqrt(norm) every
            # iteration -- data-rich bins regrow from the solve, frozen
            # bins decay GEOMETRICALLY to 0 (observed: |A| ~ 1e-27 after
            # ~120 iters on a band-disjoint mixture), and the spectral
            # chain seesaws to ~1e8 to compensate until float32 overflow.
            # Flooring each bin's Frobenius norm at 1e-3 of the source's
            # rms ties starved bins to the source's global scale; the
            # affected bins carry ~1e-6 of the spatial power, so in-band
            # estimates are untouched. (Mirrored in the oracle.)
            r2 = jnp.sum(jnp.abs(A_new) ** 2, axis=(1, 2))       # (F,)
            floor2 = 1e-6 * jnp.mean(r2)
            boost = jnp.sqrt(floor2 / jnp.maximum(r2, 1e-38))
            boost = jnp.maximum(boost, 1.0).astype(A_new.real.dtype)
            A_new = A_new * boost[:, None, None]
        A_new = A_new.astype(comp.A.dtype)
        if enabled is not None:
            A_new = jnp.where(enabled, A_new, comp.A)
        new_spat[j] = comp.replace(A=A_new)
        A_all[j] = _as_conv_A(new_spat[j], F)         # Gauss-Seidel refresh
    return params.replace(spat=tuple(new_spat))


# -- spectral -----------------------------------------------------------------

# Float32 guards shared by every multiplicative update (mirrored in the
# oracle): ratio clamp against dead-component 0/0 swings, eps factor floor.
UPD_MIN, UPD_MAX = 1e-5, 1e5


def _mul_upd(factor, num_term, den_term, eps):
    upd = jnp.clip(num_term / jnp.maximum(den_term, eps), UPD_MIN, UPD_MAX)
    return jnp.maximum(factor * upd, eps)


def _nmf_factor_updates(comp: SpectralComp, P: jnp.ndarray, V: jnp.ndarray,
                        eps: float) -> Tuple[SpectralComp, jnp.ndarray]:
    """Sequential multiplicative updates of this component's free factors.

    P is the (fixed) posterior PSD xi_j; V the current *total* source model
    PSD (all components of the same spatial comp summed). Returns the updated
    component and the refreshed V.

    Float32 safeguards (all mirrored in the oracle):
      - V is floored RELATIVE to the observed scale: V**-2 at an absolute
        eps floor overflows float32 whenever factor products underflow.
      - the multiplicative ratio is clamped to [UPD_MIN, UPD_MAX] per
        iteration: dead components (factor products underflowing to exact 0)
        otherwise produce 0/0 ratios that swing the model PSD by 1e10 per
        step and collapse the run.
    """
    def mul_upd(factor, num_term, den_term):
        return _mul_upd(factor, num_term, den_term, eps)

    vk = comp.power()
    v_floor = 1e-12 * jnp.mean(P) + eps
    for idx in range(4):
        if not comp.free[idx]:
            continue
        Vc = jnp.maximum(V, v_floor)
        num = P / (Vc * Vc)              # (F, N)
        den = 1.0 / Vc                   # (F, N)
        W = comp.freq_pattern()          # (F, K)
        H = comp.time_activation()       # (K, N)
        if idx == 0:                     # FB (F, L)
            rest = H if comp.FW is None else comp.FW @ H          # (L, N)
            comp = comp.replace(FB=mul_upd(comp.FB, num @ rest.T,
                                           den @ rest.T))
        elif idx == 1:                   # FW (L, K)
            lhs_n = comp.FB.T @ num                                # (L, N)
            lhs_d = comp.FB.T @ den
            comp = comp.replace(FW=mul_upd(comp.FW, lhs_n @ H.T,
                                           lhs_d @ H.T))
        elif idx == 2:                   # TW (K, M)
            lhs_n = W.T @ num                                      # (K, N)
            lhs_d = W.T @ den
            if comp.TB is not None:
                lhs_n, lhs_d = lhs_n @ comp.TB.T, lhs_d @ comp.TB.T
            comp = comp.replace(TW=mul_upd(comp.TW, lhs_n, lhs_d))
        else:                            # TB (M, N)
            G = W @ comp.TW                                        # (F, M)
            comp = comp.replace(TB=mul_upd(comp.TB, G.T @ num, G.T @ den))
        vk_new = comp.power()
        V = V - vk + vk_new
        vk = vk_new
    return comp, V


def _simm_factor_updates(comp: SpectralComp, P: jnp.ndarray, V: jnp.ndarray,
                         eps: float) -> Tuple[SpectralComp, jnp.ndarray]:
    """Multiplicative source-filter component: v = chain1 * (FB2 @ TW2).

    IS-NMF multiplicative updates where each chain's gradient is weighted by
    the OTHER chain's envelope (cf. Durrieu's SIMM; models/lead.py uses the
    same rules standalone).
    """
    def mul_upd(factor, num_term, den_term):
        return _mul_upd(factor, num_term, den_term, eps)

    vk = comp.power()
    v_floor = 1e-12 * jnp.mean(P) + eps
    # chain1 factors (standard rules on the envelope-weighted residual)
    for idx in range(4):
        if not comp.free[idx]:
            continue
        Vc = jnp.maximum(V, v_floor)
        E2 = comp.FB2 @ comp.TW2
        num = (P / (Vc * Vc)) * E2
        den = (1.0 / Vc) * E2
        W = comp.freq_pattern()
        H = comp.time_activation()
        if idx == 0:
            rest = H if comp.FW is None else comp.FW @ H
            comp = comp.replace(FB=mul_upd(comp.FB, num @ rest.T,
                                           den @ rest.T))
        elif idx == 1:
            comp = comp.replace(FW=mul_upd(comp.FW, (comp.FB.T @ num) @ H.T,
                                           (comp.FB.T @ den) @ H.T))
        elif idx == 2:
            lhs_n, lhs_d = W.T @ num, W.T @ den
            if comp.TB is not None:
                lhs_n, lhs_d = lhs_n @ comp.TB.T, lhs_d @ comp.TB.T
            comp = comp.replace(TW=mul_upd(comp.TW, lhs_n, lhs_d))
        else:
            G = W @ comp.TW
            comp = comp.replace(TB=mul_upd(comp.TB, G.T @ num, G.T @ den))
        vk_new = comp.power()
        V = V - vk + vk_new
        vk = vk_new
    # chain2 factors (weighted by chain1's product)
    for idx2 in range(2):
        if not comp.free2[idx2]:
            continue
        Vc = jnp.maximum(V, v_floor)
        C1 = comp.freq_pattern() @ comp.time_activation()
        num = (P / (Vc * Vc)) * C1
        den = (1.0 / Vc) * C1
        if idx2 == 0:
            comp = comp.replace(FB2=mul_upd(comp.FB2, num @ comp.TW2.T,
                                            den @ comp.TW2.T))
        else:
            comp = comp.replace(TW2=mul_upd(comp.TW2, comp.FB2.T @ num,
                                            comp.FB2.T @ den))
        vk_new = comp.power()
        V = V - vk + vk_new
        vk = vk_new
    return comp, V


def update_spectral(params: FasstParams, stats: SuffStats,
                    eps: float = 1e-30, v=None) -> FasstParams:
    """One spectral M-step: every free factor of every component.

    v (J, F, N), if given, is the source-power stack already computed by the
    E-step -- reused as the initial model PSD per source instead of
    recomputing the factor products (saves J matmuls + (F, N) arrays/iter).

    These are chains of ratios over (F, N) planes with K-narrow (K ~ 8)
    factor products; XLA fuses them (docs/design.md §4).
    """
    from pyfasst_jax.ops import hmm as hmm_ops

    spec = list(params.spec)
    for j in range(params.n_spat):
        idxs = [i for i, k in enumerate(spec) if k.spat_ind == j]
        if not idxs:
            continue
        P = stats.xi[j]
        if v is not None:
            V = v[j]
        else:
            V = spec[idxs[0]].power()
            for i in idxs[1:]:
                V = V + spec[i].power()
        for i in idxs:
            comp = spec[i]
            if comp.FB2 is not None:   # multiplicative source-filter (SIMM)
                comp, V = _simm_factor_updates(comp, P, V, eps)
            elif comp.constraint == NMF:
                comp, V = _nmf_factor_updates(comp, P, V, eps)
            else:
                # GMM / HMM: the discrete-state E-step replaces the TW
                # update, but free FB/FW (the state spectral templates)
                # still learn by their NMF rules.
                if comp.free[0] or comp.free[1]:
                    nmf_free = (comp.free[0], comp.free[1], False, False)
                    comp, V = _nmf_factor_updates(
                        comp.replace(free=nmf_free), P, V, eps)
                    comp = comp.replace(free=spec[i].free)
                comp, V = hmm_ops.state_factor_update(comp, P, V, eps)
            spec[i] = comp
    return params.replace(spec=tuple(spec))


# -- renormalization ------------------------------------------------------------

def renormalize(params: FasstParams) -> FasstParams:
    """Rebalance scales to stop drift over hundreds of iterations.

    (a) spatial: scale each free A_j to unit mean spatial power and push the
        power into the first free factor of each attached spectral component;
    (b) spectral chains: L1-normalize each free factor whose right neighbour
        in the FB->FW->TW->TB chain is also free, pushing the scale right.
    Mirrors the reference's per-iteration renormalization (UNVERIFIED).
    """
    spat = list(params.spat)
    spec = list(params.spec)

    for j, comp in enumerate(spat):
        if not comp.free:
            continue
        if comp.mix_type == INST:
            norm = jnp.sum(comp.A ** 2) / comp.A.shape[0]
        else:
            norm = jnp.mean(jnp.sum(jnp.abs(comp.A) ** 2, axis=(1, 2))
                            ) / comp.A.shape[1]
        norm = jnp.maximum(norm, 1e-30)
        spat[j] = comp.replace(A=comp.A / jnp.sqrt(norm).astype(comp.A.dtype))
        for i, k in enumerate(spec):
            if k.spat_ind != j:
                continue
            spec[i] = _scale_first_free(k, norm)

    for i, k in enumerate(spec):
        spec[i] = _chain_normalize(k)
    return params.replace(spat=tuple(spat), spec=tuple(spec))


def _scale_first_free(comp: SpectralComp, s) -> SpectralComp:
    names = ("FB", "FW", "TW", "TB")
    for idx, name in enumerate(names):
        if comp.free[idx] and getattr(comp, name) is not None:
            return comp.replace(**{name: getattr(comp, name) * s})
    if comp.FB2 is not None:           # SIMM: fall back to the second chain
        for idx2, name in enumerate(("FB2", "TW2")):
            if comp.free2[idx2]:
                return comp.replace(**{name: getattr(comp, name) * s})
    return comp


def _chain_normalize(comp: SpectralComp, eps: float = 1e-30) -> SpectralComp:
    """Push column scales rightward between adjacent free factors."""
    chain = [(i, n) for i, n in enumerate(("FB", "FW", "TW", "TB"))
             if getattr(comp, n) is not None]
    upd = {}
    mats = {n: getattr(comp, n) for _, n in chain}
    for (ia, na), (ib, nb) in zip(chain[:-1], chain[1:]):
        if not (comp.free[ia] and comp.free[ib]):
            continue
        s = jnp.maximum(jnp.sum(mats[na], axis=0), eps)       # col sums
        mats[na] = mats[na] / s[None, :]
        mats[nb] = mats[nb] * s[:, None]
        upd[na], upd[nb] = mats[na], mats[nb]
    return comp.replace(**upd) if upd else comp
