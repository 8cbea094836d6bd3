"""Float64 NumPy oracle for the FASST GEM engine (the parity target).

Implements SURVEY.md §A directly with complex 2x2 matrices and explicit
per-source loops -- no packed representations, no JAX. Intentionally the
*dumbest correct* implementation: per-(f,n) math is written with full
(F, N, 2, 2) complex arrays and np.linalg where convenient. Numerical knobs
(eps, det floor, annealing schedule, update order, renormalization) mirror
pyfasst_jax exactly so that x64 runs agree to near machine precision.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

EPS = 1e-30
DET_FLOOR = 1e-30
SPATIAL_REG = 1e-12


@dataclasses.dataclass
class OracleSpatial:
    A: np.ndarray            # inst: (I, R) real; conv: (F, I, R) complex
    mix_type: str = "inst"
    free: bool = True

    @property
    def rank(self):
        return self.A.shape[-1]

    def cov(self, F: int) -> np.ndarray:
        """R_j(f) = A A^H, complex (F, I, I)."""
        if self.mix_type == "inst":
            A = self.A.astype(np.complex128)
            R = A @ A.conj().T
            I = A.shape[0]
            return np.broadcast_to(R, (F, I, I)).copy()
        return np.einsum("fir,fkr->fik", self.A, self.A.conj())


@dataclasses.dataclass
class OracleSpectral:
    FB: np.ndarray
    TW: np.ndarray
    FW: Optional[np.ndarray] = None
    TB: Optional[np.ndarray] = None
    spat_ind: int = 0
    free: Tuple[bool, bool, bool, bool] = (True, False, True, False)
    constraint: str = "NMF"
    trans: Optional[np.ndarray] = None
    # multiplicative source-filter chain (SIMM): v = chain1 * (FB2 @ TW2)
    FB2: Optional[np.ndarray] = None
    TW2: Optional[np.ndarray] = None
    free2: Tuple[bool, bool] = (False, False)

    def W(self):
        return self.FB if self.FW is None else self.FB @ self.FW

    def H(self):
        return self.TW if self.TB is None else self.TW @ self.TB

    def power(self):
        p = self.W() @ self.H()
        if self.FB2 is not None:
            p = p * (self.FB2 @ self.TW2)
        return p


@dataclasses.dataclass
class OracleParams:
    spat: List[OracleSpatial]
    spec: List[OracleSpectral]

    def source_power(self, j):
        return sum(k.power() for k in self.spec if k.spat_ind == j)


def params_from_pytree(params) -> OracleParams:
    """Convert a pyfasst_jax FasstParams pytree to float64 oracle params."""
    spat = [OracleSpatial(A=np.asarray(c.A, dtype=(
        np.complex128 if np.iscomplexobj(np.asarray(c.A)) else np.float64)),
        mix_type=c.mix_type, free=c.free) for c in params.spat]
    spec = []
    for k in params.spec:
        spec.append(OracleSpectral(
            FB=np.asarray(k.FB, np.float64),
            TW=np.asarray(k.TW, np.float64),
            FW=None if k.FW is None else np.asarray(k.FW, np.float64),
            TB=None if k.TB is None else np.asarray(k.TB, np.float64),
            spat_ind=k.spat_ind, free=tuple(k.free), constraint=k.constraint,
            trans=None if k.trans is None else np.asarray(k.trans, np.float64),
            FB2=None if k.FB2 is None else np.asarray(k.FB2, np.float64),
            TW2=None if k.TW2 is None else np.asarray(k.TW2, np.float64),
            free2=tuple(k.free2)))
    return OracleParams(spat=spat, spec=spec)


# -- observation ----------------------------------------------------------------

def observed_covariance(X: np.ndarray) -> np.ndarray:
    """Rxx(f,n) = x x^H, complex (F, N, 2, 2) from the STFT (F, N, 2)."""
    return np.einsum("fni,fnk->fnik", X, X.conj())


def annealing_endpoints(X, sigma_start_frac, sigma_end_frac,
                        power_floor_frac=1e-4):
    """X: complex mixture STFT (F, N, 2)."""
    Pm = np.mean(np.abs(X) ** 2, axis=(1, 2))
    floor = max(power_floor_frac * np.mean(Pm), EPS)
    Pm = np.maximum(Pm, floor)
    return sigma_start_frac * Pm, sigma_end_frac * Pm


def noise_psd(it, niter, sigma0, sigma1, mode):
    if mode == "no_ann":
        return sigma1
    w = 1.0 - it / max(niter - 1, 1)
    return w * sigma0 + (1.0 - w) * sigma1


# -- E-step ---------------------------------------------------------------------

def _cross_terms(R, params, F):
    """trR (J,F) and X (J,J,F) via Lagrange's identity over mixing columns
    (mirrors pyfasst_jax.ops.estep.cross_terms)."""
    J = len(params.spat)
    trR = np.stack([np.einsum("fii->f", R[j]).real for j in range(J)])

    def as_conv(comp):
        A = comp.A
        if comp.mix_type == "inst":
            A = np.broadcast_to(A.astype(np.complex128)[None], (F,) + A.shape)
        return A

    A_all = [as_conv(c) for c in params.spat]
    X = np.empty((J, J, F))
    for j in range(J):
        a = A_all[j]
        for k in range(J):
            b = A_all[k]
            c = (a[:, 0, :, None] * b[:, 1, None, :]
                 - a[:, 1, :, None] * b[:, 0, None, :])
            X[j, k] = np.sum(np.abs(c) ** 2, axis=(1, 2))
    return trR, X


def _stable_det(v, trR, X, sigma):
    """det Sigma_x as nonnegative monomials (mirrors ops/estep.py)."""
    s = sigma[:, None]
    lin = np.einsum("jfn,jf->fn", v, trR)
    quad = 0.5 * np.einsum("jfn,kfn,jkf->fn", v, v, X)
    return s * s + s * lin + quad


def _stable_inv(S, det):
    out = np.empty_like(S)
    out[..., 0, 0] = S[..., 1, 1].real / det
    out[..., 1, 1] = S[..., 0, 0].real / det
    out[..., 0, 1] = -S[..., 0, 1] / det
    out[..., 1, 0] = -S[..., 1, 0] / det
    return out


def estep(X, params: OracleParams, sigma, noise_inject=False):
    """X: complex (F, N, 2) mixture STFT. Returns (xi, Txs, Tss, T4, T7,
    loglik); mirrors ops/estep.py's sub-source-coordinate statistics."""
    F, N = X.shape[:2]
    J = len(params.spat)
    v = np.stack([np.asarray(params.source_power(j)) for j in range(J)])
    R = np.stack([params.spat[j].cov(F) for j in range(J)])   # (J,F,2,2)

    Sx = np.einsum("jfn,jfik->fnik", v, R)
    Sx = Sx + sigma[:, None, None, None] * np.eye(2)[None, None]
    trR, Xc = _cross_terms(R, params, F)
    det = _stable_det(v, trR, Xc, sigma)
    Sxi = _stable_inv(Sx, det)
    y = np.einsum("fnab,fnb->fna", Sxi, X)                    # Sigma_x^-1 x
    trSxiRxx = np.maximum(np.einsum("fna,fna->fn", X.conj(), y).real, 0.0)
    if noise_inject:
        trSxiRxx = trSxiRxx + sigma[:, None] * np.einsum(
            "fnaa->fn", Sxi).real

    xi = np.empty((J, F, N))
    eye = np.eye(2)[None, None]
    A_all, wvecs = [], []
    for j in range(J):
        Aj = params.spat[j].A
        if params.spat[j].mix_type == "inst":
            Aj = np.broadcast_to(Aj.astype(np.complex128)[None],
                                 (F,) + Aj.shape)
        A_all.append(Aj)
        wvecs.append(np.einsum("fir,fni->fnr", Aj.conj(), y))  # w_j = A^H y
    if noise_inject:
        zvecs = [np.einsum("fnab,fbr->fnar", Sxi, A_all[j])    # (F,N,2,Rj)
                 for j in range(J)]

    T4, Txs = [], []
    for j in range(J):
        rank = params.spat[j].rank
        wj = wvecs[j]
        trCR = np.sum(np.abs(wj) ** 2, axis=-1)
        if noise_inject:
            trCR = trCR + sigma[:, None] * np.sum(np.abs(zvecs[j]) ** 2,
                                                  axis=(2, 3))
        # Sherman-Morrison subtract-free posterior terms (mirrors
        # pyfasst_jax.ops.estep: S_j assembled as the sum over k != j).
        if J == 1:
            Sj = sigma[:, None, None, None] * eye * np.ones((F, N, 1, 1))
        else:
            Sj = sum(np.einsum("fn,fab->fnab", v[k], R[k])
                     for k in range(J) if k != j)
            Sj = Sj + sigma[:, None, None, None] * eye
        vmask = v.copy(); vmask[j] = 0.0
        Sji = _stable_inv(Sj, _stable_det(vmask, trR, Xc, sigma))
        t = np.einsum("fnab,fba->fn", Sji, R[j]).real
        vt = v[j] * t
        if rank >= 2:
            Aj = A_all[j]
            Ah = np.swapaxes(Aj.conj(), 1, 2)
            M = np.einsum("fra,fnab,fbs->fnrs", Ah, Sji, Aj)
            G = np.eye(rank)[None, None] + v[j][..., None, None] * M
            dG = np.maximum((G[..., 0, 0] * G[..., 1, 1]
                             - np.abs(G[..., 0, 1]) ** 2).real, 1.0)
            Ginv = np.empty_like(G)
            Ginv[..., 0, 0] = G[..., 1, 1] / dG
            Ginv[..., 1, 1] = G[..., 0, 0] / dG
            Ginv[..., 0, 1] = -G[..., 0, 1] / dG
            Ginv[..., 1, 0] = -G[..., 1, 0] / dG
            T4.append(np.einsum("fn,fnrs->frs", v[j], Ginv))
            coef = np.maximum((2.0 + vt) / dG, 0.0)
        else:
            den = 1.0 + vt
            coef = np.maximum((2.0 + vt) / den - 1.0, 0.0)
            T4.append((v[j] / den).sum(axis=-1))
        xi[j] = np.maximum((v[j] ** 2 * trCR + v[j] * coef) / rank, EPS)
        txs = np.einsum("fn,fni,fnr->fir", v[j], X, wj.conj())
        if noise_inject:
            txs = txs + sigma[:, None, None] * np.einsum(
                "fn,fnir->fir", v[j], zvecs[j])
        Txs.append(txs)

    Tss = [[None] * J for _ in range(J)]
    T7 = [[None] * J for _ in range(J)]
    for j in range(J):
        for k in range(J):
            vv = v[j] * v[k]
            Tss[j][k] = np.einsum("fn,fnr,fns->frs", vv, wvecs[j],
                                  wvecs[k].conj())
            if noise_inject:
                Tss[j][k] = Tss[j][k] + np.einsum(
                    "f,fn,fnir,fnis->frs", sigma, vv,
                    zvecs[j].conj(), zvecs[k])
            if k != j:
                Mjk = np.einsum("fir,fnis->fnrs", A_all[j].conj(),
                                np.einsum("fnab,fbs->fnas", Sxi, A_all[k]))
                T7[j][k] = np.einsum("fn,fnrs->frs", vv, Mjk)

    loglik = -np.sum(np.log(det) + trSxiRxx)
    return xi, Txs, Tss, T4, T7, loglik


def estep_general(X, params: OracleParams, sigma, noise_inject=False):
    """General-I E-step (mirrors pyfasst_jax.ops.engine_general).

    X: complex (F, N, I) for any channel count I. Float64 with PD Sigma_x,
    so plain np.linalg inverses stand in for the engine's unrolled Cholesky
    (their clamps -- diag floor, rank-1 den >= 1 -- are mirrored where they
    can bind). Returns the same (xi, Txs, Tss, T4, T7, loglik) tuple as
    estep, with T4[j] complex (F, R, R) for R >= 2.
    """
    F, N, I = X.shape
    J = len(params.spat)
    v = np.stack([np.asarray(params.source_power(j)) for j in range(J)])
    R = np.stack([params.spat[j].cov(F) for j in range(J)])   # (J,F,I,I)
    eye = np.eye(I)[None, None]

    Sx = np.einsum("jfn,jfik->fnik", v, R)
    Sx = Sx + sigma[:, None, None, None] * eye
    Sxi = np.linalg.inv(Sx)
    _, logdet = np.linalg.slogdet(Sx)                         # (F, N)
    y = np.einsum("fnab,fnb->fna", Sxi, X)
    trSxiRxx = np.maximum(np.einsum("fna,fna->fn", X.conj(), y).real, 0.0)
    if noise_inject:
        trSxiRxx = trSxiRxx + sigma[:, None] * np.einsum(
            "fnaa->fn", Sxi).real

    def as_conv(comp):
        A = comp.A
        if comp.mix_type == "inst":
            A = np.broadcast_to(A.astype(np.complex128)[None], (F,) + A.shape)
        return A

    A_all = [as_conv(c) for c in params.spat]
    wvecs = [np.einsum("fir,fni->fnr", A_all[j].conj(), y) for j in range(J)]
    zvecs = ([np.einsum("fnab,fbr->fnar", Sxi, A_all[j]) for j in range(J)]
             if noise_inject else None)

    xi = np.empty((J, F, N))
    T4, Txs = [], []
    for j in range(J):
        rank = params.spat[j].rank
        wj = wvecs[j]
        trCR = np.sum(np.abs(wj) ** 2, axis=-1)
        if noise_inject:
            trCR = trCR + sigma[:, None] * np.sum(np.abs(zvecs[j]) ** 2,
                                                  axis=(2, 3))
        # leave-one-out Woodbury posterior: G = I_R + v_j A_j^H S_j^-1 A_j
        Sj = sum(np.einsum("fn,fab->fnab", v[k], R[k])
                 for k in range(J) if k != j) if J > 1 else \
            np.zeros((F, N, I, I), np.complex128)
        Sji = np.linalg.inv(Sj + sigma[:, None, None, None] * eye)
        M = np.einsum("fra,fnab,fbs->fnrs",
                      np.swapaxes(A_all[j].conj(), 1, 2), Sji, A_all[j])
        G = np.eye(rank)[None, None] + v[j][..., None, None] * M
        if rank == 1:
            den = np.maximum(G[..., 0, 0].real, 1.0)          # engine clamp
            trGinv = 1.0 / den
            T4.append((v[j] / den).sum(axis=-1))              # (F,)
        else:
            Ginv = np.linalg.inv(G)
            trGinv = np.maximum(np.einsum("fnrr->fn", Ginv).real, 0.0)
            T4.append(np.einsum("fn,fnrs->frs", v[j], Ginv))  # (F, R, R)
        xi[j] = np.maximum((v[j] ** 2 * trCR + v[j] * trGinv) / rank, EPS)
        txs = np.einsum("fn,fni,fnr->fir", v[j], X, wj.conj())
        if noise_inject:
            txs = txs + sigma[:, None, None] * np.einsum(
                "fn,fnir->fir", v[j], zvecs[j])
        Txs.append(txs)

    Tss = [[None] * J for _ in range(J)]
    T7 = [[None] * J for _ in range(J)]
    for j in range(J):
        for k in range(J):
            vv = v[j] * v[k]
            Tss[j][k] = np.einsum("fn,fnr,fns->frs", vv, wvecs[j],
                                  wvecs[k].conj())
            if noise_inject:
                Tss[j][k] = Tss[j][k] + np.einsum(
                    "f,fn,fnir,fnis->frs", sigma, vv,
                    zvecs[j].conj(), zvecs[k])
            if k != j:
                Mjk = np.einsum("fir,fnis->fnrs", A_all[j].conj(),
                                np.einsum("fnab,fbs->fnas", Sxi, A_all[k]))
                T7[j][k] = np.einsum("fn,fnrs->frs", vv, Mjk)

    loglik = -np.sum(logdet + trSxiRxx)
    return xi, Txs, Tss, T4, T7, loglik


# -- M-step ---------------------------------------------------------------------

def update_spatial(params: OracleParams, Txs, Tss, T4, T7, sigma):
    """Gauss-Seidel sweep on fixed sub-source-coordinate moments
    (mirrors ops/mstep.py)."""
    F = Txs[0].shape[0]
    J = len(params.spat)

    def as_conv(comp):
        if comp.mix_type == "inst":
            return np.broadcast_to(comp.A.astype(np.complex128)[None],
                                   (F,) + comp.A.shape).copy()
        return comp.A

    A_all = [as_conv(c) for c in params.spat]
    w = 1.0 / np.maximum(sigma, 1e-30)
    w = w / np.mean(w)
    for j, comp in enumerate(params.spat):
        if not comp.free:
            continue
        A = A_all[j]
        R = A.shape[-1]
        target = Txs[j].copy()
        for k in range(J):
            if k == j:
                continue
            block = Tss[k][j] - T7[k][j]
            target = target - np.einsum("fik,fkr->fir", A_all[k], block)
        post = (T4[j] if R >= 2
                else T4[j][:, None, None].astype(np.complex128))
        Rss = Tss[j][j] + post
        if comp.mix_type == "inst":
            wf = w[:, None, None]
            target_p = np.real((wf * target).sum(axis=0))
            Rss_p = np.real((wf * Rss).sum(axis=0))
            Rss_p = Rss_p + SPATIAL_REG * np.trace(Rss_p) * np.eye(R)
            comp.A = np.linalg.solve(Rss_p.T, target_p.T).T
        else:
            tr = np.einsum("frr->f", Rss).real
            ridge = SPATIAL_REG * tr + 1e-4 * np.mean(tr) + 1e-30
            target = target + ridge[:, None, None] * A
            Rss = Rss + ridge[:, None, None] * np.eye(R)
            A_new = np.swapaxes(
                np.linalg.solve(np.swapaxes(Rss, 1, 2),
                                np.swapaxes(target, 1, 2)), 1, 2)
            # per-frequency norm floor (mirror of ops/mstep.py: stops the
            # renormalization ratchet on starved bins)
            r2 = np.sum(np.abs(A_new) ** 2, axis=(1, 2))
            floor2 = 1e-6 * np.mean(r2)
            boost = np.maximum(np.sqrt(floor2 / np.maximum(r2, 1e-38)),
                               1.0)
            comp.A = A_new * boost[:, None, None]
        A_all[j] = as_conv(comp)


UPD_MIN, UPD_MAX = 1e-5, 1e5


def _mul_upd(factor, num_term, den_term):
    upd = np.clip(num_term / np.maximum(den_term, EPS), UPD_MIN, UPD_MAX)
    return np.maximum(factor * upd, EPS)


def _nmf_updates(comp: OracleSpectral, P, V):
    vk = comp.power()
    v_floor = 1e-12 * np.mean(P) + EPS
    for idx in range(4):
        if not comp.free[idx]:
            continue
        Vc = np.maximum(V, v_floor)
        num = P / (Vc * Vc)
        den = 1.0 / Vc
        W, H = comp.W(), comp.H()
        if idx == 0:
            rest = H if comp.FW is None else comp.FW @ H
            comp.FB = _mul_upd(comp.FB, num @ rest.T, den @ rest.T)
        elif idx == 1:
            comp.FW = _mul_upd(comp.FW, (comp.FB.T @ num) @ H.T,
                               (comp.FB.T @ den) @ H.T)
        elif idx == 2:
            lhs_n, lhs_d = W.T @ num, W.T @ den
            if comp.TB is not None:
                lhs_n, lhs_d = lhs_n @ comp.TB.T, lhs_d @ comp.TB.T
            comp.TW = _mul_upd(comp.TW, lhs_n, lhs_d)
        else:
            G = W @ comp.TW
            comp.TB = _mul_upd(comp.TB, G.T @ num, G.T @ den)
        vk_new = comp.power()
        V = V - vk + vk_new
        vk = vk_new
    return V


def _simm_updates(comp: OracleSpectral, P, V):
    """Multiplicative source-filter chain (mirrors
    ops/mstep.py::_simm_factor_updates): chain1 factors with the gradient
    weighted by the FB2@TW2 envelope, then chain2 factors weighted by
    chain1's product."""
    vk = comp.power()
    v_floor = 1e-12 * np.mean(P) + EPS
    for idx in range(4):
        if not comp.free[idx]:
            continue
        Vc = np.maximum(V, v_floor)
        E2 = comp.FB2 @ comp.TW2
        num = (P / (Vc * Vc)) * E2
        den = (1.0 / Vc) * E2
        W, H = comp.W(), comp.H()
        if idx == 0:
            rest = H if comp.FW is None else comp.FW @ H
            comp.FB = _mul_upd(comp.FB, num @ rest.T, den @ rest.T)
        elif idx == 1:
            comp.FW = _mul_upd(comp.FW, (comp.FB.T @ num) @ H.T,
                               (comp.FB.T @ den) @ H.T)
        elif idx == 2:
            lhs_n, lhs_d = W.T @ num, W.T @ den
            if comp.TB is not None:
                lhs_n, lhs_d = lhs_n @ comp.TB.T, lhs_d @ comp.TB.T
            comp.TW = _mul_upd(comp.TW, lhs_n, lhs_d)
        else:
            G = W @ comp.TW
            comp.TB = _mul_upd(comp.TB, G.T @ num, G.T @ den)
        vk_new = comp.power()
        V = V - vk + vk_new
        vk = vk_new
    for idx2 in range(2):
        if not comp.free2[idx2]:
            continue
        Vc = np.maximum(V, v_floor)
        C1 = comp.W() @ comp.H()
        num = (P / (Vc * Vc)) * C1
        den = (1.0 / Vc) * C1
        if idx2 == 0:
            comp.FB2 = _mul_upd(comp.FB2, num @ comp.TW2.T, den @ comp.TW2.T)
        else:
            comp.TW2 = _mul_upd(comp.TW2, comp.FB2.T @ num, comp.FB2.T @ den)
        vk_new = comp.power()
        V = V - vk + vk_new
        vk = vk_new
    return V


def _state_factor_update(comp: OracleSpectral, P, V):
    """GMM/HMM TW replacement (mirrors ops/hmm.py::state_factor_update)."""
    vk = comp.power()
    W = comp.W()
    F = P.shape[0]
    Winv = 1.0 / np.maximum(W, EPS)
    g = np.maximum((Winv.T @ P) / F, EPS)                  # (Q, N)
    logw = np.sum(np.log(np.maximum(W, EPS)), axis=0)
    L = -(F * np.log(g) + logw[:, None] + F)               # (Q, N)
    Q = W.shape[1]
    if comp.constraint == "GMM":
        prior = comp.trans if comp.trans is not None else np.full(Q, 1.0 / Q)
        logp = L + np.log(np.maximum(prior, EPS))[:, None]
        logp -= logp.max(axis=0, keepdims=True)
        gamma = np.exp(logp)
        gamma /= gamma.sum(axis=0, keepdims=True)
    else:                                                  # HMM
        trans = comp.trans if comp.trans is not None else np.full((Q, Q),
                                                                  1.0 / Q)
        logT = np.log(np.maximum(trans, EPS))
        N = L.shape[1]
        log_pi = np.full(Q, -np.log(Q))

        def lse(x, axis):
            m = x.max(axis=axis, keepdims=True)
            return (m + np.log(np.exp(x - m).sum(axis=axis,
                                                 keepdims=True))).squeeze(axis)

        alphas = np.empty((N, Q))
        alphas[0] = log_pi + L[:, 0]
        for n in range(1, N):
            alphas[n] = lse(alphas[n - 1][:, None] + logT, 0) + L[:, n]
        betas = np.zeros((N, Q))
        for n in range(N - 2, -1, -1):
            betas[n] = lse(logT + (L[:, n + 1] + betas[n + 1])[None, :], 1)
        post = alphas + betas
        post -= lse(post, 1)[:, None]
        gamma = np.exp(post).T
    comp.TW = np.maximum(gamma * g, EPS)
    return V - vk + comp.power()


def _nmf_fb_fw_only(comp: OracleSpectral, P, V):
    """NMF updates restricted to FB/FW (mirrors update_spectral's
    pre-state-update template learning)."""
    saved = comp.free
    comp.free = (saved[0], saved[1], False, False)
    V = _nmf_updates(comp, P, V)
    comp.free = saved
    return V


def update_spectral(params: OracleParams, xi):
    for j in range(len(params.spat)):
        comps = [k for k in params.spec if k.spat_ind == j]
        if not comps:
            continue
        V = sum(k.power() for k in comps)
        P = xi[j]
        for comp in comps:
            if comp.FB2 is not None:
                V = _simm_updates(comp, P, V)
            elif comp.constraint == "NMF":
                V = _nmf_updates(comp, P, V)
            else:
                if comp.free[0] or comp.free[1]:
                    V = _nmf_fb_fw_only(comp, P, V)
                V = _state_factor_update(comp, P, V)


def renormalize(params: OracleParams):
    for j, comp in enumerate(params.spat):
        if not comp.free:
            continue
        if comp.mix_type == "inst":
            norm = np.sum(comp.A ** 2) / comp.A.shape[0]
        else:
            norm = np.mean(np.sum(np.abs(comp.A) ** 2, axis=(1, 2))
                           ) / comp.A.shape[1]
        norm = max(norm, 1e-30)
        comp.A = comp.A / np.sqrt(norm)
        for k in params.spec:
            if k.spat_ind != j:
                continue
            for idx, name in enumerate(("FB", "FW", "TW", "TB")):
                if k.free[idx] and getattr(k, name) is not None:
                    setattr(k, name, getattr(k, name) * norm)
                    break
            else:
                if k.FB2 is not None:  # SIMM: fall back to the second chain
                    for idx2, name in enumerate(("FB2", "TW2")):
                        if k.free2[idx2]:
                            setattr(k, name, getattr(k, name) * norm)
                            break
    for k in params.spec:
        chain = [(i, n) for i, n in enumerate(("FB", "FW", "TW", "TB"))
                 if getattr(k, n) is not None]
        for (ia, na), (ib, nb) in zip(chain[:-1], chain[1:]):
            if not (k.free[ia] and k.free[ib]):
                continue
            s = np.maximum(getattr(k, na).sum(axis=0), EPS)
            setattr(k, na, getattr(k, na) / s[None, :])
            setattr(k, nb, getattr(k, nb) * s[:, None])


# -- driver ---------------------------------------------------------------------

def oracle_gem_run(params: OracleParams, X, niter: int,
                   annealing: str = "ann", sigma_start_frac: float = 1e-2,
                   sigma_end_frac: float = 3e-6, do_renormalize: bool = True,
                   spatial_hold_frac: float = 0.1):
    sigma0, sigma1 = annealing_endpoints(X, sigma_start_frac, sigma_end_frac)
    logliks = np.zeros(niter)
    hold = int(spatial_hold_frac * niter)
    estep_fn = estep if X.shape[-1] == 2 else estep_general
    for it in range(niter):
        sigma = noise_psd(it, niter, sigma0, sigma1, annealing)
        xi, Txs, Tss, T4, T7, ll = estep_fn(
            X, params, sigma, noise_inject=(annealing == "ann_ns_inj"))
        if it >= hold:
            update_spatial(params, Txs, Tss, T4, T7, sigma)
        update_spectral(params, xi)
        if do_renormalize:
            renormalize(params)
        logliks[it] = ll
    return params, logliks


def oracle_separate_general(params: OracleParams, X, sigma):
    """Wiener posterior-mean images for any I (mirrors
    engine_general.separate_sources_general): y^_j = v_j A_j A_j^H Sx^-1 x."""
    F, N, I = X.shape
    J = len(params.spat)
    v = np.stack([np.asarray(params.source_power(j)) for j in range(J)])
    R = np.stack([params.spat[j].cov(F) for j in range(J)])
    Sx = np.einsum("jfn,jfik->fnik", v, R)
    Sx = Sx + sigma[:, None, None, None] * np.eye(I)[None, None]
    y = np.einsum("fnab,fnb->fna", np.linalg.inv(Sx), X)
    Y = np.empty((J, F, N, I), np.complex128)
    for j in range(J):
        Y[j] = v[j][..., None] * np.einsum("fab,fnb->fna", R[j], y)
    return Y


def oracle_separate(params: OracleParams, X, sigma):
    """Wiener posterior-mean images, (J, F, N, 2)."""
    if X.shape[-1] != 2:
        return oracle_separate_general(params, X, sigma)
    F, N = X.shape[:2]
    J = len(params.spat)
    v = np.stack([np.asarray(params.source_power(j)) for j in range(J)])
    R = np.stack([params.spat[j].cov(F) for j in range(J)])
    Sx = np.einsum("jfn,jfik->fnik", v, R)
    Sx = Sx + sigma[:, None, None, None] * np.eye(2)[None, None]
    trR, Xc = _cross_terms(R, params, F)
    det = _stable_det(v, trR, Xc, sigma)
    Y = np.empty((J, F, N, 2), np.complex128)

    def adj(P):
        out = np.empty_like(P)
        out[..., 0, 0] = P[..., 1, 1]
        out[..., 1, 1] = P[..., 0, 0]
        out[..., 0, 1] = -P[..., 0, 1]
        out[..., 1, 0] = -P[..., 1, 0]
        return out

    eye2 = np.eye(2)[None, None]
    for j in range(J):
        # adjugate-linearity expansion (mirrors ops/wiener.py)
        num = sigma[:, None, None, None] * R[j][:, None]
        num = num + (v[j] * 0.5 * Xc[j, j][:, None])[..., None, None] * eye2
        for k in range(J):
            if k == j:
                continue
            Mjk = R[j] @ adj(R[k])
            num = num + v[k][..., None, None] * Mjk[:, None]
        y = np.einsum("fnab,fnb->fna", num, X)
        Y[j] = y * (v[j] / det)[..., None]
    return Y
