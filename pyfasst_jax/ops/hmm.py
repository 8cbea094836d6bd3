"""GMM / HMM spectral-state E-step (discrete states under lax.scan).

Reference parity: the GMM/HMM-constrained TW factors of
pyfasst/audioModel.py (MultiChanHMM variant; UNVERIFIED -- mount empty, see
SURVEY.md §A): each frame activates ONE spectral state q with a free gain;
state posteriors (GMM: softmax of per-frame log-likelihoods; HMM:
forward-backward over the transition matrix) replace the NMF TW update.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from pyfasst_jax.models.components import GMM, HMM, SpectralComp


def _state_gains_and_loglik(P: jnp.ndarray, W: jnp.ndarray, eps: float):
    """Per-(state, frame) IS-optimal gains and log-likelihoods.

    For state pattern w_q (F,) and observed PSD P(:, n), the IS-divergence-
    optimal gain is g(q,n) = mean_f P(f,n)/w_q(f), and the (negative)
    divergence at the optimum gives the state log-likelihood
        L(q,n) = -sum_f [ log(g w_q) + 1 ]  - sum_f log P  (const in q dropped)
    """
    F = P.shape[0]
    Winv = 1.0 / jnp.maximum(W, eps)                     # (F, Q)
    g = jnp.maximum((Winv.T @ P) / F, eps)               # (Q, N)
    logw = jnp.sum(jnp.log(jnp.maximum(W, eps)), axis=0)  # (Q,)
    L = -(F * jnp.log(g) + logw[:, None] + F)            # (Q, N)
    return g, L


def _gmm_posteriors(L: jnp.ndarray, log_prior: jnp.ndarray) -> jnp.ndarray:
    return jax.nn.softmax(L + log_prior[:, None], axis=0)


def _hmm_posteriors(L: jnp.ndarray, log_trans: jnp.ndarray) -> jnp.ndarray:
    """Forward-backward in log space as two lax.scans. L: (Q, N) -> gamma."""
    Q, N = L.shape
    log_pi = jnp.full((Q,), -jnp.log(Q), L.dtype)

    def fwd(alpha, logl):
        a = jax.nn.logsumexp(alpha[:, None] + log_trans, axis=0) + logl
        return a, a

    a0 = log_pi + L[:, 0]
    _, alphas = jax.lax.scan(fwd, a0, L.T[1:])
    alphas = jnp.concatenate([a0[None], alphas], axis=0)      # (N, Q)

    def bwd(beta, logl):
        b = jax.nn.logsumexp(log_trans + (logl + beta)[None, :], axis=1)
        return b, b

    bN = jnp.zeros((Q,), L.dtype)
    _, betas_rev = jax.lax.scan(bwd, bN, L.T[1:][::-1])
    betas = jnp.concatenate([betas_rev[::-1], bN[None]], axis=0)

    post = alphas + betas                                     # (N, Q)
    post = post - jax.nn.logsumexp(post, axis=1, keepdims=True)
    return jnp.exp(post).T                                    # (Q, N)


def viterbi_path(L: jnp.ndarray, log_trans: jnp.ndarray) -> jnp.ndarray:
    """MAP state sequence, the lax.scan argmax dual of forward-backward.

    L: (Q, N) per-(state, frame) log-likelihoods; log_trans: (Q, Q).
    Returns the hard path as int32 (N,). Forward pass carries the best
    log-score per state and records the argmax predecessors; a reverse scan
    backtracks. Reference parity: the reference's HMM constraint offers a
    hard (Viterbi) decode of TW states (pyfasst/audioModel.py, UNVERIFIED).
    """
    Q, N = L.shape
    log_pi = jnp.full((Q,), -jnp.log(Q), L.dtype)

    def fwd(delta, logl):
        scores = delta[:, None] + log_trans           # (from, to)
        psi = jnp.argmax(scores, axis=0)              # (Q,) best predecessor
        d = jnp.max(scores, axis=0) + logl
        return d, (d, psi)

    d0 = log_pi + L[:, 0]
    dN, (_, psis) = jax.lax.scan(fwd, d0, L.T[1:])    # psis: (N-1, Q)

    def back(q, psi):
        prev = psi[q]
        return prev, prev

    qN = jnp.argmax(dN)
    _, path_rev = jax.lax.scan(back, qN, psis[::-1])
    return jnp.concatenate([path_rev[::-1], qN[None]]).astype(jnp.int32)


def state_factor_update(comp: SpectralComp, P: jnp.ndarray, V: jnp.ndarray,
                        eps: float = 1e-30) -> Tuple[SpectralComp, jnp.ndarray]:
    """GMM/HMM replacement for the NMF TW update.

    The component's states are the columns of W = FB @ FW (F, Q); TW (Q, N)
    becomes gamma(q,n) * g(q,n) -- posterior-weighted per-frame gains (the
    soft-EM form of the reference's discrete-state constraint). With
    comp.decode == 'viterbi' (HMM only) gamma is instead the one-hot MAP
    path: a hard single-state-per-frame decode. Free FB/FW factors are
    updated by their NMF rules in mstep.update_spectral BEFORE this call;
    TB must be None for state models.
    """
    if comp.TB is not None:
        raise ValueError("GMM/HMM spectral components must have TB=None")
    vk = comp.power()
    W = comp.freq_pattern()                                   # (F, Q)
    g, L = _state_gains_and_loglik(P, W, eps)
    if comp.constraint == GMM:
        prior = comp.trans if comp.trans is not None else \
            jnp.full((W.shape[1],), 1.0 / W.shape[1], P.dtype)
        gamma = _gmm_posteriors(L, jnp.log(jnp.maximum(prior, eps)))
    elif comp.constraint == HMM:
        Q = W.shape[1]
        trans = comp.trans if comp.trans is not None else \
            jnp.full((Q, Q), 1.0 / Q, P.dtype)
        log_trans = jnp.log(jnp.maximum(trans, eps))
        if comp.decode == "viterbi":
            path = viterbi_path(L, log_trans)
            gamma = jax.nn.one_hot(path, Q, dtype=P.dtype).T  # (Q, N)
        else:
            gamma = _hmm_posteriors(L, log_trans)
    else:
        raise ValueError(f"not a state constraint: {comp.constraint}")
    TW = jnp.maximum(gamma * g, eps)                          # (Q, N)
    comp = comp.replace(TW=TW)
    vk_new = comp.power()
    return comp, V - vk + vk_new
