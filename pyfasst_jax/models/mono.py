"""Blind MONO spectral init: mixture IS-NMF + envelope clustering.

The reference handles mono input through the same NMF machinery as stereo
(pyfasst/audioModel.py, UNVERIFIED — mount empty), but its blind quality
on mono is whatever a random FB/TW init reaches. Round-4 diagnosis
(tools/mono_ceiling.py, docs/design.md §6h): on the validation mono
fixture the random init scores 3.17 dB exact-image min SDR while the SAME
model from an oracle frequency-basis init reaches 9.79 — with no spatial
cues, basin entry is the whole gap and the consensus spatial-clustering
machinery (models/spatial_init.py) has nothing to cluster on.

This module is the measured remedy, the classic mono-NMF recipe (Spiertz
& Gnann lineage) done as an INIT rather than a post-hoc mask: factorize
the mixture power once with J*K components, group components into J
sources by clustering their time-envelope correlations, and initialize
each source's FB/TW from its group. The EM then refines from a basin
where each source already owns its spectral dictionary. Measured on the
validation fixture (CPU + hardware, 200-300 iters): random 3.28 ->
nmf-cluster 11.45 dB min SDR — ABOVE the oracle-FB ceiling (9.79),
because the mixture factorization allocates components by what the
mixture actually needs instead of per-source equal splits.

All decision-feeding computation (the NMF and the clustering) runs on
HOST in float64: reduced-precision device matmuls flip clustering
decisions (CLAUDE.md, "Precision") and the init cost
is negligible (~0.3 s) next to one GEM iteration chunk.

ROBUSTNESS (round-5 sweep, `tools/mono_ceiling.py --sweep 5`, hardware):
the single-fixture win does NOT generalize — across 5 independent draws
(J in {2,3}, sampled source kinds) nmf-cluster measures worst/median
-1.36/2.05 dB vs random-init 0.37/3.75. The init wins when envelope
clusters track sources (gated/switched material, the J=3 draw) and
loses when a source's components split across envelope clusters (steady
band-limited pairs); final-loglik arbitration between the two inits was
also measured and fails (3/5 correct, both misses costly — design.md
§6h). Hence this stays the OPT-IN `--spatial-init` mono path, not an
unconditional default.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

__all__ = ["is_nmf", "nmf_cluster_init", "apply_mono_init"]


def is_nmf(P: np.ndarray, K: int, iters: int = 200, seed: int = 0,
           eps: float = 1e-9) -> Tuple[np.ndarray, np.ndarray]:
    """Plain float64 IS-NMF P ~ W @ H (multiplicative updates).

    Host-side by design (decision-feeding; see module docstring). Columns
    of W are normalized to unit sum with the scale pushed into H.
    """
    rng = np.random.default_rng(seed)
    F, N = P.shape
    W = 0.5 + rng.random((F, K))
    H = 0.5 + rng.random((K, N))
    P = np.maximum(np.asarray(P, np.float64), eps)
    for _ in range(iters):
        V = np.maximum(W @ H, eps)
        W *= ((P / V ** 2) @ H.T) / np.maximum((1.0 / V) @ H.T, eps)
        V = np.maximum(W @ H, eps)
        H *= (W.T @ (P / V ** 2)) / np.maximum(W.T @ (1.0 / V), eps)
    s = W.sum(0, keepdims=True)
    return W / np.maximum(s, eps), H * s.T


def _kmeans_corr(C: np.ndarray, J: int, seed: int) -> np.ndarray:
    """Spherical k-means on a correlation matrix's rows (labels (K,))."""
    r = np.random.default_rng(seed)
    lab = r.integers(0, J, C.shape[0])
    for _ in range(100):
        cent = np.stack([C[lab == j].mean(0) if (lab == j).any()
                         else r.standard_normal(C.shape[0])
                         for j in range(J)])
        new = np.argmax(cent @ C, axis=0)
        if np.array_equal(new, lab):
            break
        lab = new
    return lab


def nmf_cluster_init(X: np.ndarray, J: int, nmf_comps: int,
                     nmf_iters: int = 200, n_seeds: int = 4,
                     seed: int = 0) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Blind mono spectral init: [(FB_j, TW_j)] * J, each (F, K)/(K, N).

    X: (F, N) or (F, N, 1) complex mixture spectrogram. Factorizes
    |X|^2 with J*nmf_comps components, clusters the components' centered
    log-envelopes by correlation (k-means over `n_seeds` restarts, best
    within-cluster coherence wins), and packs each group's components
    into an exactly-K init per source: groups larger than K keep their K
    highest-energy components, smaller groups pad with tiny random ones
    (static shapes — the model's K is a compile-time constant).
    """
    X = np.asarray(X)
    if X.ndim == 3:
        X = X[..., 0]
    P = np.abs(X) ** 2
    F, N = P.shape
    K = int(nmf_comps)
    W, H = is_nmf(P, J * K, iters=nmf_iters, seed=seed)

    E = np.log1p(H / np.maximum(H.mean(1, keepdims=True), 1e-12))
    E = E - E.mean(1, keepdims=True)
    E /= np.maximum(np.linalg.norm(E, axis=1, keepdims=True), 1e-12)
    C = E @ E.T

    best_lab, best_score = None, -np.inf
    for s in range(n_seeds):
        lab = _kmeans_corr(C, J, seed + s)
        if len(set(lab.tolist())) < J:
            continue
        # within-cluster mean correlation, worst cluster (a grouping that
        # leaves one incoherent cluster should lose even if others shine)
        score = min(float(C[np.ix_(lab == j, lab == j)].mean())
                    for j in range(J))
        if score > best_score:
            best_lab, best_score = lab, score
    if best_lab is None:                       # all restarts degenerate
        best_lab = np.arange(J * K) % J
    energy = (W.sum(0) * H.sum(1))             # per-component energy

    rng = np.random.default_rng(seed + 1000)
    out = []
    for j in range(J):
        idx = np.where(best_lab == j)[0]
        idx = idx[np.argsort(-energy[idx])][:K]
        Wj, Hj = W[:, idx], H[idx]
        k = Wj.shape[1]
        if k < K:                              # pad to the static K
            Wj = np.concatenate(
                [Wj, 1e-3 * (0.5 + rng.random((F, K - k)))], 1)
            Hj = np.concatenate(
                [Hj, 1e-3 * (0.5 + rng.random((K - k, N)))], 0)
        out.append((Wj, np.maximum(Hj, 1e-6)))
    return out


def apply_mono_init(params, init) -> "FasstParams":  # noqa: F821
    """Install nmf_cluster_init's [(FB_j, TW_j)] on a FasstParams pytree
    (one spectral component per source, NMF constraint)."""
    import dataclasses

    import jax.numpy as jnp

    spec = []
    for j, sc in enumerate(params.spec):
        Wj, Hj = init[j]
        if sc.FB.shape != Wj.shape or sc.TW.shape != Hj.shape:
            raise ValueError(
                f"mono init shape mismatch for source {j}: model "
                f"{sc.FB.shape}/{sc.TW.shape} vs init {Wj.shape}/"
                f"{Hj.shape}")
        spec.append(dataclasses.replace(
            sc, FB=jnp.asarray(Wj, jnp.float32),
            TW=jnp.asarray(Hj, jnp.float32)))
    return dataclasses.replace(params, spec=tuple(spec))
