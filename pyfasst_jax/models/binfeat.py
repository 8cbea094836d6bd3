"""Learned per-bin TF embeddings for blind source assignment.

THE measured boundary of the blind pipeline (docs/design.md §6e/§6f) is
per-bin evidence quality: every hand-crafted vote family tops out at
power-weighted accuracy ~0.56 on music (clustering UB 0.74) and
0.41-0.61 on the image-method family (band-EM UB 0.73-0.82), and all
four cross-band alignment families are measured dead. The hand features
(`spatial_init.tf_covariance_features`) are PER-BIN spatial signatures:
at 0 dB direct-to-reverb they saturate, and the per-frequency cluster
permutation must then be glued by envelope statistics -- the step that
fails on beat-locked and image-method material.

This module attacks the boundary with the one untried evidence family
(VERDICT r4 item 1): a small fully-convolutional JAX network that maps
the local feature PLANE -- not a single bin -- to a unit-norm embedding
per bin, trained with the permutation-free deep-clustering objective
(Hershey et al. 2016, arXiv:1508.04306; PAPERS.md) on unlimited draws
from the repo's own fixture generators (tools/validate_hw.py sources +
random-FIR rooms, tools/fixtures2.py image-method rooms). Nothing here
exists in reference pyfasst (mount empty -- SURVEY.md provenance); it
slots into the existing blind pool as one more vote candidate.

Why this can pass where the hand features cannot:

- CONTEXT: the conv stack sees ~90 frequency bins x ~50 frames around
  each bin (dilated receptive field), so harmonic stacks, comodulated
  onsets, and spatial-signature continuity across frequency inform each
  bin's embedding -- exactly the evidence the per-bin covariance throws
  away.
- NO PERMUTATION STEP: the deep-clustering loss ||VV' - YY'||_F^2 is
  invariant to source numbering but GLOBAL over the plane, so bins of
  the same source embed close across ALL frequencies. Inference is one
  weighted spherical k-means over every bin -- the per-frequency
  alignment problem (the measured killer) never arises.
- DEVICE-FIRST: convolutions are matmul work; training and inference
  are a few ms per plane at fixture shapes. Embeddings feed an argmax
  decision, so entry points pin float32 matmul precision (reduced-
  precision matmuls -- TF32 on a GPU -- flip such decisions; CLAUDE.md).

Training/evaluation hygiene (tools/train_binfeat.py): held-out seeds of
both families, cross-family transfer (train A -> test B and vice
versa), and never-trained scenario transfer (music stems at 44.1 kHz,
validate_hw speech) -- tables in docs/design.md §6j.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = [
    "bin_inputs", "init_params", "embed", "embed_host", "dc_loss",
    "learned_votes", "save_params", "load_params", "default_params_path",
    "has_default_params",
]

# architecture constants (one published geometry -- the weights file
# carries its own copy so future geometries stay loadable)
_WIDTH = 40
_EMB_DIM = 16
# (kernel_f, kernel_n, dilation_f, dilation_n) per conv layer
_LAYERS = (
    (5, 5, 1, 1),
    (5, 5, 2, 1),
    (5, 5, 4, 2),
    (5, 5, 8, 4),
    (3, 3, 16, 8),
)


# -- inputs ---------------------------------------------------------------

def bin_inputs(X: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(F, N, I) complex STFT plane -> (inputs (F, N, C), pw (F, N)).

    Channels are scale-invariant so one network transfers across
    families/levels: the I*I normalized covariance entries of
    `spatial_init.tf_covariance_features` (per-bin spatial signature)
    plus one standardized log-power channel (spectral structure --
    harmonicity, onsets -- lives here; the covariance channels are
    blind to it).
    """
    from pyfasst_jax.models.spatial_init import tf_covariance_features

    feat, _w, pw, _xx = tf_covariance_features(X)
    lp = np.log(pw + 1e-12)
    lp = (lp - np.median(lp)) / (lp.std() + 1e-6)
    inp = np.concatenate([feat, lp[..., None]], -1).astype(np.float32)
    return inp, pw.astype(np.float32)


# -- network (pure functions over a param dict) ---------------------------

def init_params(seed: int = 0, c_in: int = 5, width: int = _WIDTH,
                emb_dim: int = _EMB_DIM, layers=_LAYERS) -> Dict:
    """He-initialized parameter pytree. Keys: conv{i}/{w,b,g}; head/{w,b}.
    g is the per-channel LayerNorm gain applied after each conv."""
    rng = np.random.default_rng(seed)
    params = {"_meta": {"c_in": c_in, "width": width, "emb_dim": emb_dim,
                        "layers": [list(l) for l in layers]}}
    cin = c_in
    for i, (kf, kn, _df, _dn) in enumerate(layers):
        fan_in = kf * kn * cin
        params[f"conv{i}/w"] = (rng.standard_normal((kf, kn, cin, width))
                                * np.sqrt(2.0 / fan_in)).astype(np.float32)
        params[f"conv{i}/b"] = np.zeros((width,), np.float32)
        params[f"conv{i}/g"] = np.ones((width,), np.float32)
        cin = width
    params["head/w"] = (rng.standard_normal((1, 1, width, emb_dim))
                        * np.sqrt(1.0 / width)).astype(np.float32)
    params["head/b"] = np.zeros((emb_dim,), np.float32)
    return params


def embed(params: Dict, inp):
    """(B, F, N, C) float32 -> (B, F, N, D) unit-norm embeddings (jittable).

    SAME-padded dilated conv stack, channel LayerNorm + GELU per layer,
    1x1 head, L2 normalization. Callers running under jit on an
    accelerator must pin jax.default_matmul_precision("highest") -- the
    embeddings feed argmin/argmax cluster decisions, which reduced-
    precision (TF32) matmuls flip.
    """
    import jax
    import jax.numpy as jnp

    meta = params["_meta"]
    h = inp
    for i, (kf, kn, df, dn) in enumerate(meta["layers"]):
        h = jax.lax.conv_general_dilated(
            h, params[f"conv{i}/w"], window_strides=(1, 1),
            padding="SAME", rhs_dilation=(df, dn),
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
        h = h + params[f"conv{i}/b"]
        mu = h.mean(-1, keepdims=True)
        sd = jnp.sqrt(h.var(-1, keepdims=True) + 1e-6)
        h = (h - mu) / sd * params[f"conv{i}/g"]
        h = jax.nn.gelu(h)
    v = jax.lax.conv_general_dilated(
        h, params["head/w"], window_strides=(1, 1), padding="SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")) + params["head/b"]
    return v / jnp.maximum(
        jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-8)


def embed_host(params: Dict, inp: np.ndarray,
               platform: Optional[str] = None) -> np.ndarray:
    """(F, N, C) -> (F, N, D) numpy, one jitted call; precision pinned."""
    import jax

    fn = _embed_jit(params["_meta"], platform)
    arr = jax.device_put(inp[None], _cpu_device(platform))
    weights = {k: v for k, v in params.items() if k != "_meta"}
    return np.asarray(fn(_as_pytree(weights, platform), arr))[0]


_EMBED_CACHE: Dict = {}


def _cpu_device(platform):
    import jax
    if platform is None:
        return None
    return jax.devices(platform)[0]


def _as_pytree(params, platform=None):
    import jax
    dev = _cpu_device(platform)
    return {k: (v if k == "_meta" else jax.device_put(np.asarray(v), dev))
            for k, v in params.items()}


def _embed_jit(meta: Dict, platform=None):
    import jax

    # meta is STATIC net geometry (kernel sizes/dilations): close over it
    # rather than passing it through jit, which would trace it.
    key = (json.dumps(meta, sort_keys=True), platform)
    if key not in _EMBED_CACHE:
        def fn(weights, inp):
            with jax.default_matmul_precision("highest"):
                return embed({**weights, "_meta": meta}, inp)
        _EMBED_CACHE[key] = jax.jit(fn, backend=platform) \
            if platform else jax.jit(fn)
    return _EMBED_CACHE[key]


# -- training objective ----------------------------------------------------

def dc_loss(V, Y, wb):
    """Power-weighted deep-clustering loss, normalized per plane.

    V (B, F, N, D) unit embeddings; Y (B, F, N, J) one-hot dominance;
    wb (B, F, N) bin weights (sum 1 per plane). The O((FN)^2) affinity
    distance ||VV' - YY'||_F^2 collapses to Gram matrices:
        ||V'V||^2 - 2 ||V'Y||^2 + ||Y'Y||^2,   rows scaled by sqrt(wb),
    i.e. O(FN * D^2) -- jittable at any plane size. Dividing by
    ||Y'Y||^2 makes draws comparable (0 = perfect, 1 = uninformative).
    """
    import jax.numpy as jnp

    B = V.shape[0]
    s = jnp.sqrt(jnp.maximum(wb, 0.0))[..., None]
    Vw = (V * s).reshape(B, -1, V.shape[-1])
    Yw = (Y * s).reshape(B, -1, Y.shape[-1])
    vtv = jnp.einsum("bnd,bne->bde", Vw, Vw)
    vty = jnp.einsum("bnd,bnj->bdj", Vw, Yw)
    yty = jnp.einsum("bnj,bnk->bjk", Yw, Yw)
    ref = jnp.maximum((yty ** 2).sum((-2, -1)), 1e-12)
    num = ((vtv ** 2).sum((-2, -1)) - 2.0 * (vty ** 2).sum((-2, -1))
           + (yty ** 2).sum((-2, -1)))
    return (num / ref).mean()


# -- inference: embeddings -> votes ---------------------------------------

def _weighted_spherical_kmeans(V2, wb, J, seed, iters=30):
    """Host k-means on unit rows V2 (M, D) with weights wb (M,).
    Returns (labels (M,), mean within-cluster cosine score)."""
    rng = np.random.default_rng(seed)
    # power-biased init: sample proportional to weight
    p = wb / wb.sum()
    C = V2[rng.choice(len(V2), J, replace=False, p=p)]
    lab = np.zeros(len(V2), np.int64)
    for _ in range(iters):
        sim = V2 @ C.T                                   # (M, J)
        lab = sim.argmax(1)
        for j in range(J):
            m = lab == j
            if m.any():
                c = (V2[m] * wb[m, None]).sum(0)
                C[j] = c / max(np.linalg.norm(c), 1e-12)
            else:                                         # dead centroid:
                C[j] = V2[rng.choice(len(V2), p=p)]       # re-seed by power
    score = float((wb * (V2 @ C.T).max(1)).sum() / wb.sum())
    return lab, score


def learned_votes(X: np.ndarray, J: int, params: Optional[Dict] = None,
                  n_seeds: int = 4, platform: Optional[str] = None,
                  return_emb: bool = False):
    """(F, N, I) complex STFT -> learned vote plane (F, N, J) one-hot.

    Embeds every bin (one device call), then runs `n_seeds` weighted
    spherical k-means over ALL bins jointly and keeps the best
    within-cluster-cosine run. Because embeddings are globally aligned
    by training, there is no per-frequency permutation to solve -- the
    step where every hand-crafted family lost its accuracy.
    """
    if params is None:
        params = load_params()
    inp, pw = bin_inputs(X)
    V = embed_host(params, inp, platform=platform)         # (F, N, D)
    F, N, D = V.shape
    V2 = V.reshape(-1, D).astype(np.float64)
    wb = pw.reshape(-1).astype(np.float64)
    wb = wb / max(wb.sum(), 1e-20)
    best = None
    for s in range(n_seeds):
        lab, score = _weighted_spherical_kmeans(V2, wb, J, seed=s)
        if best is None or score > best[1]:
            best = (lab, score)
    votes = np.eye(J, dtype=np.float64)[best[0].reshape(F, N)]
    if return_emb:
        return votes, V
    return votes


# -- weight persistence ----------------------------------------------------

def default_params_path() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "data", "binfeat.npz")


def has_default_params() -> bool:
    return os.path.exists(default_params_path())


def save_params(params: Dict, path: Optional[str] = None) -> str:
    path = path or default_params_path()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    arrays = {k: np.asarray(v) for k, v in params.items() if k != "_meta"}
    arrays["_meta_json"] = np.frombuffer(
        json.dumps(params["_meta"]).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)
    return path


def load_params(path: Optional[str] = None) -> Dict:
    path = path or default_params_path()
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no trained binfeat weights at {path}; run "
            "tools/train_binfeat.py or pass params explicitly")
    z = np.load(path)
    params = {k: z[k] for k in z.files if k != "_meta_json"}
    params["_meta"] = json.loads(bytes(z["_meta_json"]).decode())
    return params
