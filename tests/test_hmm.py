"""GMM/HMM spectral-state E-step tests (BASELINE.json configs[3])."""
import numpy as np
import jax
import jax.numpy as jnp

from pyfasst_jax.models.components import (
    GMM, HMM, FasstParams, SpatialComp, SpectralComp,
)
from pyfasst_jax.ops import hmm as hmm_ops
from pyfasst_jax.ops.gem import annealing_endpoints, run_gem
from pyfasst_jax.ops.wiener import separate_sources
from pyfasst_jax.utils.config import GEMConfig


def test_hmm_posteriors_match_bruteforce(rng):
    """Log-space forward-backward vs explicit enumeration on a tiny chain."""
    Q, N = 3, 6
    L = jnp.asarray(rng.standard_normal((Q, N)))
    trans = jnp.asarray(rng.dirichlet(np.ones(Q), size=Q))
    got = np.asarray(hmm_ops._hmm_posteriors(L, jnp.log(trans)))

    # brute force over all Q^N paths
    import itertools
    Lnp, Tnp = np.asarray(L, np.float64), np.log(np.asarray(trans, np.float64))
    logpi = -np.log(Q)
    post = np.zeros((Q, N))
    tot = -np.inf
    path_logps = []
    for path in itertools.product(range(Q), repeat=N):
        lp = logpi + Lnp[path[0], 0]
        for n in range(1, N):
            lp += Tnp[path[n - 1], path[n]] + Lnp[path[n], n]
        path_logps.append((path, lp))
        tot = np.logaddexp(tot, lp)
    for path, lp in path_logps:
        w = np.exp(lp - tot)
        for n, q in enumerate(path):
            post[q, n] += w
    np.testing.assert_allclose(got, post, rtol=1e-4, atol=1e-5)


def test_gmm_posteriors_are_softmax(rng):
    Q, N = 4, 5
    L = jnp.asarray(rng.standard_normal((Q, N)))
    prior = jnp.asarray([0.1, 0.2, 0.3, 0.4])
    got = np.asarray(hmm_ops._gmm_posteriors(L, jnp.log(prior)))
    want = np.exp(np.asarray(L) + np.log(np.asarray(prior))[:, None])
    want = want / want.sum(axis=0, keepdims=True)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert np.allclose(got.sum(axis=0), 1.0, atol=1e-5)


def test_state_gains_optimal(rng):
    """IS-optimal per-state gain: g = mean_f P/w."""
    F, Q, N = 16, 3, 8
    P = jnp.asarray(0.5 + rng.random((F, N)))
    W = jnp.asarray(0.5 + rng.random((F, Q)))
    g, L = hmm_ops._state_gains_and_loglik(P, W, 1e-30)
    want = (np.asarray(P)[:, None, :] / np.asarray(W)[:, :, None]).mean(axis=0)
    np.testing.assert_allclose(np.asarray(g), want, rtol=1e-5)
    assert L.shape == (Q, N)


def _hmm_problem(rng, constraint, F=48, N=60):
    """Mixture of an HMM-ish source (alternating spectral states) and a
    broadband noise source, panned apart."""
    # state templates: lowband vs highband
    w1 = np.zeros(F); w1[4:12] = 1.0
    w2 = np.zeros(F); w2[20:32] = 1.0
    states = np.tile(np.repeat([0, 1], 6), N)[:N]          # slow alternation
    tpl = np.stack([w1, w2], axis=1)                       # (F, 2)
    S1 = (tpl[:, states] * (rng.standard_normal((F, N))
                            + 1j * rng.standard_normal((F, N)))) * 2.0
    S2 = 0.7 * (rng.standard_normal((F, N)) + 1j * rng.standard_normal((F, N)))
    a1, a2 = np.array([0.95, 0.31]), np.array([0.31, 0.95])
    X = S1[..., None] * a1 + S2[..., None] * a2
    Y_true = np.stack([S1[..., None] * a1, S2[..., None] * a2])

    Q = 4
    trans = 0.85 * np.eye(Q) + 0.15 / (Q - 1) * (1 - np.eye(Q))
    spat = (SpatialComp(A=jnp.asarray([[0.87], [0.49]], jnp.float32)),
            SpatialComp(A=jnp.asarray([[0.52], [0.91]], jnp.float32)))
    spec = (
        SpectralComp(FB=jnp.asarray(0.5 + rng.random((F, Q)), jnp.float32),
                     TW=jnp.asarray(0.5 + rng.random((Q, N)), jnp.float32),
                     trans=jnp.asarray(trans if constraint == HMM
                                       else np.full(Q, 1.0 / Q), jnp.float32),
                     spat_ind=0, free=(True, False, True, False),
                     constraint=constraint),
        SpectralComp(FB=jnp.asarray(0.5 + rng.random((F, 3)), jnp.float32),
                     TW=jnp.asarray(0.5 + rng.random((3, N)), jnp.float32),
                     spat_ind=1),
    )
    return X, Y_true, FasstParams(spat=spat, spec=spec)


def _best_sdr(Y, Y_true):
    def sdr(est, ref):
        return 10 * np.log10(np.sum(np.abs(ref) ** 2)
                             / max(np.sum(np.abs(est - ref) ** 2), 1e-12))
    return max(min(sdr(Y[p[0]], Y_true[0]), sdr(Y[p[1]], Y_true[1]))
               for p in [(0, 1), (1, 0)])


def test_hmm_separation_end_to_end(rng):
    """Miniature BASELINE configs[3]: HMM spectral source + NMF noise."""
    X, Y_true, params = _hmm_problem(rng, HMM)
    Xj = jnp.asarray(X, jnp.complex64)
    cfg = GEMConfig(niter=80)
    params, ll = jax.block_until_ready(run_gem(params, Xj, cfg))
    assert bool(jnp.all(jnp.isfinite(ll)))
    _, sigma1 = annealing_endpoints(Xj, cfg)
    Y = np.asarray(separate_sources(params, Xj, sigma1))
    best = _best_sdr(Y, Y_true)
    assert best > 6.0, f"HMM separation SDR too low: {best:.2f} dB"


def test_gmm_separation_end_to_end(rng):
    X, Y_true, params = _hmm_problem(rng, GMM)
    Xj = jnp.asarray(X, jnp.complex64)
    cfg = GEMConfig(niter=80)
    params, ll = jax.block_until_ready(run_gem(params, Xj, cfg))
    assert bool(jnp.all(jnp.isfinite(ll)))
    _, sigma1 = annealing_endpoints(Xj, cfg)
    Y = np.asarray(separate_sources(params, Xj, sigma1))
    best = _best_sdr(Y, Y_true)
    assert best > 6.0, f"GMM separation SDR too low: {best:.2f} dB"


def test_hmm_spectral_templates_learn(rng):
    """Regression: free FB of a state model must be updated by its NMF rule
    (it was previously frozen at random init forever)."""
    X, Y_true, params = _hmm_problem(rng, HMM, F=32, N=40)
    Xj = jnp.asarray(X, jnp.complex64)
    FB0 = np.asarray(params.spec[0].FB).copy()
    params2, _ = jax.block_until_ready(run_gem(params, Xj,
                                               GEMConfig(niter=10)))
    FB1 = np.asarray(params2.spec[0].FB)
    rel_change = np.linalg.norm(FB1 - FB0) / np.linalg.norm(FB0)
    assert rel_change > 0.05, rel_change


def test_viterbi_path_matches_bruteforce(rng):
    """lax.scan Viterbi vs explicit max over all Q^N paths."""
    import itertools
    Q, N = 3, 7
    L = jnp.asarray(rng.standard_normal((Q, N)))
    trans = jnp.asarray(rng.dirichlet(np.ones(Q), size=Q))
    got = np.asarray(hmm_ops.viterbi_path(L, jnp.log(trans)))

    Lnp = np.asarray(L, np.float64)
    Tnp = np.log(np.asarray(trans, np.float64))
    best, best_path = -np.inf, None
    for path in itertools.product(range(Q), repeat=N):
        lp = -np.log(Q) + Lnp[path[0], 0]
        for n in range(1, N):
            lp += Tnp[path[n - 1], path[n]] + Lnp[path[n], n]
        if lp > best:
            best, best_path = lp, path
    assert list(got) == list(best_path)


def _state_switching_mixture():
    """Two sources with Markov-switching spectral states, nearly co-located
    (35 vs 60 degrees) so spatial cues barely help: the state structure is
    what identifies the sources (round-2 verdict item 6 -- configs[3] must
    prove state modelling beats plain NMF somewhere)."""
    fs = 16000
    T = 6 * fs
    t = np.arange(T) / fs
    rng = np.random.default_rng(42)

    def markov_states(dwell_s, n_states):
        out = np.zeros(T, int)
        pos = 0
        q = rng.integers(n_states)
        while pos < T:
            d = int(fs * rng.uniform(0.7 * dwell_s, 1.3 * dwell_s))
            out[pos:pos + d] = q
            pos += d
            q = (q + rng.integers(1, n_states)) % n_states
        return out

    def tone(f0, harmonics):
        x = sum(np.sin(2 * np.pi * f0 * h * t + rng.uniform(0, 2 * np.pi))
                / h for h in harmonics)
        return x / np.max(np.abs(x))

    def noiseband(lo, hi):
        x = rng.standard_normal(T)
        X = np.fft.rfft(x)
        f = np.fft.rfftfreq(T, 1 / fs)
        X[(f < lo) | (f > hi)] = 0
        x = np.fft.irfft(X, T)
        return x / np.max(np.abs(x))

    # templates deliberately overlap ACROSS sources (shared 500 Hz partial,
    # noise band covering source A's 990/1500/1650 Hz partials)
    TA = [tone(250, [2, 6, 10]), tone(330, [1, 3, 5])]
    TB = [tone(250, [2, 8, 14]), noiseband(900, 1800)]
    sA = np.where(markov_states(0.45, 2) == 0, TA[0], TA[1])
    sB = np.where(markov_states(0.6, 2) == 0, TB[0], TB[1])
    aA = np.array([np.cos(np.deg2rad(35)), np.sin(np.deg2rad(35))])
    aB = np.array([np.cos(np.deg2rad(60)), np.sin(np.deg2rad(60))])
    yA = sA[:, None] * aA
    yB = sB[:, None] * aB
    mix = (yA + yB).astype(np.float32)
    refs = np.stack([yA, yB]).mean(axis=2)
    return mix, refs, fs


def test_hmm_beats_nmf_on_state_structured_material():
    """MultiChanHMM (Viterbi decode) must beat an equal-K NMF model by
    >= 2 dB min-SDR on genuinely state-switching material."""
    from pyfasst_jax.models import MultiChanHMM, MultiChanNMFInst_FASST
    from pyfasst_jax.utils.metrics import bss_eval_sources

    mix, refs, fs = _state_switching_mixture()

    def min_sdr(model):
        model.estim_param_a_posteriori()
        ys = model.separated_images()
        return float(np.min(bss_eval_sources(
            ys.mean(axis=2), refs, filt_len=32)["sdr"]))

    kw = dict(fs=fs, wlen=512, iter_num=200, nbComps=2, seed=0)
    sdr_hmm = min_sdr(MultiChanHMM(mix, nbStates=2, sparsity="HMM",
                                   self_trans=0.97, decode="viterbi", **kw))
    sdr_nmf = min_sdr(MultiChanNMFInst_FASST(mix, nbNMFComps=2, **kw))
    assert sdr_hmm > 3.0, f"HMM min SDR too low: {sdr_hmm:.2f} dB"
    assert sdr_hmm > sdr_nmf + 2.0, \
        f"HMM ({sdr_hmm:.2f} dB) must beat NMF ({sdr_nmf:.2f} dB) by 2 dB"


def test_viterbi_decode_runs_in_gem(rng):
    """decode='viterbi' flows through the jitted GEM loop and separates."""
    X, Y_true, params = _hmm_problem(rng, HMM)
    spec = tuple(c.replace(decode="viterbi") if c.constraint == HMM else c
                 for c in params.spec)
    params = params.replace(spec=spec)
    Xj = jnp.asarray(X, jnp.complex64)
    cfg = GEMConfig(niter=80)
    params, ll = jax.block_until_ready(run_gem(params, Xj, cfg))
    assert bool(jnp.all(jnp.isfinite(ll)))
    _, sigma1 = annealing_endpoints(Xj, cfg)
    Y = np.asarray(separate_sources(params, Xj, sigma1))
    best = _best_sdr(Y, Y_true)
    assert best > 6.0, f"Viterbi-decode separation SDR too low: {best:.2f}"
