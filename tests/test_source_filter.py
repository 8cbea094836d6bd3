"""multiChanSourceF0Filter (true multiplicative SIMM inside the GEM engine)."""
import numpy as np
import jax
import jax.numpy as jnp

from pyfasst_jax.models.components import FasstParams, SpatialComp, SpectralComp
from pyfasst_jax.models.variants import generate_WF0
from pyfasst_jax.ops.gem import annealing_endpoints, run_gem
from pyfasst_jax.ops.wiener import separate_sources
from pyfasst_jax.utils.config import GEMConfig


def test_simm_component_power_and_updates(rng):
    F, N, U, G = 40, 30, 12, 5
    comp = SpectralComp(
        FB=jnp.asarray(0.1 + rng.random((F, U)), jnp.float32),
        TW=jnp.asarray(0.5 + rng.random((U, N)), jnp.float32),
        FB2=jnp.asarray(0.1 + rng.random((F, G)), jnp.float32),
        TW2=jnp.asarray(0.5 + rng.random((G, N)), jnp.float32),
        free=(False, False, True, False), free2=(False, True))
    v = np.asarray(comp.power())
    want = (np.asarray(comp.FB) @ np.asarray(comp.TW)) * \
        (np.asarray(comp.FB2) @ np.asarray(comp.TW2))
    np.testing.assert_allclose(v, want, rtol=1e-5)

    # IS divergence decreases under the SIMM updates against a random target
    from pyfasst_jax.ops.mstep import _simm_factor_updates
    P = jnp.asarray(0.5 + rng.random((F, N)), jnp.float32)

    def is_div(c):
        V = np.maximum(np.asarray(c.power()), 1e-12)
        Pn = np.asarray(P)
        return float(np.sum(Pn / V - np.log(Pn / V) - 1))

    d0 = is_div(comp)
    c = comp
    V = c.power()
    for _ in range(15):
        c, V = _simm_factor_updates(c, P, V, 1e-30)
    assert is_div(c) < 0.6 * d0


def test_source_filter_model_end_to_end(rng):
    """Harmonic lead (vibrato) + broadband noise, panned apart, using the
    SIMM lead component inside the full GEM engine."""
    fs, wlen = 16000, 512
    F, N = wlen // 2 + 1, 80
    # build TF-domain lead: harmonic comb sweeping over the F0 grid
    WF0 = generate_WF0(F, fs, wlen, n_f0=40, f0_min=150, f0_max=350)
    f0_path = (20 + 10 * np.sin(np.linspace(0, 4, N))).astype(int)
    lead_psd = WF0[:, f0_path] * 40.0
    S1 = np.sqrt(lead_psd) * (rng.standard_normal((F, N))
                              + 1j * rng.standard_normal((F, N)))
    S2 = 0.5 * (rng.standard_normal((F, N)) + 1j * rng.standard_normal((F, N)))
    a1, a2 = np.array([0.95, 0.31]), np.array([0.31, 0.95])
    X = S1[..., None] * a1 + S2[..., None] * a2
    Y_true = np.stack([S1[..., None] * a1, S2[..., None] * a2])

    lead = SpectralComp(
        FB=jnp.asarray(WF0, jnp.float32),
        TW=jnp.asarray(0.5 + rng.random((40, N)), jnp.float32),
        FB2=jnp.asarray(np.ones((F, 1)) / F, jnp.float32),
        TW2=jnp.asarray(np.ones((1, N)), jnp.float32),
        spat_ind=0, free=(False, False, True, False), free2=(False, True))
    acc = SpectralComp(
        FB=jnp.asarray(0.5 + rng.random((F, 4)), jnp.float32),
        TW=jnp.asarray(0.5 + rng.random((4, N)), jnp.float32), spat_ind=1)
    params = FasstParams(
        spat=(SpatialComp(A=jnp.asarray([[0.87], [0.49]], jnp.float32)),
              SpatialComp(A=jnp.asarray([[0.52], [0.91]], jnp.float32))),
        spec=(lead, acc))

    Xj = jnp.asarray(X, jnp.complex64)
    cfg = GEMConfig(niter=100)
    params, ll = jax.block_until_ready(run_gem(params, Xj, cfg))
    assert bool(jnp.all(jnp.isfinite(ll)))
    _, sigma1 = annealing_endpoints(Xj, cfg)
    Y = np.asarray(separate_sources(params, Xj, sigma1))

    def sdr(e, r):
        return 10 * np.log10(np.sum(np.abs(r) ** 2)
                             / max(np.sum(np.abs(e - r) ** 2), 1e-12))

    best = max(min(sdr(Y[p[0]], Y_true[0]), sdr(Y[p[1]], Y_true[1]))
               for p in [(0, 1), (1, 0)])
    assert best > 8.0, f"source-filter separation SDR too low: {best:.2f}"


def test_init_from_lead_pipeline(rng, tmp_path):
    """Reference flow: the SeparateLeadStereo pipeline seeds the
    source-filter model's F0/envelope activations (melody-constrained),
    and estimation proceeds from there."""
    import scipy.io.wavfile as wavfile
    from pyfasst_jax.models.variants import multiChanSourceF0Filter

    fs = 8000
    t = np.arange(fs) / fs
    lead = np.sin(2 * np.pi * 220 * t) + 0.5 * np.sin(2 * np.pi * 440 * t)
    acc = 0.4 * rng.standard_normal(fs)
    mix = np.stack([0.9 * lead + 0.4 * acc, 0.4 * lead + 0.9 * acc], 1)
    p = str(tmp_path / "m.wav")
    wavfile.write(p, fs, (mix / np.abs(mix).max() * 2 ** 14).astype(np.int16))

    # no_ann for the loglik comparison: under annealing, sigma changes per
    # iteration and the LAST linear step at small niter drops it ~100x at
    # once, so ll[-1] vs ll[0] is not meaningful there (verified benign:
    # random init shows the same final-step dip, and it vanishes at
    # realistic iteration counts).
    model = multiChanSourceF0Filter(p, nbComps=2, nbNMFComps=3, wlen=512,
                                    n_f0=40, f0_min=100, f0_max=600,
                                    iter_num=20, annealing="no_ann",
                                    init_from_lead=True, lead_iters=6)
    assert model.lead_melody is not None
    # the init must carry the lead pipeline's F0 activations, which must be
    # concentrated (melody-constrained: zero outside the Viterbi corridor)
    TW = np.asarray(model.params.spec[0].TW)
    frac_active = np.mean(TW > 1e-3 * TW.max())
    assert frac_active < 0.5, frac_active
    ll = model.estim_param_a_posteriori()
    assert np.all(np.isfinite(ll)) and ll[-1] > ll[0]
