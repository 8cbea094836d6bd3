"""CLI (`python -m pyfasst_jax`) end-to-end on tiny clips."""
import json
import os

import numpy as np
import pytest

from pyfasst_jax.__main__ import main
from pyfasst_jax.audio import wavwrite


@pytest.fixture
def mix_wav(tmp_path, rng):
    fs = 8000
    t = np.arange(fs) / fs
    s1 = 0.5 * np.sin(2 * np.pi * 440 * t)
    s2 = 0.3 * rng.standard_normal(fs)
    mix = np.stack([0.9 * s1 + 0.3 * s2, 0.3 * s1 + 0.9 * s2], 1)
    p = str(tmp_path / "mix.wav")
    wavwrite(mix, fs, p)
    return p


def test_info(mix_wav, capsys):
    assert main(["info", mix_wav]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["samplerate"] == 8000 and out["channels"] == 2


def test_separate_inst(mix_wav, tmp_path, capsys):
    out_dir = str(tmp_path / "sep")
    assert main(["separate", mix_wav, "-o", out_dir, "--iters", "8",
                 "--nmf-comps", "3", "--wlen", "256", "-q"]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(rep["files"]) == 2
    for f in rep["files"]:
        assert os.path.exists(f)
    assert np.isfinite(rep["final_loglik"])


@pytest.mark.parametrize("front_end", ["erblet", "cqlet"])
def test_separate_warped_transform(mix_wav, tmp_path, capsys, front_end):
    out_dir = str(tmp_path / "sep")
    assert main(["separate", mix_wav, "-o", out_dir, "--iters", "8",
                 "--nmf-comps", "3", "--transform", front_end,
                 "--tf-bands", "24", "-q"]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(rep["files"]) == 2
    for f in rep["files"]:
        assert os.path.exists(f)
    assert np.isfinite(rep["final_loglik"])


def test_separate_streaming_cli(mix_wav, tmp_path, capsys):
    out_dir = str(tmp_path / "stream")
    assert main(["separate", mix_wav, "-o", out_dir, "--streaming",
                 "--block-frames", "16", "--wlen", "256",
                 "--nmf-comps", "3", "-q"]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(rep["files"]) == 2 and rep["blocks"] >= 2
    for f in rep["files"]:
        assert os.path.exists(f)
    assert np.isfinite(rep["final_loglik"])


def test_separate_streaming_cli_rejects_warped(mix_wav, tmp_path, capsys):
    assert main(["separate", mix_wav, "--streaming",
                 "--transform", "erblet", "-q"]) == 2
    assert "STFT front-end" in capsys.readouterr().err


def test_separate_streaming_cli_fullrank(mix_wav, tmp_path, capsys):
    """`--streaming --model fullrank` drives the online Duong path."""
    out_dir = str(tmp_path / "stream_fr")
    assert main(["separate", mix_wav, "-o", out_dir, "--streaming",
                 "--model", "fullrank", "--block-frames", "16",
                 "--wlen", "256", "--nmf-comps", "3", "-q"]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(rep["files"]) == 2 and rep["blocks"] >= 2
    for f in rep["files"]:
        assert os.path.exists(f)
    assert np.isfinite(rep["final_loglik"])


def test_separate_streaming_cli_rejects_other_models(mix_wav, capsys):
    assert main(["separate", mix_wav, "--streaming",
                 "--model", "hmm", "-q"]) == 2
    assert "fullrank" in capsys.readouterr().err


def test_separate_checkpoint(mix_wav, tmp_path, capsys):
    ck = str(tmp_path / "ck.npz")
    assert main(["separate", mix_wav, "-o", str(tmp_path / "s"),
                 "--iters", "4", "--wlen", "256", "-q",
                 "--checkpoint", ck]) == 0
    from pyfasst_jax.utils.checkpoint import load_params
    _, it, _ = load_params(ck)
    assert it == 4


def test_demix_command(mix_wav, capsys):
    assert main(["demix", mix_wav, "--sources", "2", "--wlen", "256"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["sources"] == 2 and len(out["gains"]) == 2


def test_lead_command(mix_wav, tmp_path, capsys):
    assert main(["lead", mix_wav, "-o", str(tmp_path / "l"),
                 "--iters", "4", "--wlen", "256", "--n-f0", "24"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert len(rep["files"]) == 2


def test_separate_batch_directory(tmp_path, rng, capsys):
    """`separate --batch dir/` separates variable-length clips via the
    bucketed batch path (VERDICT round-1 item #10 / configs[4] user story)."""
    fs = 8000
    clip_dir = tmp_path / "clips"
    clip_dir.mkdir()
    for name, dur in (("a", 0.6), ("b", 1.0), ("c", 1.4)):
        t = np.arange(int(fs * dur)) / fs
        s1 = 0.5 * np.sin(2 * np.pi * 440 * t)
        s2 = 0.3 * rng.standard_normal(len(t))
        mix = np.stack([0.9 * s1 + 0.3 * s2, 0.3 * s1 + 0.9 * s2], 1)
        wavwrite(mix, fs, str(clip_dir / f"{name}.wav"))
    out_dir = str(tmp_path / "sep")
    assert main(["separate", str(clip_dir), "--batch", "-o", out_dir,
                 "--iters", "6", "--nmf-comps", "3", "--wlen", "256",
                 "-q"]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["clips"] == 3
    for stem in ("a", "b", "c"):
        files = rep["results"][stem]["files"]
        assert len(files) == 2
        for f in files:
            assert os.path.exists(f)
        assert np.isfinite(rep["results"][stem]["final_loglik"])
    # cropped back to true lengths: stems must match their mixture length
    from pyfasst_jax.audio import wavread
    for stem, dur in (("a", 0.6), ("b", 1.0), ("c", 1.4)):
        est, _ = wavread(rep["results"][stem]["files"][0])
        assert est.shape[0] == int(fs * dur)


def test_missing_file_is_clean_error(capsys):
    assert main(["separate", "no_such_file.wav", "-q"]) == 2
    assert "error:" in capsys.readouterr().err


def test_separate_hmm_and_gsmm(mix_wav, tmp_path, capsys):
    for model in ("hmm", "gsmm"):
        out_dir = str(tmp_path / model)
        assert main(["separate", mix_wav, "-o", out_dir, "--model", model,
                     "--states", "3", "--iters", "6", "--wlen", "256",
                     "-q"]) == 0
        rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert len(rep["files"]) == 2 and np.isfinite(rep["final_loglik"])


def test_separate_fullrank_erb(mix_wav, tmp_path, capsys):
    out_dir = str(tmp_path / "fr")
    assert main(["separate", mix_wav, "-o", out_dir, "--model", "fullrank",
                 "--freq-basis", "erb", "--bands", "12", "--iters", "6",
                 "--wlen", "256", "-q"]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(rep["files"]) == 2 and np.isfinite(rep["final_loglik"])


def test_separate_fullrank_spatial_init(mix_wav, tmp_path, capsys):
    out_dir = str(tmp_path / "si")
    assert main(["separate", mix_wav, "-o", out_dir, "--model", "fullrank",
                 "--spatial-init", "--iters", "6", "--nmf-comps", "3",
                 "--wlen", "256", "-q"]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(rep["files"]) == 2 and np.isfinite(rep["final_loglik"])


def test_separate_reseed_pipeline(mix_wav, tmp_path, capsys):
    """--spatial-init --reseed N runs the blind reverberant pipeline."""
    out_dir = str(tmp_path / "rp")
    assert main(["separate", mix_wav, "-o", out_dir, "--model", "fullrank",
                 "--spatial-init", "--reseed", "1", "--iters", "8",
                 "--nmf-comps", "3", "--wlen", "256", "-q"]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(rep["files"]) == 2 and np.isfinite(rep["final_loglik"])
    assert rep["stages"] and isinstance(rep["picked"], str)


def test_separate_reseed_pipeline_guarded(mix_wav, tmp_path, capsys):
    """--select consistency --reseed-select envcorr: consistency pool
    selection with envcorr-guarded reseed acceptance (design.md §6g)."""
    out_dir = str(tmp_path / "rg")
    assert main(["separate", mix_wav, "-o", out_dir, "--model", "fullrank",
                 "--spatial-init", "--reseed", "1", "--iters", "8",
                 "--nmf-comps", "3", "--wlen", "256", "-q",
                 "--select", "consistency",
                 "--reseed-select", "envcorr"]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(rep["files"]) == 2 and np.isfinite(rep["final_loglik"])


def test_separate_multiscale_ladder(mix_wav, tmp_path, capsys):
    """--multiscale-wlen W runs the fine->coarse ladder; W must be finer
    than --wlen."""
    out_dir = str(tmp_path / "ms")
    assert main(["separate", mix_wav, "-o", out_dir, "--model", "fullrank",
                 "--spatial-init", "--reseed", "1", "--multiscale-wlen",
                 "64", "--iters", "8", "--nmf-comps", "3",
                 "--wlen", "256", "-q"]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(rep["files"]) == 2 and np.isfinite(rep["final_loglik"])
    assert rep["picked"].split("|")[0].startswith(("ladder", "reseed"))
    assert main(["separate", mix_wav, "-o", str(tmp_path / "y"),
                 "--model", "fullrank", "--spatial-init", "--reseed", "1",
                 "--multiscale-wlen", "256", "--wlen", "256",
                 "--iters", "4", "-q"]) == 2
    assert "finer" in capsys.readouterr().err


def test_preset_applies_operating_point():
    """--preset overwrites the listed knobs wholesale (the measured
    operating points of tools/speech_sweep.py; values themselves are
    data-driven and live in _PRESETS)."""
    import argparse

    from pyfasst_jax.__main__ import _PRESETS, _apply_preset

    ns = argparse.Namespace(preset="speech", model="inst", wlen=1024,
                            iters=200, multiscale_wlen=None,
                            spatial_init=False, reseed=-1, nmf_comps=8)
    _apply_preset(ns)
    # reseed >= 0 triggers the pool pipeline (0 = pool+selection, no
    # reseeds -- the measured speech operating point, design.md §6g/§6j)
    assert ns.model == "fullrank" and ns.spatial_init and ns.reseed >= 0
    assert ns.select == "learned" and ns.band_em and ns.learned
    for name, cfg in _PRESETS.items():
        assert cfg["model"] == "fullrank" and cfg["spatial_init"], name
        assert cfg["reseed"] >= 0, name


def test_reseed_pipeline_over_warped_transform(mix_wav, tmp_path, capsys):
    """Round 5 (VERDICT r4 weak-6): the FLAT reseed pipeline composes
    with warped front-ends — estim_param_blind_reverb runs on the
    model's own plane, whatever the transform — so the CLI's blanket
    STFT-only raise is gone. Only the multiscale ladder still requires
    an STFT front-end (it builds its own fine/coarse STFT grids)."""
    assert main(["separate", mix_wav, "-o", str(tmp_path / "x"),
                 "--model", "fullrank", "--spatial-init", "--reseed", "1",
                 "--transform", "erblet", "--tf-bands", "16",
                 "--iters", "4", "--nmf-comps", "3", "-q"]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(rep["files"]) == 2
    assert np.isfinite(rep["final_loglik"])
    assert main(["separate", mix_wav, "-o", str(tmp_path / "y"),
                 "--model", "fullrank", "--spatial-init", "--reseed", "1",
                 "--multiscale-wlen", "256",
                 "--transform", "erblet", "--iters", "4", "-q"]) == 2
    assert "STFT front-end" in capsys.readouterr().err


def test_eval_command(mix_wav, tmp_path, capsys):
    """Scoring estimated stems vs references through the CLI."""
    # trivial case: estimates == references -> near-perfect SDR
    from pyfasst_jax.audio import wavread, wavwrite
    data, sr = wavread(mix_wav)
    a = str(tmp_path / "a.wav")
    b = str(tmp_path / "b.wav")
    wavwrite(data * 0.8, sr, a)
    wavwrite(np.roll(data, 1, axis=0) * 0.5 + 0.01 * data, sr, b)
    assert main(["eval", "-e", b, a, "-r", a, b]) == 0
    rep = json.loads(capsys.readouterr().out)
    # swapped estimates: permutation recovered, SDR high (gain/shift are
    # within the allowed-distortion filters)
    assert rep["permutation"] == [1, 0]
    assert all(s > 20 for s in rep["sdr_db"])


def test_eval_count_mismatch_is_clean(mix_wav, capsys):
    assert main(["eval", "-e", mix_wav, "-r", mix_wav, mix_wav]) == 2
    assert "estimates vs" in capsys.readouterr().err


def test_separate_fullrank_spatial_init_over_erblet(mix_wav, tmp_path,
                                                    capsys):
    """Blind spatial-cluster init composed with a warped front-end: the
    consensus clustering runs on the erblet coefficients and the engine
    separates in that domain."""
    out_dir = str(tmp_path / "sep")
    assert main(["separate", mix_wav, "-o", out_dir, "--model", "fullrank",
                 "--spatial-init", "--transform", "erblet", "--tf-bands",
                 "24", "--iters", "8", "--nmf-comps", "3", "-q"]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(rep["files"]) == 2
    assert np.isfinite(rep["final_loglik"])


def test_batch_rejects_warped_transform(tmp_path, capsys):
    d = tmp_path / "clips"
    d.mkdir()
    assert main(["separate", str(d), "--batch",
                 "--transform", "erblet"]) == 2
    assert "STFT front-end" in capsys.readouterr().err
