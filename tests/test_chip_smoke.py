"""chip_smoke.py on the CPU: its phase functions at tiny width, and its
refusal to run without a GPU."""
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

DUR = 0.3          # 0.3 s clips: a 513 x 27 plane


def test_refuses_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_require_gpu_exits_on_cpu():
    with pytest.raises(SystemExit) as e:
        chip_smoke.require_gpu(1)
    assert e.value.code not in (0, None)


def test_min_sdr_is_permutation_best():
    rng = np.random.default_rng(0)
    ys = rng.standard_normal((2, 100, 2))
    noisy = ys + 1e-3 * rng.standard_normal(ys.shape)
    assert chip_smoke.min_sdr(noisy[::-1], ys) == pytest.approx(
        chip_smoke.min_sdr(noisy, ys))
    assert chip_smoke.min_sdr(noisy, ys) > 50


def test_late_drop_and_clip_gate():
    rising = np.linspace(-100.0, -10.0, 20)
    assert chip_smoke.late_drop(rising) == 0.0
    dipping = rising.copy()
    dipping[-2] = -5.0
    assert chip_smoke.late_drop(dipping) == pytest.approx(0.5)
    chip_smoke.check_clip("ok", rising, 70.0)
    with pytest.raises(AssertionError):
        chip_smoke.check_clip("low sdr", rising, 10.0)
    with pytest.raises(AssertionError):
        chip_smoke.check_clip("nan", np.r_[rising, np.nan], 70.0)


def test_phase_api_and_cli_tiny(tmp_path):
    api = chip_smoke.phase_api(str(tmp_path), niter=3, dur=DUR)
    assert api["plane"][0] == 513
    assert np.all(np.isfinite(api["loglik"])) and np.isfinite(api["sdr"])
    cli = chip_smoke.phase_cli(str(tmp_path), niter=3, dur=DUR)
    assert np.isfinite(cli["final_loglik"]) and np.isfinite(cli["sdr"])


def test_phase_batch_tiny():
    res = chip_smoke.phase_batch(n_clips=3, niter=3, dur=DUR)
    assert len(res["loglik"]) == len(res["sdr"]) == 3
    assert all(np.all(np.isfinite(ll)) for ll in res["loglik"])


def test_phase_kernel_tiny_interpret():
    res = chip_smoke.phase_kernel(interpret=True, dur=DUR, n_batch=2)
    assert set(res) == {"ranks11_real", "ranks22_complex",
                        "ranks22_complex_ns_inj", "batch2_ranks11_real"}
    for errs in res.values():
        assert max(errs.values()) < chip_smoke.KERNEL_RTOL


def test_phase_cpu_tiny():
    res = chip_smoke.phase_cpu(niter=3, dur=DUR)
    assert res["loglik_dev"].shape == (3,)
    assert res["rel"] <= chip_smoke.TRAJ_RTOL
