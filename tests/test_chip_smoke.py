"""chip_smoke.py: its device check, and its phase-b/c comparison functions
at small widths on the CPU. The full-width run needs a GPU."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_BA = dict(n_kf=6, n_fixed=2, n_pts=96, obs_per_kf=24)


def test_refuses_to_run_without_a_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "no GPU" in out.stderr


@pytest.mark.parametrize("N,M", [(64, 48), (96, 160)])
def test_projected_match_check(N, M):
    res = chip_smoke.check_projected_match(N, M, seed=3)
    assert res["bit_identical"] and res["matches"] > 0, res


def test_entry_check_on_a_rendered_frame():
    res = chip_smoke.check_entry(240, 376, n_features=256, min_inliers=60)
    assert res["ok"], res
    assert res["inliers"] == res["inliers_cpu"] and res["pose_max_diff"] == 0


def test_patch_gather_check_at_euroc_atlas():
    res = chip_smoke.check_patch_gather(480, 752, n_features=256)
    assert res["bit_identical"], res
    assert res["atlas"] == "2274x1024"


def test_assembly_sums_check():
    res = chip_smoke.check_assembly_sums(SMALL_BA)
    assert res["ok"], res


@pytest.mark.parametrize("layout", ["flat", "grouped"])
def test_schur_ba_check(layout):
    res = chip_smoke.check_schur_ba(layout, SMALL_BA)
    assert res["ok"], res


def test_four_card_checks_on_virtual_devices():
    devices = jax.devices()[:4]
    ba = chip_smoke.check_sharded_ba(
        devices, dict(n_kf=6, n_fixed=2, n_pts=128, obs_per_kf=32))
    assert ba["ok"], ba
    ext = chip_smoke.check_batch_extract(devices, 96, 128, n_features=64,
                                         per_card=1)
    assert ext["ok"] and ext["identical_share"] == 1.0, ext


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run: python chip_smoke.py)")


@pytest.mark.gpu
def test_full_width_checks_on_gpu(gpu):
    res = chip_smoke.phase_b()
    assert res["pass"], res
