"""Config loader + dataset runner tests (synthetic on-disk fixtures)."""

import glob
import os
import subprocess
import sys

import numpy as np
import pytest

from monoorbslam3_tpu.config import build_camera, build_imu_calib, load_settings
from monoorbslam3_tpu.models.camera import Fisheye, Pinhole
from monoorbslam3_tpu.runners.datasets import (
    euroc_dataset, load_imu, load_times, run_sequence,
)

REF_STYLE_YAML = """%YAML:1.0
---
Camera:
  Width: 752
  Height: 480
  fps: 20
  CameraMatrix: !!opencv-matrix
    rows: 3
    cols: 3
    dt: f
    data: [ 458.654, 0, 367.215, 0, 457.296, 248.375, 0, 0, 1.0 ]
  Distortion: !!opencv-matrix
    rows: 4
    cols: 1
    dt: f
    data: [ -0.28340811, 0.07395907, 0.00019359, 1.76187114e-05 ]
  Distortion_Model: radtan
ORB:
  Features: 1000
IMU:
  NoiseGyro: 1.6968e-04
  WalkGyro: 1.9393e-05
  NoiseAcc: 2.0e-3
  WalkAcc: 3.0e-03
  Frequency: 200
  Rbc: !!opencv-matrix
    rows: 3
    cols: 3
    dt: f
    data: [ 1, 0, 0, 0, 1, 0, 0, 0, 1 ]
  tbc: !!opencv-matrix
    rows: 3
    cols: 1
    dt: f
    data: [ 0.01, 0.02, 0.03 ]
"""


def test_loads_opencv_style_yaml_with_underscore_quirk(tmp_path):
    """Reference-format YAML must parse, including the Distortion_Model
    spelling that the reference itself cannot load (SURVEY.md §5)."""
    p = tmp_path / "ref.yaml"
    p.write_text(REF_STYLE_YAML)
    s = load_settings(str(p))
    cam = build_camera(s)
    assert isinstance(cam, Pinhole)
    assert abs(float(cam.fx) - 458.654) < 1e-3
    calib = build_imu_calib(s)
    np.testing.assert_allclose(np.asarray(calib.t_bc), [0.01, 0.02, 0.03], atol=1e-6)


def test_shipped_profiles_parse():
    for name, klass in [("euroc", Pinhole), ("kitti", Pinhole),
                        ("tum_vi", Fisheye), ("phone", Pinhole)]:
        s = load_settings(f"settings/{name}.yaml")
        cam = build_camera(s)
        assert isinstance(cam, klass), name
        build_imu_calib(s)


def test_reference_settings_load_unchanged():
    import os
    ref = "/root/reference/settings/euroc.yaml"
    if not os.path.exists(ref):
        pytest.skip("reference not mounted")
    s = load_settings(ref)
    cam = build_camera(s)
    assert abs(float(cam.fx) - 458.654) < 1e-3


def _write_euroc_fixture(root, n_frames=6, fps=20.0, imu_hz=200.0):
    from PIL import Image

    rng = np.random.default_rng(0)
    (root / "cam0" / "data").mkdir(parents=True)
    times = np.arange(n_frames) / fps + 100.0
    (root / "cam0" / "times.txt").write_text(
        "".join(f"{t:.6f}\n" for t in times))
    small = rng.uniform(0, 255, (60, 94))
    img = np.kron(small, np.ones((8, 8)))[:480, :752].astype(np.uint8)
    for i in range(n_frames):
        Image.fromarray(img).save(root / "cam0" / "data" / ("%08d.png" % i))
    ts = np.arange(100.0 - 0.5, times[-1] + 0.01, 1.0 / imu_hz)
    lines = [f"{t:.6f} 0.001 0.002 0.003 0.1 0.2 9.7\n" for t in ts]
    (root / "imu.txt").write_text("".join(lines))
    return times


def test_euroc_loader_and_runner(tmp_path):
    times = _write_euroc_fixture(tmp_path)
    ds = euroc_dataset(str(tmp_path))
    assert len(ds) == 6
    frames = list(ds.frames())
    assert len(frames) == 6
    t0, img0, imu0 = frames[0]
    assert img0.shape == (480, 752)
    # imu rows strictly within (prev, t]
    t1, img1, imu1 = frames[1]
    assert imu1 is not None and (imu1[:, 0] > t0).all() and (imu1[:, 0] <= t1).all()

    # full-system smoke over the fixture (image path -> extractor -> tracker)
    from monoorbslam3_tpu.config import build_system

    system = build_system("settings/euroc.yaml",
                          config_overrides={"n_features": 256})
    states = run_sequence(system, ds, progress_every=0, log=lambda *a: None)
    assert len(states) == 6  # random texture: init may or may not succeed
    system.shutdown()


def test_kitti_loader_layout(tmp_path):
    """KITTI raw layout (kittiDemo.cpp:14-40): image_00/times.txt,
    image_00/data/%010d.png, oxts/imu.txt — parsed with correct IMU
    slicing per frame."""
    from PIL import Image

    from monoorbslam3_tpu.runners.datasets import kitti_dataset

    rng = np.random.default_rng(1)
    (tmp_path / "image_00" / "data").mkdir(parents=True)
    (tmp_path / "oxts").mkdir()
    fps, n = 10.0, 4
    times = np.arange(n) / fps + 50.0
    (tmp_path / "image_00" / "times.txt").write_text(
        "".join(f"{t:.6f}\n" for t in times))
    img = rng.integers(0, 255, (370, 1226), dtype=np.uint8)
    for i in range(n):
        Image.fromarray(img).save(
            tmp_path / "image_00" / "data" / ("%010d.png" % i))
    ts = np.arange(49.8, times[-1] + 0.01, 0.01)
    (tmp_path / "oxts" / "imu.txt").write_text(
        "".join(f"{t:.6f} 0.01 0.02 0.03 0.1 0.2 9.7\n" for t in ts))

    ds = kitti_dataset(str(tmp_path))
    assert len(ds) == n
    frames = list(ds.frames())
    t0, img0, imu0 = frames[0]
    assert img0.shape == (370, 1226)
    t1, _, imu1 = frames[1]
    assert imu1 is not None
    assert (imu1[:, 0] > t0).all() and (imu1[:, 0] <= t1).all()
    # ~10 IMU rows per 0.1 s frame at 100 Hz
    assert 8 <= len(imu1) <= 12


SETTINGS_FILES = sorted(
    os.path.basename(p) for p in glob.glob(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "settings", "*.yaml")))


@pytest.mark.parametrize("name", SETTINGS_FILES)
def test_settings_loader_matches_pyyaml(name):
    """The built-in settings parser reads every shipped profile; where
    PyYAML is installed it must agree with it exactly."""
    path = os.path.join("settings", name)
    s = load_settings(path)
    assert {"Camera", "ORB", "IMU"} <= set(s), name
    build_camera(s)
    build_imu_calib(s)
    yaml = pytest.importorskip("yaml")
    from monoorbslam3_tpu.config import _normalize_opencv_yaml

    with open(path) as f:
        assert s == yaml.safe_load(_normalize_opencv_yaml(f.read()))


def test_settings_loader_euroc_values():
    s = load_settings("settings/euroc.yaml")
    assert s["Camera"]["Width"] == 752 and s["Camera"]["fps"] == 20
    assert s["Camera"]["DistortionModel"] == "radtan"
    assert s["Camera"]["Distortion"] == [-0.28340811, 0.07395907,
                                         0.00019359, 1.76187114e-05]
    assert s["ORB"] == {"Features": 1024, "ScaleFactor": 1.2, "Levels": 8,
                        "IniThFAST": 20, "MinThFAST": 7}
    assert s["IMU"]["NoiseGyro"] == 1.6968e-04
    assert s["IMU"]["Frequency"] == 200
    # a flow list continued over three lines
    assert len(s["IMU"]["Rbc"]) == 9
    assert s["IMU"]["Rbc"][3] == 0.999557249008
    assert s["IMU"]["tbc"] == [-0.0216401454975, -0.064676986768,
                               0.00981073058949]


def test_settings_loader_needs_no_pyyaml():
    """The main path (config -> build_system) imports without PyYAML."""
    code = ("import sys; sys.modules['yaml'] = None\n"
            "import monoorbslam3_tpu.config as c\n"
            "s = c.load_settings('settings/synthetic.yaml')\n"
            "assert s['System']['local_k'] == 40\n"
            "assert 'yaml' not in [m for m, v in sys.modules.items() if v]\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_settings_loader_rejects_unsupported_yaml(tmp_path):
    from monoorbslam3_tpu.config import parse_settings_yaml

    for text in ("Camera:\n  - 1\n  - 2\n", "A: [1, [2]]\n", "A: {b: 1}\n",
                 "A: [1, 2\n"):
        with pytest.raises(ValueError):
            parse_settings_yaml(text)
