"""Settings loader + system factory.

Analog of the reference's YAML config layer (System.cpp:21-68):
per-dataset profiles with Camera/ORB/IMU/View nodes. Differences:

- parses BOTH plain YAML and the reference's OpenCV-style YAML
  (`%YAML:1.0` directive + `!!opencv-matrix` tags are normalized away), so
  the reference's own settings files load unchanged. The parser is a small
  one for the subset settings files use (see `parse_settings_yaml`), so
  loading settings needs no YAML package;
- accepts `DistortionModel` AND `Distortion_Model` — the reference reads
  only the former (Camera.cpp:41) while three of its shipped yamls spell it
  with the underscore (phone/kaist_vio/rect_tum), making those profiles
  unloadable there; we fix the quirk rather than reproduce it
  (SURVEY.md §5 config);
- the factory returns immutable pytree objects, not singletons.
"""

from __future__ import annotations

import re

import numpy as np

from .models.camera import Fisheye, Pinhole
from .models.imu import ImuCalib


def _normalize_opencv_yaml(text: str) -> str:
    text = re.sub(r"^%YAML:[\d.]+\s*\n(---\s*\n)?", "", text)
    text = text.replace("!!opencv-matrix", "")
    return text


_KEY_LINE = re.compile(r"^(?P<key>[^:\s][^:]*?)\s*:(?:\s+(?P<val>.*))?$")
_INT = re.compile(r"^[-+]?[0-9]+$")


def _strip_comment(line: str) -> str:
    """Drops a `#` comment that starts a line or follows whitespace,
    outside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _scalar(tok: str):
    tok = tok.strip()
    if len(tok) >= 2 and tok[0] == tok[-1] and tok[0] in "'\"":
        return tok[1:-1]
    if tok in ("", "~", "null", "Null", "NULL"):
        return None
    if tok in ("true", "True", "TRUE"):
        return True
    if tok in ("false", "False", "FALSE"):
        return False
    if _INT.match(tok):
        return int(tok)
    try:
        return float(tok)
    except ValueError:
        return tok


def _value(tok: str):
    tok = tok.strip()
    if tok.startswith("["):
        if not tok.endswith("]") or "[" in tok[1:-1] or "{" in tok:
            raise ValueError(f"unsupported flow sequence: {tok!r}")
        inner = tok[1:-1].strip()
        return [_scalar(t) for t in inner.split(",")] if inner else []
    if tok.startswith(("{", "- ", "&", "*", "|", ">")) or tok == "-":
        raise ValueError(f"unsupported YAML construct: {tok!r}")
    return _scalar(tok)


def parse_settings_yaml(text: str) -> dict:
    """Parses the YAML subset that settings files use: nested block
    mappings by indentation, scalars (int, float, bool, null, plain or
    quoted strings), `#` comments, and flat flow lists that may continue
    over several lines. Anything else raises ValueError."""
    lines = []  # (indent, content) with multi-line flow lists joined
    pending = None
    for raw in text.splitlines():
        line = _strip_comment(raw).rstrip()
        if pending is not None:
            pending[1] += " " + line.strip()
            if pending[1].count("[") == pending[1].count("]"):
                lines.append(tuple(pending))
                pending = None
            continue
        if not line.strip() or line.strip() == "---":
            continue
        if "\t" in line[: len(line) - len(line.lstrip())]:
            raise ValueError(f"tab indentation: {raw!r}")
        entry = [len(line) - len(line.lstrip()), line.strip()]
        if entry[1].count("[") != entry[1].count("]"):
            pending = entry
        else:
            lines.append(tuple(entry))
    if pending is not None:
        raise ValueError(f"unterminated flow sequence: {pending[1]!r}")

    root: dict = {}
    stack = [(-1, root)]  # (indent, mapping) of the open mappings
    open_key = None  # (indent, parent, key) of a `key:` with no value yet
    for indent, content in lines:
        if open_key is not None:
            k_indent, k_parent, k_name = open_key
            open_key = None
            if indent > k_indent:
                k_parent[k_name] = {}
                stack.append((k_indent, k_parent[k_name]))
        while indent <= stack[-1][0]:
            stack.pop()
        m = _KEY_LINE.match(content)
        if m is None:
            raise ValueError(f"unsupported settings line: {content!r}")
        parent = stack[-1][1]
        key = m.group("key").strip()
        val = m.group("val")
        if val is None or not val.strip():
            parent[key] = None
            open_key = (indent, parent, key)
        else:
            parent[key] = _value(val)
    return root


def _as_matrix(node):
    """OpenCV-matrix node or plain list -> numpy array."""
    if isinstance(node, dict) and "data" in node:
        arr = np.asarray(node["data"], np.float64)
        r, c = int(node.get("rows", len(arr))), int(node.get("cols", 1))
        return arr.reshape(r, c)
    return np.asarray(node, np.float64)


def load_settings(path: str) -> dict:
    with open(path) as f:
        text = f.read()
    return parse_settings_yaml(_normalize_opencv_yaml(text))


def build_camera(settings: dict):
    cam = settings["Camera"]
    K = _as_matrix(cam["CameraMatrix"]).reshape(3, 3)
    dist = _as_matrix(cam.get("Distortion", [0, 0, 0, 0])).reshape(-1)
    model = (cam.get("DistortionModel") or cam.get("Distortion_Model") or "radtan")
    width, height = int(cam["Width"]), int(cam["Height"])
    if model == "radtan":
        return Pinhole.create(K[0, 0], K[1, 1], K[0, 2], K[1, 2],
                              dist=dist, width=width, height=height)
    if model == "equidistant":
        return Fisheye.create(K[0, 0], K[1, 1], K[0, 2], K[1, 2],
                              dist=dist[:4], width=width, height=height)
    raise ValueError(f"unknown distortion model {model!r}")


def build_imu_calib(settings: dict) -> ImuCalib:
    imu = settings["IMU"]
    if "Rcb" in imu:
        R_cb = _as_matrix(imu["Rcb"]).reshape(3, 3)
        t_cb = _as_matrix(imu["tcb"]).reshape(3)
        R_bc = R_cb.T
        t_bc = -R_bc @ t_cb
    else:
        R_bc = _as_matrix(imu["Rbc"]).reshape(3, 3)
        t_bc = _as_matrix(imu["tbc"]).reshape(3)
    return ImuCalib.create(
        R_bc=R_bc, t_bc=t_bc,
        noise_gyro=float(imu["NoiseGyro"]), noise_acc=float(imu["NoiseAcc"]),
        walk_gyro=float(imu["WalkGyro"]), walk_acc=float(imu["WalkAcc"]),
        bg0=_as_matrix(imu.get("GyroBias", [0, 0, 0])).reshape(3),
        ba0=_as_matrix(imu.get("AccBias", [0, 0, 0])).reshape(3),
        freq=float(imu.get("Frequency", 200.0)),
    )


def build_vocabulary(settings: dict, vocab_path: str | None = None,
                     base_dir: str | None = None):
    """Optional vocabulary from the `Vocabulary` settings node (a path or
    `{File: path, GroupLevel: l}`) or an explicit path argument — the
    ORBVocabulary::createORBVocabulary analog (System.cpp:39). Returns None
    when unset: matching is dense without a vocabulary. A relative
    `File:` resolves against the settings file's directory (`base_dir`)."""
    import os

    from .ops.vocab import load_dbow2_text

    node = settings.get("Vocabulary")
    group_level = 1
    if isinstance(node, dict):
        group_level = int(node.get("GroupLevel", 1))
        node = node.get("File")
    path = vocab_path or node
    if not path:
        return None
    path = str(path)
    if base_dir and not os.path.isabs(path) and not os.path.exists(path):
        path = os.path.join(base_dir, path)
    return load_dbow2_text(path, group_level=group_level)


def build_system(settings_path: str, use_extractor: bool = True,
                 config_overrides: dict | None = None,
                 vocab_path: str | None = None,
                 viewer_dir: str | None = None,
                 async_mapper: bool = False):
    """System factory from a settings file (the System constructor analog,
    System.cpp:19-68)."""
    from .ops.orb import OrbExtractor
    from .system import System

    settings = load_settings(settings_path)
    camera = build_camera(settings)
    calib = build_imu_calib(settings)
    orb = settings.get("ORB", {})
    n_feat = int(orb.get("Features", 1024))
    cfg = {"n_features": n_feat, "fps": float(settings["Camera"].get("fps", 20))}
    # optional `System:` node: tracker/mapper policy knobs (init gates, KF
    # policy, local-window capacities, ...) configurable per dataset profile
    # — the yaml-driven analog of the reference's hardcoded Tracking.cpp
    # thresholds; caller overrides still win
    cfg.update(settings.get("System") or {})
    cfg.update(config_overrides or {})
    extractor = init_extractor = None
    if use_extractor:
        ext_args = dict(
            n_levels=int(orb.get("Levels", 8)),
            scale=float(orb.get("ScaleFactor", 1.2)),
            ini_th_fast=float(orb.get("IniThFAST", 20)),
            min_th_fast=float(orb.get("MinThFAST", 7)),
        )
        extractor = OrbExtractor(camera.height, camera.width,
                                 n_features=n_feat, **ext_args)
        # the reference doubles features during monocular initialization
        # (initial_extractor = new ORBExtractor(2 * nFeatures, ...),
        # Tracking.cpp:24); init_features_mult <= 1 disables. DEFAULT OFF:
        # A/B-measured on the rendered circle world, doubling the per-cell
        # top-k admits weak corners whose 0.05 s-baseline triangulations
        # carry 25-45% depth error (bad-depth fraction 18% -> 29%), and
        # the young map then over-rotates to divergence (STATUS.md r3).
        # The reference's quadtree re-selects the strongest corner per
        # region at any capacity, so its 2x setting does not degrade
        # per-corner quality the same way.
        mult = int(cfg.get("init_features_mult", 1))
        if mult > 1:
            init_extractor = OrbExtractor(camera.height, camera.width,
                                          n_features=mult * n_feat, **ext_args)
            # the oversized init population needs the conditioning gate
            # (tracking.init_max_rel_sigma) to keep its bad-depth fraction
            # at the 1x level — pair them unless explicitly overridden
            cfg.setdefault("init_max_rel_sigma", 0.12)
    import os

    vocab = build_vocabulary(settings, vocab_path,
                             base_dir=os.path.dirname(
                                 os.path.abspath(settings_path)))
    return System(camera, calib, config=cfg, extractor=extractor, vocab=vocab,
                  viewer_dir=viewer_dir, init_extractor=init_extractor,
                  async_mapper=async_mapper)
