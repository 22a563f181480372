"""Per-image Frame record (host-side) + feature conversion helpers.

Analog of the reference Frame (modules/BasicObject/Frame.h:22-78):
a plain host record holding fixed-capacity feature arrays (already produced
by the ORB extractor kernel), the body-frame pose state, per-feature map
point assignments, and the IMU buffers for the two preintegration windows
(since-last-frame and since-last-keyframe, Frame.cpp:73-88).

The reference's 40-px grid index for O(1) area queries (Frame.cpp:43-51)
has no analog here: windowed candidate gating is a dense mask inside the
batched Hamming kernel (ops/matching.py) in place of any bucketing."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..backend.residuals import KfState
from ..models.imu import ImuBuffer, Preintegrated


@dataclass
class Frame:
    time: float
    # fixed-capacity feature arrays (undistorted pixel coords)
    xy: np.ndarray  # [N, 2]
    level: np.ndarray  # [N]
    angle: np.ndarray  # [N]
    desc: np.ndarray  # [N, 8] uint32
    valid: np.ndarray  # [N]
    sigma2: np.ndarray  # [N] measurement variance scale
    # vocabulary node id per feature (-1 = no BoW info; Frame::computeBow
    # analog, Frame.cpp:168-178 — filled by System when a vocabulary is set)
    group: np.ndarray | None = None
    # body state (world frame)
    state: KfState | None = None
    # map point id per feature (-1 = none)
    pt_ids: np.ndarray | None = None
    # preintegration from the previous frame / keyframe
    pre_from_frame: Preintegrated | None = None
    pre_from_kf: Preintegrated | None = None
    # bias-corrected (dR, dV, dP) of pre_from_kf, fetched with the frame's
    # single sync-A read (tracking.track_feats) for host-side prediction
    _pred_deltas: tuple | None = None
    ref_kf: int = -1
    n_tracked: int = 0

    def __post_init__(self):
        if self.pt_ids is None:
            self.pt_ids = np.full(len(self.xy), -1, np.int64)

    @property
    def n_features(self) -> int:
        return int(self.valid.sum())


def _finish_features_impl(out, camera, scale_factors):
    """Device-side feature finishing: undistortion (Frame.cpp:28) +
    per-level measurement variance (kp-size scaling by camera uncertainty,
    Frame.cpp:24-26). Jitted once at module level so the whole extractor ->
    finish chain dispatches with ZERO intermediate host reads (the round-5
    sync-point work, utils/fetch.py)."""
    import jax.numpy as jnp

    xy_raw = jnp.asarray(out["xy"], jnp.float32)
    level = jnp.asarray(out["level"], jnp.int32)
    und = camera.undistort_points(xy_raw)
    unc = camera.uncertainty(xy_raw)
    sigma2 = (scale_factors[level] * unc) ** 2
    return {
        "xy": und,
        "xy_raw": xy_raw,
        "level": level,
        "angle": jnp.asarray(out["angle"], jnp.float32),
        "desc": jnp.asarray(out["desc"], jnp.uint32),
        "valid": out["valid"],
        "sigma2": sigma2,
    }


def finish_features(out, camera, scale_factors) -> dict:
    """Dispatch the feature-finishing chain; returns DEVICE arrays (no
    sync). Fetch happens once per frame in Tracking.track."""
    import jax

    global _finish_jit
    if _finish_jit is None:
        _finish_jit = jax.jit(_finish_features_impl)
    return _finish_jit(out, camera, np.asarray(scale_factors, np.float32))


_finish_jit = None


def features_from_extractor(out, camera, scale_factors) -> dict:
    """Host-array version of finish_features (one blocking fetch). Kept
    for the deterministic/offline callers; the live System path stays on
    device until the per-frame fetch."""
    from ..utils.fetch import fetch

    feats = fetch(finish_features(out, camera, scale_factors))
    feats["xy"] = feats["xy"].astype(np.float32)
    feats["desc"] = feats["desc"].astype(np.uint32)
    feats["level"] = feats["level"].astype(np.int32)
    feats["sigma2"] = feats["sigma2"].astype(np.float32)
    return feats


def make_frame(time: float, feats: dict) -> Frame:
    return Frame(
        time=time,
        xy=feats["xy"], level=feats["level"], angle=feats["angle"],
        desc=feats["desc"], valid=feats["valid"], sigma2=feats["sigma2"],
        group=feats.get("group"),
    )
