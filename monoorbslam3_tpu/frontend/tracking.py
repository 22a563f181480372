"""Tracking: the per-frame frontend state machine.

Analog of the reference Tracking thread (modules/Frontend/
Tracking.cpp:69-713): monocular initialization, IMU/motion-model pose
prediction, coarse tracking (last frame / reference KF), local-map
tracking, the 5-state machine (Tracking.h:20-26), and the keyframe policy.

Host/device cut (SURVEY.md §7 hard-part (b)): all branching/state logic
lives here in Python; every compute step — preintegration, projection,
masked Hamming matching, pose optimization — is a fixed-shape jitted
kernel. Matching candidates are padded to the frame feature capacity.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..backend import residuals as res
from ..backend.problems import _identity_edge, _pose_optimize_impl
from ..backend.residuals import KfState
from ..models.camera import project_np
from ..models.imu import GRAVITY_VALUE, ImuBuffer
from ..ops import matching
from ..ops.fused_match import projected_match
from ..ops.twoview import reconstruct_two_views
from ..utils import lie
from ..utils.fetch import fetch
from .frame import Frame, make_frame

G_W = np.array([0.0, 0.0, -GRAVITY_VALUE], np.float32)


@jax.jit
def _predict_deltas(pre, bg, ba):
    """Bias-corrected (dR, dV, dP) in ONE device call — the eager chain
    (exp_so3 + normalize + matmuls per delta) costs a dispatch per op."""
    return (pre.delta_rotation(bg), pre.delta_velocity(bg, ba),
            pre.delta_position(bg, ba))


# the tracker's projection/BoW searches disable the rotation histogram
# when its 3 dominant bins cover under half the matches (no consistent
# signal — see rotation_consistency_mask)
_rot_filter = jax.jit(partial(matching.rotation_consistency_mask,
                              min_keep_frac=0.5))


@jax.jit
def _project_points(R_wb, t_wb, R_cb, t_cb, xyz, camera):
    """Batched world->pixel projection + visibility, one device call."""
    R_cw = R_cb @ R_wb.T
    t_cw = t_cb - R_cw @ t_wb
    pc = xyz @ R_cw.T + t_cw
    uv = camera.project(pc)
    ok = (pc[:, 2] > 0.05) & camera.is_in_image(uv)
    return uv, ok


def _scatter_by_feature(idx, hit, n_feat, cand_xyz, cand_extra2):
    """Scatter per-candidate match results into per-feature problem rows.
    Mutual-NN matching guarantees each feature is hit by <= 1 candidate;
    unmatched candidates write the dropped overflow row."""
    P = cand_xyz.shape[0]
    f_t = jnp.where(hit, idx, n_feat)
    pts = jnp.zeros((n_feat + 1, 3), jnp.float32).at[f_t].set(cand_xyz)[:n_feat]
    extra2 = jnp.zeros(n_feat + 1, jnp.float32).at[f_t].set(cand_extra2)[:n_feat]
    vo = jnp.zeros(n_feat + 1, bool).at[f_t].set(hit)[:n_feat]
    ci = jnp.full(n_feat + 1, -1, jnp.int32).at[f_t].set(
        jnp.arange(P, dtype=jnp.int32))[:n_feat]
    return pts, extra2, vo, jnp.where(vo, ci, -1)


@partial(jax.jit, static_argnames=("use_rotation",))
def _coarse_track_kernel(state0, cand_xyz, cand_desc, cand_valid, cand_ang,
                         cand_extra2, fr_xy, fr_desc, fr_valid, fr_angle,
                         fr_sigma2, camera, R_cb, t_cb, radius, retry_below,
                         use_rotation=True):
    """The whole coarse tracking stage — project, two-radius projection
    match (wide pass selected on-device when the tight pass is weak, the
    reference's 2x-radius retry), rotation-consistency filter, per-feature
    problem assembly, visual pose LM — as ONE dispatch with ONE fetch.

    The previous per-step host-read structure made ~10 blocking reads
    for this stage alone (utils/fetch.py counts them); the second match
    pass shares nothing with the first but costs no extra read.

    Returns (state, cand_of_feature [N] i32, n_match, n_inliers)."""
    uv, ok = _project_points(state0.R_wb, state0.t_wb, R_cb, t_cb,
                             cand_xyz, camera)
    va = ok & cand_valid

    def match_at(r):
        idx, _ = projected_match(
            cand_desc, fr_desc, uv_a=uv, xy_b=fr_xy, radius=r,
            valid_a=va, valid_b=fr_valid, max_dist=matching.TH_HIGH,
            ratio=0.9)
        if use_rotation:
            keep = matching.rotation_consistency_mask(
                cand_ang, fr_angle, jnp.maximum(idx, 0), idx >= 0,
                min_keep_frac=0.5)
            idx = jnp.where(keep, idx, -1)
        return idx

    idx1 = match_at(radius)
    idx = jnp.where(jnp.sum(idx1 >= 0) < retry_below,
                    match_at(radius * 2.0), idx1)
    n_match = jnp.sum(idx >= 0)

    N = fr_xy.shape[0]
    pts, extra2, vo, ci = _scatter_by_feature(idx, idx >= 0, N,
                                              cand_xyz, cand_extra2)
    inv_s2 = 1.0 / (fr_sigma2 + extra2)
    z = KfState.zeros()
    state, inlier = _pose_optimize_impl(
        state0, pts, fr_xy, inv_s2, vo, camera, R_cb, t_cb,
        _identity_edge(), z, jnp.float32(0.0), z, jnp.zeros(9, jnp.float32),
        use_inertial=False, use_prior=False)
    inl = inlier & vo
    return state, jnp.where(inl, ci, -1), n_match, jnp.sum(inl)


@partial(jax.jit, static_argnames=("use_inertial",))
def _local_track_kernel(state0, cand_xyz, cand_desc, cand_valid, cand_normal,
                        cand_use_vcos, cand_extra2, radius, blockrow,
                        coarse_pts, coarse_inv_s2, coarse_valid,
                        fr_xy, fr_desc, fr_valid, fr_sigma2,
                        camera, R_cb, t_cb, t_bc, view_cos_gate, retry_min,
                        edge, last_state, edge_valid, use_inertial):
    """The whole local-map tracking stage as ONE dispatch + ONE fetch:
    project, view-cos gate, two-radius match (2.5x wide pass selected
    on-device when the tight pass re-captures under half the in-view
    candidates), merge with the coarse associations, pose(+inertial) LM.

    blockrow[f] = candidate row of the point the COARSE stage assigned to
    feature f (-1 none): the coarse association survives unless the local
    search re-matched that same point at a different feature (one
    observation per point — the host-side dedupe of the previous design).

    Returns (state, cand_of_feature, keep_coarse, cand_hit, n_inliers)."""
    uv, ok = _project_points(state0.R_wb, state0.t_wb, R_cb, t_cb,
                             cand_xyz, camera)
    center = state0.t_wb + state0.R_wb @ t_bc
    vec = cand_xyz - center
    dist = jnp.linalg.norm(vec, axis=1)
    ray = vec / jnp.maximum(dist, 1e-9)[:, None]
    view_cos = jnp.sum(ray * cand_normal, axis=1)
    ok = ok & (~cand_use_vcos | (view_cos > view_cos_gate))
    va = ok & cand_valid

    def match_at(r):
        idx, _ = projected_match(
            cand_desc, fr_desc, uv_a=uv, xy_b=fr_xy, radius=r,
            valid_a=va, valid_b=fr_valid, max_dist=matching.TH_HIGH,
            ratio=0.8)
        return idx

    idx1 = match_at(radius)
    thresh = jnp.maximum(retry_min, jnp.sum(va) // 2)
    idx = jnp.where(jnp.sum(idx1 >= 0) < thresh, match_at(radius * 2.5), idx1)
    hit = idx >= 0

    N = fr_xy.shape[0]
    lpts, lex2, lvo, lci = _scatter_by_feature(idx, hit, N,
                                               cand_xyz, cand_extra2)
    br = jnp.maximum(blockrow, 0)
    br_matched_elsewhere = ((blockrow >= 0) & (idx[br] >= 0)
                            & (idx[br] != jnp.arange(N)))
    cvalid = coarse_valid & ~br_matched_elsewhere & ~lvo
    pts = jnp.where(lvo[:, None], lpts, coarse_pts)
    vo = lvo | cvalid
    inv_s2 = jnp.where(lvo, 1.0 / (fr_sigma2 + lex2), coarse_inv_s2)

    z = KfState.zeros()
    state, inlier = _pose_optimize_impl(
        state0, pts, fr_xy, inv_s2, vo, camera, R_cb, t_cb,
        edge, last_state, edge_valid, z, jnp.zeros(9, jnp.float32),
        use_inertial=use_inertial, use_prior=False)
    inl = inlier & vo
    return (state, jnp.where(lvo & inl, lci, -1), cvalid & inl, hit,
            jnp.sum(inl))


def _shrink_frame(frame: Frame, priority: np.ndarray, cap: int) -> np.ndarray:
    """Reduce an oversized frame (the 2x initial extractor,
    Tracking.cpp:24) to the tracker/store feature capacity IN PLACE,
    keeping `priority` feature indices (the two-view inliers) first and
    filling with the remaining valid features in extractor order. Returns
    the old->new index map (-1 = dropped). No-op when already within
    capacity."""
    N = len(frame.xy)
    if N <= cap:
        return np.arange(N)
    pri = np.unique(np.asarray(priority, np.int64))
    pri = pri[frame.valid[pri]] if len(pri) else pri
    rest = np.setdiff1d(np.nonzero(frame.valid)[0], pri)
    keep = np.concatenate([pri, rest])[:cap].astype(np.int64)
    idx_map = np.full(N, -1, np.int64)
    idx_map[keep] = np.arange(len(keep))
    for name in ("xy", "level", "angle", "desc", "sigma2"):
        arr = getattr(frame, name)
        new = np.zeros((cap, *arr.shape[1:]), arr.dtype)
        new[: len(keep)] = arr[keep]
        setattr(frame, name, new)
    valid_new = np.zeros(cap, bool)
    valid_new[: len(keep)] = frame.valid[keep]
    frame.valid = valid_new
    if frame.group is not None:
        g = np.full(cap, -1, frame.group.dtype)
        g[: len(keep)] = frame.group[keep]
        frame.group = g
    frame.pt_ids = np.full(cap, -1, np.int64)
    return idx_map


def _rot_angle(M: np.ndarray) -> float:
    """Geodesic angle (radians) of a rotation matrix."""
    return float(np.arccos(np.clip((np.trace(M) - 1.0) / 2.0, -1.0, 1.0)))


def _orthonormalize(R: np.ndarray) -> np.ndarray:
    """Exact projection of a near-rotation onto SO(3) (host side, 3x3)."""
    U, _, Vt = np.linalg.svd(R.astype(np.float64))
    Rn = U @ Vt
    if np.linalg.det(Rn) < 0.0:
        Rn = (U * np.array([1.0, 1.0, -1.0])) @ Vt
    return Rn.astype(np.float32)

# state machine (Tracking.h:20-26)
NO_IMAGE = 0
NOT_INITIALIZED = 1
OK = 2
RECENTLY_LOST = 3
LOST = 4


class Tracking:
    def __init__(self, camera, calib, store, problems, config=None):
        self.camera = camera
        self.calib = calib
        self.store = store
        self.problems = problems
        cfg = config or {}
        self.n_feat = cfg.get("n_features", 1024)
        self.init_min_features = cfg.get("init_min_features", 200)
        self.init_min_matches = cfg.get("init_min_matches", 80)
        self.min_track_inliers = cfg.get("min_track_inliers", 12)
        # keyframe policy (needNewKeyFrame, Tracking.cpp:539-576): the
        # reference's absolute thresholds (350 "many", 75 "weak") assume
        # ~1000 features/frame; defaults scale with the feature capacity
        self.kf_tracked_ratio = cfg.get("kf_tracked_ratio", 0.9)
        self.kf_ref_ratio_many = cfg.get("kf_ref_ratio_many", 0.75)
        self.kf_many_inliers = cfg.get("kf_many_inliers",
                                       int(round(0.35 * self.n_feat)))
        self.kf_weak_inliers = cfg.get("kf_weak_inliers",
                                       max(40, int(round(0.075 * self.n_feat))))
        self.kf_max_frames = cfg.get("kf_max_frames", 10)
        self.kf_min_frames = cfg.get("kf_min_frames", 2)
        self.kf_max_interval = cfg.get("kf_max_interval", 0.5)
        self.kf_min_interval = cfg.get("kf_min_interval", 0.1)
        # minimum TIME between idle-mapper weak-trigger insertions (c1b).
        # The reference's c1b is frames >= 1 because its mapper is usually
        # BUSY on real-time streams; with a synchronous (always-idle)
        # mapper that cadence floods the map — measured on the 25 s circle
        # world: KF every 2 frames gives 86 cm ATE vs 11 cm at 0.3 s
        # spacing (map churn + short preintegration edges)
        self.kf_idle_interval = cfg.get("kf_idle_interval", 0.25)
        # coarse-mode dispatch: below this inlier count the post-IMU-init
        # tracker prefers trackLastKeyFrame over trackLastFrame
        # (Tracking.cpp:112-121, threshold 100 at ~1000 features)
        self.coarse_weak_inliers = cfg.get(
            "coarse_weak_inliers", min(100, max(30, self.n_feat // 10)))
        # matching parity gates (toggleable)
        self.rotation_check = cfg.get("rotation_check", True)
        # local-map candidate view-angle gate: drop points seen >60 deg off
        # their mean observation direction (Frame::isInFrustum viewCos>0.5,
        # Frame.cpp:129-166); <= -1 disables
        self.view_cos_gate = cfg.get("view_cos_gate", 0.5)
        self.local_pt_cap = cfg.get("local_pt_cap", 4096)
        self.lost_timeout = cfg.get("lost_timeout", 3.0)
        # initial-map conditioning gate: max relative depth sigma
        # (sigma_px/f)·z/b of a kept two-view triangulation (see
        # _create_initial_map). DEFAULT OFF (None): cutting far points
        # removes the map's rotation anchors — A/B-measured on the
        # 512x384 image world, the gated (near-only) first map over-
        # rotates 3 deg/frame against a 1 deg/frame truth. Enable only
        # for worlds whose init otherwise admits a large bad-depth
        # population (the 2x-extractor configuration).
        self.init_max_rel_sigma = cfg.get("init_max_rel_sigma", None)
        # gyro-consistency gate (radians) on the frame fit's per-frame
        # rotation vs the preintegrated gyro (see _track_frame)
        self.gyro_gate = cfg.get("gyro_gate", np.radians(1.5))
        self.scale_factors = cfg.get(
            "scale_factors", np.array([1.2**i for i in range(8)], np.float32)
        )

        self.state = NO_IMAGE
        self.imu_ready = False
        self.last_frame: Frame | None = None
        self.init_frame: Frame | None = None
        self.ref_kf = -1
        self.last_kf_time = -1e9
        self.last_kf_id = -1
        self.kf_imu_buffer = ImuBuffer()  # samples since last keyframe
        self.velocity_rel = None  # motion model: T_last->T_cur in camera frame
        self.lost_since = None
        # set after a map gauge rewrite / resume snaps last_frame.state to
        # a pose from a DIFFERENT timestamp: the next frame's fitted
        # frame-to-frame rotation is then legitimately gyro-inconsistent,
        # so the gyro guard skips one frame
        self._state_jump = False
        self.new_kf_callback = None  # set by System: receives new KF id
        # mapper-idle probe (LocalMapping::acceptKeyFrames analog,
        # Tracking.cpp:543): set by System; None = synchronous mapper,
        # always idle by construction
        self.mapper_idle = None
        # queue-capacity probe: False vetoes ALL keyframe insertion (the
        # backpressure the reference's unbounded queue lacks)
        self.mapper_accepts = None
        self.frames_since_kf = 0
        self.kf_tracked_count = 1
        # IMU timeline anchor for the first frame after a checkpoint resume
        # (no last_frame to take prev_t from)
        self.resume_prev_t: float | None = None
        self._imu_log: list = []  # rolling (t, gx..az) rows for init replay
        self._ransac_key = jax.random.PRNGKey(cfg.get("seed", 0))

    # ------------------------------------------------------------------
    # main entry
    # ------------------------------------------------------------------

    def track_feats(self, t: float, feats: dict, imu: np.ndarray | None):
        """Full per-frame step from a (possibly still on-device) feature
        dict: dispatches the preintegration + prediction chains, fetches
        everything in ONE sync point (sync A of the round-5 dispatch
        model), builds the host Frame, and runs the state machine.
        Returns (state, frame)."""
        # 1. preintegration bookkeeping (Tracking.cpp:90-91)
        frame_buf = ImuBuffer()
        prev_known = (self.last_frame.time if self.last_frame is not None
                      else self.resume_prev_t)
        self.resume_prev_t = None
        if imu is not None and len(imu) and prev_known is not None:
            prev_t = prev_known
            for row in imu:
                dt = max(float(row[0]) - prev_t, 0.0)
                prev_t = float(row[0])
                frame_buf.add(row[1:4], row[4:7], dt)
                self.kf_imu_buffer.add(row[1:4], row[4:7], dt)
                self._imu_log.append(np.asarray(row, np.float64))
            if len(self._imu_log) > 4000:
                self._imu_log = self._imu_log[-4000:]
        bg, ba = self._current_bias()
        pre_f = frame_buf.integrate(bg, ba, self.calib) if frame_buf.n else None
        pre_kf = (self.kf_imu_buffer.integrate(bg, ba, self.calib)
                  if self.kf_imu_buffer.n and self.last_kf_id >= 0 else None)
        deltas = (_predict_deltas(pre_kf, jnp.asarray(bg), jnp.asarray(ba))
                  if pre_kf is not None else None)
        # sync A: features + both preintegration windows + predict deltas
        feats, pre_f, pre_kf, deltas = fetch(feats, pre_f, pre_kf, deltas)
        feats = dict(feats)
        feats["xy"] = np.asarray(feats["xy"], np.float32)
        feats["desc"] = np.asarray(feats["desc"], np.uint32)
        frame = make_frame(t, feats)
        frame.pre_from_frame = pre_f
        frame.pre_from_kf = pre_kf
        frame._pred_deltas = deltas

        if self.state in (NO_IMAGE, NOT_INITIALIZED):
            self._initialize(frame)
        elif self.state in (OK, RECENTLY_LOST):
            self._track_frame(frame)
        self.last_frame = frame
        return self.state, frame

    def track(self, frame: Frame, imu: np.ndarray | None):
        """Compatibility entry for callers that pre-build a host Frame;
        the live System path uses track_feats (single-fetch)."""
        feats = _feat_dict(frame)
        state, new_frame = self.track_feats(frame.time, feats, imu)
        # mirror the results back onto the caller's Frame object
        frame.__dict__.update(new_frame.__dict__)
        return state

    def _current_bias(self):
        if self.last_kf_id >= 0:
            return self.store.kf_bg[self.last_kf_id], self.store.kf_ba[self.last_kf_id]
        return np.zeros(3, np.float32), np.zeros(3, np.float32)

    # ------------------------------------------------------------------
    # monocular initialization (Tracking.cpp:590-712)
    # ------------------------------------------------------------------

    def _initialize(self, frame: Frame):
        if frame.n_features < self.init_min_features:
            self.init_frame = None
            self.state = NOT_INITIALIZED
            return
        if self.init_frame is None:
            self.init_frame = frame
            self.state = NOT_INITIALIZED
            return

        f0, f1 = self.init_frame, frame
        mask = matching.window_mask(
            jnp.asarray(f0.xy), jnp.asarray(f1.xy),
            jnp.asarray(f0.valid), jnp.asarray(f1.valid), radius=100.0,
        )
        idx, _ = matching.match_descriptors(
            jnp.asarray(f0.desc), jnp.asarray(f1.desc), mask,
            angles_a=jnp.asarray(f0.angle), angles_b=jnp.asarray(f1.angle),
            max_dist=matching.TH_LOW, ratio=0.9, use_rotation=True,
        )
        idx = np.asarray(idx)
        matched = idx >= 0
        n_matches = int(matched.sum())
        # gate scales with the init frames' feature capacity: with the 2x
        # initial extractor (Tracking.cpp:24) twice the features should
        # yield twice the matches at the same quality bar — the reference
        # demands >= 200 of ~2000 (Tracking.cpp:605-614)
        gate = int(round(self.init_min_matches
                         * max(1.0, len(f0.xy) / self.n_feat)))
        if n_matches < gate:
            self.init_frame = frame  # slide the reference forward
            return

        # matched pair arrays (padded to capacity), mapped to IDEAL pinhole
        # pixels for the H/F machinery: identity for pinhole (keypoints are
        # already undistorted), the cv::fisheye::undistortPoints analog for
        # KB4 (Fisheye.cpp:119-139) whose stored keypoints stay distorted
        fx, fy = float(self.camera.fx), float(self.camera.fy)
        cx, cy = float(self.camera.cx), float(self.camera.cy)

        def _ideal(xy):
            r = np.asarray(self.camera.back_project(jnp.asarray(xy)))
            z = np.maximum(r[:, 2], 1e-6)
            uv = np.stack([fx * r[:, 0] / z + cx, fy * r[:, 1] / z + cy], -1)
            return uv.astype(np.float32), r[:, 2] > 1e-6

        N = len(f0.xy)
        xy1 = np.zeros((N, 2), np.float32)
        xy2 = np.zeros((N, 2), np.float32)
        pair_valid = np.zeros(N, bool)
        sel = np.nonzero(matched)[0]
        u0, ok0 = _ideal(f0.xy[sel])
        u1, ok1 = _ideal(f1.xy[idx[sel]])
        xy1[: len(sel)] = u0
        xy2[: len(sel)] = u1
        pair_valid[: len(sel)] = ok0 & ok1

        K = np.array(
            [[float(self.camera.fx), 0.0, float(self.camera.cx)],
             [0.0, float(self.camera.fy), float(self.camera.cy)],
             [0.0, 0.0, 1.0]], np.float32,
        )
        self._ransac_key, sub = jax.random.split(self._ransac_key)
        out = reconstruct_two_views(
            jnp.asarray(xy1), jnp.asarray(xy2), jnp.asarray(pair_valid),
            jnp.asarray(K), sub,
        )
        if not bool(out["success"]):
            return
        self._create_initial_map(f0, f1, sel, idx[sel], out)

    def _create_initial_map(self, f0: Frame, f1: Frame, feat0, feat1, out):
        """Two KFs + triangulated points -> initial_optimize -> depth-1 gauge
        (Tracking.cpp:646-712)."""
        store = self.store
        R21 = np.asarray(out["R"])
        t21 = np.asarray(out["t"])
        good = np.asarray(out["good"])[: len(feat0)]
        X = np.asarray(out["points"])[: len(feat0)]

        # conditioning gate on the initial map: a consecutive-frame init
        # pair has ~0.05 s of baseline, so far points triangulate with
        # relative depth sigma ~ (sigma_px/f)·z/b — measured 25-45% depth
        # error on the circle world's wall points, and a young map whose
        # bad-depth fraction crosses ~1/4 sends the frame fits into
        # progressive rotation divergence (the 2x initial extractor's
        # weaker corners tipped exactly this: 18% -> 29% bad, dtheta/frame
        # 1.0 -> 8 deg within 2 s). Keep the well-conditioned population;
        # if the motion regime leaves too few (forward motion near the
        # FOE), fall back to the best-conditioned half so bootstrap
        # remains possible in every regime.
        # effective sigma_px ~ 2: measured median depth error on the circle
        # world's init pair is 12.6% where a 0.8 px model predicts 5.4% —
        # weak-corner localization plus triangulation geometry roughly
        # double the nominal detector noise
        if self.init_max_rel_sigma is not None:
            b = float(np.linalg.norm(t21))
            z_init = X[:, 2]
            rel_sigma = (2.0 / float(self.camera.fx)) * z_init / max(b, 1e-9)
            strong = good & (rel_sigma <= self.init_max_rel_sigma)
            n_needed = max(60, int(0.5 * int(good.sum())))
            if int(strong.sum()) < n_needed:
                order = np.argsort(np.where(good, rel_sigma, np.inf))
                strong = np.zeros_like(good)
                strong[order[:n_needed]] = True
                strong &= good
            good = strong

        # 2x initial extractor: the oversized init frames must shrink to
        # the tracker/store capacity before becoming keyframes — two-view
        # inliers are kept with priority, then extractor order
        cap = self.n_feat
        if len(f0.xy) > cap or len(f1.xy) > cap:
            m0 = _shrink_frame(f0, feat0[good], cap)
            m1 = _shrink_frame(f1, feat1[good], cap)
            feat0 = m0[feat0]
            feat1 = m1[feat1]
            good = good & (feat0 >= 0) & (feat1 >= 0)

        R_cb = np.asarray(self.calib.R_cb)
        t_cb = np.asarray(self.calib.t_cb)

        def body_from_cam(R_cw, t_cw):
            R_wb = R_cw.T @ R_cb
            t_wb = R_cw.T @ (t_cb - t_cw)
            return R_wb.astype(np.float32), t_wb.astype(np.float32)

        R_wb0, t_wb0 = body_from_cam(np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
        R_wb1, t_wb1 = body_from_cam(R21, t21)

        z3 = np.zeros(3, np.float32)
        k0 = store.add_keyframe(f0.time, R_wb0, t_wb0, z3, z3, z3, _feat_dict(f0))
        k1 = store.add_keyframe(f1.time, R_wb1, t_wb1, z3, z3, z3, _feat_dict(f1))

        for i in np.nonzero(good)[0]:
            p = store.add_point(X[i], f1.desc[feat1[i]], k0)
            store.add_observation(p, k0, int(feat0[i]))
            store.add_observation(p, k1, int(feat1[i]))
            f1.pt_ids[feat1[i]] = p
        store.update_point_stats(
            store.kf_feat_pt[k1][store.kf_feat_pt[k1] >= 0],
            R_cb, t_cb, self.scale_factors,
        )

        self.problems.initial_optimize(store, [k0, k1])

        # gauge: median scene depth of KF0 -> 1 (Tracking.cpp:682-688)
        pids = store.kf_feat_pt[k0]
        pids = pids[pids >= 0]
        # depth in camera-0 frame
        R_cw0 = R_cb @ store.kf_R[k0].T
        t_cw0 = t_cb - R_cw0 @ store.kf_t[k0]
        z = (store.pt_xyz[pids] @ R_cw0.T + t_cw0)[:, 2]
        med = float(np.median(z))
        if med < 1e-6 or (z > 0).sum() < 30:
            store.reset()
            self.init_frame = None
            return
        inv = 1.0 / med
        # scale CAMERA CENTERS, not body origins: the camera-to-IMU lever arm
        # is metric and must not scale (t_wb' = s t_wb + (s-1) R_wb t_bc)
        t_bc = np.asarray(self.calib.t_bc)
        for kk in (k0, k1):
            lever = store.kf_R[kk] @ t_bc
            store.kf_t[kk] = inv * store.kf_t[kk] + (inv - 1.0) * lever
        store.pt_xyz[pids] *= inv
        store.pt_min_dist[pids] *= inv
        store.pt_max_dist[pids] *= inv

        # frame states
        f1.state = KfState(
            jnp.asarray(store.kf_R[k1]), jnp.asarray(store.kf_t[k1]),
            jnp.zeros(3), jnp.zeros(3), jnp.zeros(3),
        )
        f1.ref_kf = k1
        f1.n_tracked = int(good.sum())
        self.ref_kf = k1
        self.last_kf_id = k1
        self.last_kf_time = f1.time
        self.kf_tracked_count = f1.n_tracked
        # rebuild the k0 -> k1 IMU window from the rolling sample log
        buf01 = ImuBuffer()
        prev_t = f0.time
        for row in self._imu_log:
            if f0.time < row[0] <= f1.time + 1e-9:
                buf01.add(row[1:4], row[4:7], max(float(row[0]) - prev_t, 0.0))
                prev_t = float(row[0])
        store.kf_imu[k0] = buf01
        self.kf_imu_buffer = ImuBuffer()
        store.kf_imu[k1] = self.kf_imu_buffer
        self.state = OK
        self.frames_since_kf = 0
        if self.new_kf_callback:
            self.new_kf_callback(k0, initial=True)
            self.new_kf_callback(k1, initial=True)

    # ------------------------------------------------------------------
    # per-frame tracking (Tracking.cpp:96-174)
    # ------------------------------------------------------------------

    def _predict_state(self, frame: Frame) -> KfState:
        """IMU prediction from last KF (Tracking.cpp:211-243) or constant
        camera-motion model."""
        if (self.imu_ready and frame.pre_from_kf is not None
                and frame._pred_deltas is not None and self.last_kf_id >= 0):
            k = self.last_kf_id
            pre = frame.pre_from_kf
            # deltas were dispatched with the frame's integrate chain and
            # fetched at sync A (track_feats) — pure host math from here
            dR, dV, dP = (np.asarray(a, np.float32)
                          for a in frame._pred_deltas)
            dt = float(pre.dt)
            R0, t0, v0 = self.store.kf_R[k], self.store.kf_t[k], self.store.kf_v[k]
            R = R0 @ dR
            v = v0 + G_W * dt + R0 @ dV
            t = t0 + v0 * dt + 0.5 * G_W * dt * dt + R0 @ dP
            return KfState(R.astype(np.float32), t.astype(np.float32),
                           v.astype(np.float32), self.store.kf_bg[k],
                           self.store.kf_ba[k])
        # constant-velocity motion model on the body pose
        last = self.last_frame
        if last is not None and last.state is not None and self.velocity_rel is not None:
            R_rel, t_rel = self.velocity_rel
            R = _orthonormalize(np.asarray(last.state.R_wb) @ R_rel)
            t = np.asarray(last.state.t_wb) + np.asarray(last.state.R_wb) @ t_rel
            return KfState(jnp.asarray(R.astype(np.float32)),
                           jnp.asarray(t.astype(np.float32)),
                           last.state.v, last.state.bg, last.state.ba)
        if last is not None and last.state is not None:
            return last.state
        # no frame history (first frame after a checkpoint resume): start
        # from the newest keyframe's state — the local-map wide-radius
        # search re-acquires from there (the RECENTLY_LOST recovery path)
        if self.last_kf_id >= 0:
            k = self.last_kf_id
            return KfState(
                jnp.asarray(self.store.kf_R[k]), jnp.asarray(self.store.kf_t[k]),
                jnp.asarray(self.store.kf_v[k]), jnp.asarray(self.store.kf_bg[k]),
                jnp.asarray(self.store.kf_ba[k]),
            )
        return KfState.zeros()

    def _track_frame(self, frame: Frame):
        frame.state = self._predict_state(frame)
        frame.ref_kf = self.ref_kf

        ok = False
        if self.state == OK:
            last_strong = (self.last_frame is not None
                           and self.last_frame.n_tracked > 0)
            if self.imu_ready:
                # post-IMU-init dispatch (Tracking.cpp:111-121): a weak last
                # frame routes straight to the last KEYFRAME's points (they
                # survived mapping/BA); otherwise last frame with a last-KF
                # fallback after a re-prediction
                if (last_strong
                        and self.last_frame.n_tracked >= self.coarse_weak_inliers):
                    ok = self._match_against_last(frame)
                if not ok:
                    frame.state = self._predict_state(frame)
                    ok = self._match_against_last_kf(frame)
            elif last_strong:
                ok = self._match_against_last(frame)
            if not ok:
                frame.state = self._predict_state(frame)
                ok = self._match_against_ref_kf(frame)
        else:  # RECENTLY_LOST: IMU prediction, last-KF reattach, local map
            if self.imu_ready:
                ok = self._match_against_last_kf(frame)
                if not ok:
                    # the IMU-only prediction alone carries into the
                    # wide-radius local-map re-capture (Tracking.cpp:123-126)
                    frame.state = self._predict_state(frame)
                    ok = True

        # the local map is the self-healing stage: try it even when the
        # coarse stages failed (the wide-radius projection search can
        # re-capture the map from the predicted pose alone)
        ok = self._track_local_map(frame) or (ok and frame.n_tracked >= self.min_track_inliers)

        # gyro-consistency guard (beyond reference — it has no equivalent,
        # Tracking.cpp accepts any poseOptimize fix): with bad-depth young
        # points the frame landscape goes multimodal and a converged fit
        # can land in a wrong basin (measured on fastspin bootstrap:
        # fitted dR jumps to 8 deg/frame against a gyro-true 2.6, then the
        # map dies within 3 frames). The raw gyro knows the true rotation
        # rate to ~0.01 deg/frame; a fit whose frame-to-frame rotation
        # contradicts it is refit from the gyro-composed prediction.
        if (ok and not self._state_jump and frame.pre_from_frame is not None
                and self.last_frame is not None
                and self.last_frame.state is not None):
            dR_gyro = np.asarray(frame.pre_from_frame.dR, np.float64)
            R_last = np.asarray(self.last_frame.state.R_wb, np.float64)
            dR_fit = R_last.T @ np.asarray(frame.state.R_wb, np.float64)
            dev = _rot_angle(dR_fit.T @ dR_gyro)
            gate = max(self.gyro_gate, 0.25 * _rot_angle(dR_gyro))
            if dev > gate:
                st = self._predict_state(frame)
                R_pred = _orthonormalize(R_last @ dR_gyro).astype(np.float32)
                frame.state = KfState(jnp.asarray(R_pred), st.t_wb, st.v,
                                      st.bg, st.ba)
                frame.pt_ids[:] = -1
                ok = self._track_local_map(frame)
                if ok:
                    dR_fit = R_last.T @ np.asarray(frame.state.R_wb,
                                                   np.float64)
                    ok = _rot_angle(dR_fit.T @ dR_gyro) <= 2.0 * gate
        self._state_jump = False

        if ok:
            self.state = OK
            self.lost_since = None
            # update the camera-frame motion model (Tracking.cpp:131-136).
            # The translation is exponentially smoothed: frame-to-frame
            # differentiation amplifies pose-fit noise, and the resulting
            # prediction jitter feeds back through the radius-gated matchers
            # (see STATUS.md forensic notes). Rotation stays instantaneous
            # (well-constrained by ~200 features).
            if self.last_frame is not None and self.last_frame.state is not None:
                R_last = np.asarray(self.last_frame.state.R_wb)
                t_last = np.asarray(self.last_frame.state.t_wb)
                R_cur = np.asarray(frame.state.R_wb)
                t_cur = np.asarray(frame.state.t_wb)
                t_rel_new = R_last.T @ (t_cur - t_last)
                if self.velocity_rel is not None:
                    t_rel_new = 0.5 * t_rel_new + 0.5 * self.velocity_rel[1]
                # _orthonormalize is load-bearing: R_last^T R_cur passes any
                # off-manifold error in the fitted state through twice per
                # frame (geometric doubling — the round-1 ~1 s collapse,
                # STATUS.md); projecting back to SO(3) caps it at roundoff.
                self.velocity_rel = (_orthonormalize(R_last.T @ R_cur), t_rel_new)
            self.frames_since_kf += 1
            if self._need_new_keyframe(frame):
                self._create_keyframe(frame)
        else:
            if self.state == OK:
                self.state = RECENTLY_LOST if self.imu_ready else LOST
                self.lost_since = frame.time
            elif self.state == RECENTLY_LOST:
                if frame.time - (self.lost_since or frame.time) > self.lost_timeout:
                    self.state = LOST
            frame.n_tracked = 0

    # -- matching stages ------------------------------------------------

    def _candidate_points(self, pt_ids, feat_angles=None):
        """Pad candidate point data to the feature capacity. When
        `feat_angles` (per-feature keypoint angles aligned with pt_ids) is
        given, also returns each candidate's source-view orientation for
        the rotation-consistency histogram (SearchByProjection applies it
        frame->frame and KF->frame, ORBMatcher.cpp:329-345)."""
        N = self.n_feat
        src = np.nonzero(pt_ids >= 0)[0][:N]
        sel = pt_ids[src]
        xyz = np.zeros((N, 3), np.float32)
        desc = np.zeros((N, 8), np.uint32)
        valid = np.zeros(N, bool)
        ang = np.zeros(N, np.float32)
        n = len(sel)
        xyz[:n] = self.store.pt_xyz[sel]
        desc[:n] = self.store.pt_desc[sel]
        valid[:n] = self.store.pt_valid[sel]
        if feat_angles is not None:
            ang[:n] = feat_angles[src]
        ids = np.full(N, -1, np.int64)
        ids[:n] = sel
        return xyz, desc, valid, ids, ang

    def _project(self, state: KfState, xyz):
        uv, ok = _project_points(
            jnp.asarray(state.R_wb), jnp.asarray(state.t_wb),
            jnp.asarray(self.calib.R_cb), jnp.asarray(self.calib.t_cb),
            jnp.asarray(xyz), self.camera,
        )
        return np.asarray(uv), np.asarray(ok)

    def _cand_extra2(self, state: KfState, xyz: np.ndarray,
                     ids: np.ndarray) -> np.ndarray:
        """Per-candidate extra measurement variance (px^2) from the point's
        along-ray depth uncertainty seen from `state` — the host-side
        candidate-array version of _point_depth_sigma_px, computed BEFORE
        matching so the fused kernels can assemble the pose problem
        on-device."""
        store = self.store
        center = (np.asarray(state.t_wb)
                  + np.asarray(state.R_wb) @ np.asarray(self.calib.t_bc))
        vec = xyz - center
        z = np.linalg.norm(vec, axis=1)
        ray = vec / np.maximum(z[:, None], 1e-9)
        normal = store.pt_normal[np.maximum(ids, 0)]
        cos_t = np.abs((ray * normal).sum(1))
        sin_t = np.sqrt(np.maximum(1.0 - cos_t**2, 0.0))
        f = float(self.camera.fx)
        sig = f * store.pt_sigma_z[np.maximum(ids, 0)] * sin_t / np.maximum(z, 1e-6)
        return (sig**2).astype(np.float32)

    def _coarse_track(self, frame: Frame, pt_ids_src, ang_src) -> bool:
        """Shared trackLastFrame / trackLastKeyFrame stage (Tracking.cpp:
        284-343) through the single-dispatch coarse kernel: one blocking
        read covers project + two-radius match + rotation filter +
        pose LM (was ~6-10 blocking reads)."""
        xyz, desc, valid, ids, ang = self._candidate_points(pt_ids_src, ang_src)
        extra2 = self._cand_extra2(frame.state, xyz, ids)
        st, ci, n_match, n_inl = fetch(_coarse_track_kernel(
            frame.state, xyz, desc, valid, ang, extra2,
            frame.xy, frame.desc, frame.valid, frame.angle, frame.sigma2,
            self.camera, self.calib.R_cb, self.calib.t_cb,
            np.full(len(xyz), 15.0, np.float32),
            np.int32(2 * self.min_track_inliers),
            use_rotation=self.rotation_check))
        frame.pt_ids[:] = -1
        if int(n_match) < self.min_track_inliers:
            return False
        frame.state = KfState(*(np.asarray(a, np.float32) for a in st))
        sel = ci >= 0
        frame.pt_ids[sel] = ids[ci[sel]]
        return int(n_inl) >= self.min_track_inliers

    def _match_against_last(self, frame: Frame) -> bool:
        """trackLastFrame (Tracking.cpp:284-314): project last frame's
        points (with the reference's 2x-radius weak-pass retry, folded
        into the kernel)."""
        return self._coarse_track(frame, self.last_frame.pt_ids,
                                  self.last_frame.angle)

    def _match_against_last_kf(self, frame: Frame) -> bool:
        """trackLastKeyFrame (Tracking.cpp:316-343): projection match
        against the last KEYFRAME's mapped points — the coarse mode the
        reference prefers post-IMU-init whenever the last frame is weak
        (its tracked set is small or the frame is RECENTLY_LOST), because
        the KF's points survived mapping/BA while the frame's may not."""
        k = self.last_kf_id
        if k < 0:
            return False
        return self._coarse_track(frame, self.store.kf_feat_pt[k],
                                  self.store.kf_feat_angle[k])

    def _match_against_ref_kf(self, frame: Frame) -> bool:
        """trackReferenceKeyFrame (Tracking.cpp:255-282): descriptor match
        vs the reference KF's mapped features. With a vocabulary configured
        this is SearchByBow (ORBMatcher.cpp:118-201): candidates are gated
        to shared vocabulary nodes; without one it degrades to the dense
        full-candidate match (group = -1 passes everything)."""
        k = self.ref_kf
        if k < 0:
            return False
        feat_pt = self.store.kf_feat_pt[k]
        xyz, desc, valid, ids, ang = self._candidate_points(
            feat_pt, self.store.kf_feat_angle[k])
        # candidate groups, aligned with _candidate_points' feature order
        groups_kf = np.full(self.n_feat, -1, np.int32)
        feat_sel = np.nonzero(feat_pt >= 0)[0][: self.n_feat]
        groups_kf[: len(feat_sel)] = self.store.kf_feat_group[k, feat_sel]
        groups_f = (frame.group if frame.group is not None
                    else np.full(self.n_feat, -1, np.int32))
        # no spatial gate — descriptor matching with stricter ratio, node-gated
        idx, _ = projected_match(
            jnp.asarray(desc), jnp.asarray(frame.desc),
            groups_a=jnp.asarray(groups_kf), groups_b=jnp.asarray(groups_f),
            valid_a=jnp.asarray(valid), valid_b=jnp.asarray(frame.valid),
            max_dist=matching.TH_LOW, ratio=0.75,
        )
        if self.rotation_check:
            # SearchByBow's orientation-consistency check (ORBMatcher.cpp:186-199)
            idx = jnp.asarray(idx)
            keep = _rot_filter(jnp.asarray(ang), jnp.asarray(frame.angle),
                               jnp.maximum(idx, 0), idx >= 0)
            idx = jnp.where(keep, idx, -1)
        idx = np.asarray(idx)
        frame.pt_ids[:] = -1
        hit = idx >= 0
        frame.pt_ids[idx[hit]] = ids[hit]
        if int(hit.sum()) < self.min_track_inliers:
            return False
        return self._optimize_frame_pose(frame) >= self.min_track_inliers

    def _harvest_local_points(self, frame: Frame):
        """updateLocalKeyFrames/Points (Tracking.cpp:429-537): points of the
        covisible neighborhood of the reference KF + recent KFs.

        The graph-keyed harvest alone goes blind whenever the view sweeps
        past its covisible neighborhood: under sustained rotation the
        recent KFs all face BEHIND the sweep, and on a lap revisit the old
        map dead-ahead is never offered (measured on fastspin: 120-250
        in-frustum candidates of a 3k-point map, inliers thinning 95 -> 8
        until a terminal reset). The reference can only pointer-chase
        covisibility on CPU; here the whole map is one SoA array, so a
        pose-keyed FRUSTUM harvest — project EVERY point against the
        predicted pose, one fixed-shape batched op — joins the candidate
        set, ranked in-view-first. This both re-captures during the
        IMU-only RECENTLY_LOST bridge and re-attaches the previous lap's
        landmarks during healthy tracking (the no-loop-closure drift
        killer)."""
        store = self.store
        kfs = set(store.recent_keyframes(10))
        if self.ref_kf >= 0:
            kfs.add(self.ref_kf)
            for j in store.covisible_keyframes(self.ref_kf, top=20):
                kfs.add(j)
        pid_set = store.kf_feat_pt[np.asarray(sorted(kfs), np.int32)]
        pids = np.unique(pid_set[pid_set >= 0])
        pids = pids[store.pt_valid[pids]]
        in_view_all = self._in_view_np(frame.state, store.pt_xyz)
        cand = np.nonzero(in_view_all & store.pt_valid
                          & (store.pt_n_obs >= 3))[0]
        pids = np.union1d(pids, cand)
        if len(pids) > self.local_pt_cap:
            # in-view candidates first (out-of-view ones cannot match
            # anyway), then by observation count
            key = in_view_all[pids] * 10_000 + np.minimum(
                store.pt_n_obs[pids], 9_999)
            pids = pids[np.argsort(-key)[: self.local_pt_cap]]
        return pids

    def _in_view_np(self, state: KfState, xyz: np.ndarray) -> np.ndarray:
        """Host-side in-frustum test (numpy — the harvest only SELECTS
        candidates; running it on device cost one blocking read per
        frame)."""
        R_cb = np.asarray(self.calib.R_cb)
        t_cb = np.asarray(self.calib.t_cb)
        R_cw = R_cb @ np.asarray(state.R_wb).T
        t_cw = t_cb - R_cw @ np.asarray(state.t_wb)
        pc = xyz @ R_cw.T + t_cw
        _, ok = project_np(self.camera, pc)
        return ok

    def _track_local_map(self, frame: Frame) -> bool:
        """trackLocalMap (Tracking.cpp:345-427) through the single-
        dispatch local kernel: candidate selection + per-candidate radius
        policy stay host-side (pure numpy over the SoA store); projection,
        view-cos gate, two-radius match, coarse merge and the
        pose(+inertial) LM run as ONE device program with ONE fetch."""
        store = self.store
        pids = self._harvest_local_points(frame)
        P = self.local_pt_cap
        xyz = np.zeros((P, 3), np.float32)
        desc = np.zeros((P, 8), np.uint32)
        valid = np.zeros(P, bool)
        ids = np.full(P, -1, np.int64)
        n = len(pids)
        xyz[:n] = store.pt_xyz[pids]
        desc[:n] = store.pt_desc[pids]
        valid[:n] = True
        ids[:n] = pids

        # scale-band radius: predicted level from distance (MapPoint scale
        # invariance band, MapPoint.cpp:159-170)
        center = (np.asarray(frame.state.t_wb)
                  + np.asarray(frame.state.R_wb) @ np.asarray(self.calib.t_bc))
        dist = np.linalg.norm(xyz - center, axis=1)
        normal = store.pt_normal[np.maximum(ids, 0)].astype(np.float32)
        has_normal = np.linalg.norm(normal, axis=1) > 0.5
        # view-angle gate (Frame::isInFrustum, Frame.cpp:129-166): a
        # candidate seen far off its mean observation direction cannot
        # look like its descriptor — dropped on device before matching
        use_vcos = has_normal & (self.view_cos_gate > -1.0) & valid
        with np.errstate(divide="ignore", invalid="ignore"):
            ratio = np.where(dist > 1e-6, store.pt_max_dist[np.maximum(ids, 0)] / np.maximum(dist, 1e-6), 1.0)
        level_pred = np.clip(
            np.round(np.log(np.maximum(ratio, 1e-3)) / np.log(1.2)), 0,
            len(self.scale_factors) - 1,
        ).astype(np.int32)
        # generous base radius: the local-map search is the tracker's
        # self-healing loop — it must re-capture points even when the pose
        # has drifted a few pixels (a tight radius lets the matched subset
        # cluster and the pose random-walk away from the rest of the map)
        radius = np.maximum(12.0, 4.0 * self.scale_factors[level_pred]).astype(np.float32)
        # ... and it must re-capture points whose own DEPTH is uncertain:
        # a low-parallax triangulation (forward motion: 2-4 deg parallax,
        # 10-30% depth error) projects off by f*r*dz/z^2 — tens of pixels
        # within half a second of approach. With a fixed radius such points
        # match for ~0.3 s and are never re-observed, so window BA never
        # accrues the baseline that would REPAIR the depth, and the map
        # keeps no long-baseline tether (measured on the corridor world:
        # matched-point median age 0.3 s, 97% younger than 2 s; old
        # in-view points' best-descriptor feature sits 100-260 px from the
        # projection). Open the search window by the projected depth
        # uncertainty — the same statistic that down-weights these matches
        # in the pose fit, so admitting them cannot poison it.
        sigma_px = self._point_depth_sigma_px_arr(frame, xyz, ids, dist)
        radius = radius + np.minimum(2.0 * sigma_px, 48.0).astype(np.float32)
        # ... and by STALENESS (time since the point's last keyframe
        # observation): a point that stops matching drifts away from the
        # live gauge at the mean gauge-drift rate and its projection
        # offset GROWS with time unobserved — once it exceeds a fixed
        # radius the point is lost to matching forever, the window BA
        # loses every long-baseline constraint (anchors and the young
        # chain end up sharing ZERO observations), and the mono-VI mean
        # gauge is left unpinned. Growing the radius with staleness keeps
        # points continuously re-capturable, so BA keeps them consistent
        # and large offsets never form.
        obs_kf = self.store.pt_obs_kf[np.maximum(ids, 0)]
        obs_t = self.store.kf_time[np.maximum(obs_kf, 0)]
        has_obs = obs_kf >= 0
        # empty observation slots must not count as "observed now" — mask
        # them to -inf before the row max (a frame.time fill here silently
        # zeroed staleness for every point with a non-full table)
        last_t = np.where(has_obs, obs_t, -np.inf).max(axis=1)
        staleness = np.where(np.isfinite(last_t),
                             np.maximum(frame.time - last_t, 0.0), 0.0)
        radius = radius + np.minimum(25.0 * staleness, 50.0).astype(np.float32)
        if self.state == RECENTLY_LOST and self.lost_since is not None:
            # during the IMU-only bridge the position error grows with
            # time-since-loss (double-integrated velocity error): open the
            # re-capture window accordingly — measured on fastspin, a
            # fixed radius matched 0-8 of 127-267 in-frustum candidates
            # for 3.6 s straight while the predicted pose was good
            radius = radius * float(
                1.0 + min(4.0, 3.0 * (frame.time - self.lost_since)))

        # coarse-assignment merge inputs: per-feature problem rows for the
        # already-assigned points, and blockrow (candidate row of each
        # coarse point, for the one-observation-per-point rule)
        N = self.n_feat
        coarse_pts = np.zeros((N, 3), np.float32)
        coarse_inv_s2 = np.ones(N, np.float32)
        coarse_valid = np.zeros(N, bool)
        blockrow = np.full(N, -1, np.int32)
        csel = np.nonzero(frame.pt_ids >= 0)[0]
        if len(csel):
            cpids = frame.pt_ids[csel]
            coarse_pts[csel] = store.pt_xyz[cpids]
            cex = self._point_depth_sigma_px(frame, cpids)
            coarse_inv_s2[csel] = 1.0 / (frame.sigma2[csel] + cex**2)
            coarse_valid[csel] = True
            if n:
                pos = np.searchsorted(pids, cpids)
                pos_c = np.minimum(pos, n - 1)
                pos_ok = pids[pos_c] == cpids
                blockrow[csel[pos_ok]] = pos_c[pos_ok]

        use_inertial = bool(self.imu_ready and frame.pre_from_kf is not None
                            and self.last_kf_id >= 0)
        if use_inertial:
            k = self.last_kf_id
            edge = self.problems._whiten_batch(frame.pre_from_kf)
            last_state = KfState(store.kf_R[k], store.kf_t[k], store.kf_v[k],
                                 store.kf_bg[k], store.kf_ba[k])
            edge_valid = np.float32(1.0)
        else:
            edge = _identity_edge()
            last_state = KfState.zeros()
            edge_valid = np.float32(0.0)

        extra2 = sigma_px**2
        st, lci, keep_coarse, hit, n_inl = fetch(_local_track_kernel(
            frame.state, xyz, desc, valid, normal, use_vcos,
            extra2.astype(np.float32), radius.astype(np.float32), blockrow,
            coarse_pts, coarse_inv_s2, coarse_valid,
            frame.xy, frame.desc, frame.valid, frame.sigma2,
            self.camera, self.calib.R_cb, self.calib.t_cb,
            np.asarray(self.calib.t_bc, np.float32),
            np.float32(self.view_cos_gate),
            np.int32(2 * self.min_track_inliers),
            edge, last_state, edge_valid, use_inertial=use_inertial))

        stats_vis = ids[hit & (ids >= 0)]
        store.pt_visible[stats_vis] += 1
        frame.state = KfState(*(np.asarray(a, np.float32) for a in st))
        new_ids = np.full(N, -1, np.int64)
        new_ids[keep_coarse] = frame.pt_ids[keep_coarse]
        lsel = lci >= 0
        new_ids[lsel] = ids[lci[lsel]]
        frame.pt_ids[:] = new_ids
        tracked = frame.pt_ids >= 0
        store.pt_found[frame.pt_ids[tracked]] += 1
        n_inliers = int(n_inl)
        frame.n_tracked = n_inliers
        return n_inliers >= self.min_track_inliers

    def _point_depth_sigma_px_arr(self, frame: Frame, xyz: np.ndarray,
                                  ids: np.ndarray,
                                  dist: np.ndarray) -> np.ndarray:
        """_point_depth_sigma_px over the padded candidate arrays (reuses
        the precomputed point->camera distances)."""
        store = self.store
        st = frame.state
        center = np.asarray(st.t_wb) + np.asarray(st.R_wb) @ np.asarray(self.calib.t_bc)
        ray = (xyz - center) / np.maximum(dist, 1e-9)[:, None]
        normal = store.pt_normal[np.maximum(ids, 0)]
        cos_t = np.abs((ray * normal).sum(1))
        sin_t = np.sqrt(np.maximum(1.0 - cos_t**2, 0.0))
        f = float(self.camera.fx)
        sig = store.pt_sigma_z[np.maximum(ids, 0)]
        return f * sig * sin_t / np.maximum(dist, 1e-6)

    def _point_depth_sigma_px(self, frame: Frame, pids: np.ndarray) -> np.ndarray:
        """Per-point extra pixel sigma from the point's along-ray (depth)
        uncertainty seen from the CURRENT viewpoint: the depth error is
        invisible along the point's mean observation ray and fully visible
        perpendicular to it — sigma_px ~ f * sigma_z * sin(theta) / z."""
        store = self.store
        st = frame.state
        center = np.asarray(st.t_wb) + np.asarray(st.R_wb) @ np.asarray(self.calib.t_bc)
        vec = store.pt_xyz[pids] - center
        z = np.linalg.norm(vec, axis=1)
        ray = vec / np.maximum(z[:, None], 1e-9)
        normal = store.pt_normal[pids]
        cos_t = np.abs((ray * normal).sum(1))
        sin_t = np.sqrt(np.maximum(1.0 - cos_t**2, 0.0))
        f = float(self.camera.fx)
        return f * store.pt_sigma_z[pids] * sin_t / np.maximum(z, 1e-6)

    def _optimize_frame_pose(self, frame: Frame, full: bool = False) -> int:
        """poseOptimize / poseFullOptimize dispatch, with per-observation
        sigma inflated by the matched point's projected depth uncertainty
        (low-parallax points contribute bearing information only)."""
        N = self.n_feat
        sel = np.nonzero(frame.pt_ids >= 0)[0]
        pts = np.zeros((N, 3), np.float32)
        uv = np.zeros((N, 2), np.float32)
        inv_s2 = np.ones(N, np.float32)
        valid = np.zeros(N, bool)
        n = len(sel)
        pids = frame.pt_ids[sel]
        pts[:n] = self.store.pt_xyz[pids]
        uv[:n] = frame.xy[sel]
        extra_px = self._point_depth_sigma_px(frame, pids)
        eff_sigma2 = frame.sigma2[sel] + extra_px**2
        inv_s2[:n] = 1.0 / eff_sigma2
        valid[:n] = True

        if full and frame.pre_from_kf is not None and self.last_kf_id >= 0:
            k = self.last_kf_id
            last_state = KfState(
                jnp.asarray(self.store.kf_R[k]), jnp.asarray(self.store.kf_t[k]),
                jnp.asarray(self.store.kf_v[k]), jnp.asarray(self.store.kf_bg[k]),
                jnp.asarray(self.store.kf_ba[k]),
            )
            state, inlier = self.problems.pose_full_optimize(
                frame.state, pts, uv, inv_s2, valid, last_state, frame.pre_from_kf,
            )
        else:
            state, inlier = self.problems.pose_optimize(
                frame.state, pts, uv, inv_s2, valid)
        frame.state = state
        # outliers lose their association (Tracking.cpp poseOptimize usage)
        out = sel[~inlier[:n]]
        frame.pt_ids[out] = -1
        return int(inlier[:n].sum())

    # ------------------------------------------------------------------
    # keyframe policy (Tracking.cpp:539-588)
    # ------------------------------------------------------------------

    def _num_ref_matches(self, min_obs: int) -> int:
        """Reference-KF tracked map points with >= min_obs observations
        (KeyFrame::getNumTrackedMapPoint, used by needNewKeyFrame)."""
        if self.ref_kf < 0:
            return 0
        pids = self.store.kf_feat_pt[self.ref_kf]
        pids = pids[pids >= 0]
        good = self.store.pt_valid[pids] & (self.store.pt_n_obs[pids] >= min_obs)
        return int(good.sum())

    def _need_new_keyframe(self, frame: Frame) -> bool:
        """needNewKeyFrame (Tracking.cpp:539-576): the reference's
        condition set — c1a max-frames, c1b min-frames + mapper idle,
        c2 weak vs the reference KF's good points, c3 max time, c4 weak
        absolute count — gated by mapper idleness (backpressure: a busy
        async mapper vetoes insertion; the bounded-iteration LM removes
        the need for the reference's interruptBA). Deviation: the
        RECENTLY_LOST branch of c4 is unreachable here because this
        policy only runs on tracked frames."""
        dt = frame.time - self.last_kf_time
        if dt < self.kf_min_interval:
            return False
        if frame.n_tracked < self.min_track_inliers:
            return False
        if self.mapper_accepts is not None and not self.mapper_accepts():
            return False  # queue full: hard backpressure
        idle = self.mapper_idle() if self.mapper_idle is not None else True
        min_obs = 3 if self.store.n_keyframes() > 2 else 2
        n_ref = self._num_ref_matches(min_obs)
        ratio = (self.kf_ref_ratio_many
                 if frame.n_tracked > self.kf_many_inliers
                 else self.kf_tracked_ratio)
        c1a = self.frames_since_kf >= self.kf_max_frames
        c1b = (self.frames_since_kf >= self.kf_min_frames and idle
               and dt >= self.kf_idle_interval)
        c2 = frame.n_tracked < ratio * n_ref
        c3 = dt >= self.kf_max_interval
        c4 = self.min_track_inliers < frame.n_tracked < self.kf_weak_inliers
        if ((c1a or c1b) and c2) or c3 or c4:
            # Async mode (mapper_accepts set): the BOUNDED QUEUE is the
            # backpressure — mapper_accepts already vetoed a full queue
            # above, and the drain-mode mapper absorbs a backlog at
            # per-KF-stage cost (System._mapper_loop). Gating triggered
            # insertions on mapper IDLENESS here is what starved async
            # runs whose mapper is slower than the KF cadence (such a
            # mapper is never idle -> 10 KFs/60 s -> the inertial init
            # never got a chain; the reference equivalent is interruptBA + the queue
            # absorbing the KF, LocalMapping.cpp:589-593).
            if self.mapper_accepts is not None:
                return True
            # sync mode: a busy mapper vetoes all but the hard triggers
            return idle or c3 or c4
        return False

    def _create_keyframe(self, frame: Frame):
        store = self.store
        st = frame.state
        # velocity/bias prior information from the preintegration covariance
        # (KeyFrame.cpp:86-98)
        prior = np.zeros(9, np.float32)
        if frame.pre_from_kf is not None and self.imu_ready:
            C = np.asarray(frame.pre_from_kf.C)
            v_sig = np.sqrt(np.maximum(np.diagonal(C)[3:6], 1e-12))
            prior[0:3] = 1.0 / np.maximum(v_sig, 1e-6)
            prior[3:6] = 1e2  # gyro-bias prior
            prior[6:9] = 1e1  # acc-bias prior
        k = store.add_keyframe(
            frame.time, np.asarray(st.R_wb), np.asarray(st.t_wb),
            np.asarray(st.v), np.asarray(st.bg), np.asarray(st.ba),
            _feat_dict(frame), prior_inv_sigma=prior,
        )
        for f in np.nonzero(frame.pt_ids >= 0)[0]:
            store.add_observation(int(frame.pt_ids[f]), k, int(f))
        self.ref_kf = k
        frame.ref_kf = k
        self.last_kf_id = k
        self.last_kf_time = frame.time
        self.kf_tracked_count = frame.n_tracked
        self.frames_since_kf = 0
        self.kf_imu_buffer = ImuBuffer()
        store.kf_imu[k] = self.kf_imu_buffer
        if self.new_kf_callback:
            self.new_kf_callback(k)
            # synchronous mapper may have bundle-adjusted the map (including
            # this KF): re-sync the frame state so the next prediction starts
            # from the refined pose (the reference tracker re-reads the KF
            # pose under map_update_mutex for the same reason)
            frame.state = KfState(
                jnp.asarray(store.kf_R[k]), jnp.asarray(store.kf_t[k]),
                jnp.asarray(store.kf_v[k]), jnp.asarray(store.kf_bg[k]),
                jnp.asarray(store.kf_ba[k]),
            )

    # ------------------------------------------------------------------

    def update_after_gauge_change(self):
        """Called after the mapper rewrites the map gauge (inertial init):
        refresh the cached frame state from the newest KF (the reference's
        Tracking::updateFrameIMU analog, Tracking.cpp via LocalMapping.cpp:441-446)."""
        if self.last_frame is None or self.last_kf_id < 0:
            return
        k = self.last_kf_id
        self.last_frame.state = KfState(
            jnp.asarray(self.store.kf_R[k]), jnp.asarray(self.store.kf_t[k]),
            jnp.asarray(self.store.kf_v[k]), jnp.asarray(self.store.kf_bg[k]),
            jnp.asarray(self.store.kf_ba[k]),
        )
        self.velocity_rel = None
        self._state_jump = True

    def reset(self):
        self.state = NO_IMAGE
        self.imu_ready = False
        self.resume_prev_t = None
        self.last_frame = None
        self.init_frame = None
        self.ref_kf = -1
        self.last_kf_id = -1
        self.last_kf_time = -1e9
        self.kf_imu_buffer = ImuBuffer()
        self.velocity_rel = None
        self.lost_since = None
        self.frames_since_kf = 0


def _feat_dict(frame: Frame) -> dict:
    return {
        "xy": frame.xy, "level": frame.level, "angle": frame.angle,
        "desc": frame.desc, "valid": frame.valid, "sigma2": frame.sigma2,
        "group": frame.group,
    }
