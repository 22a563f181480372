"""Residual/factor library for the visual-inertial solver.

Analog of the reference factor library (modules/Backend/
G2oTypes.{h,cpp}): the same manifold conventions and residual definitions,
but expressed as pure functions over batched state arrays; Jacobians come
from `jax.jacfwd` composed with the retraction, so they are exact on the
manifold by construction (the reference hand-derives them,
G2oTypes.cpp:27-445).

State conventions (matching CameraImuPose, G2oTypes.cpp:10-25):
- keyframe/body state: R_wb [3,3], t_wb [3], v [3] (world velocity),
  bg [3], ba [3];  camera pose derived via IMU extrinsics:
  R_cw = R_cb R_wb^T, t_cw = t_cb - R_cw t_wb;
- pose tangent is right-multiplicative: R_wb <- R_wb Exp(dphi),
  t_wb <- t_wb + R_wb dt (G2oTypes.cpp:10-14), giving the 15-dim per-KF
  tangent [dphi(3), dt(3), dv(3), dbg(3), dba(3)];
- gravity direction is a 2-DoF SO(3) tangent around R_wg (G2oTypes.h:74-93);
- scale updates multiplicatively via exp (G2oTypes.h:203-205).

Inertial residuals are *whitened* with the preintegration covariance
Cholesky factor instead of carrying a 9x9 information matrix — equivalent
least-squares problem, far better conditioned in float32 (survey hard-part
(e)).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import numpy as np
import jax.numpy as jnp

from ..models.imu import GRAVITY_VALUE
from ..utils import lie

# numpy, not jnp: module-level DEVICE constants captured by jitted
# functions become hoisted runtime const buffers whose cache entries can
# go stale in jax 0.9 ("Execution supplied N buffers but compiled
# program expected M"); numpy constants are baked into the HLO instead
G_I = np.array([0.0, 0.0, -GRAVITY_VALUE], np.float32)


class KfState(NamedTuple):
    """Batched keyframe (or frame) state [..., ...]."""

    R_wb: jnp.ndarray  # [..., 3, 3]
    t_wb: jnp.ndarray  # [..., 3]
    v: jnp.ndarray  # [..., 3]
    bg: jnp.ndarray  # [..., 3]
    ba: jnp.ndarray  # [..., 3]

    @staticmethod
    def zeros(batch=()):
        return KfState(
            jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), (*batch, 3, 3)),
            jnp.zeros((*batch, 3), jnp.float32),
            jnp.zeros((*batch, 3), jnp.float32),
            jnp.zeros((*batch, 3), jnp.float32),
            jnp.zeros((*batch, 3), jnp.float32),
        )


def retract_kf(s: KfState, dx: jnp.ndarray) -> KfState:
    """Right-multiplicative 15-dim retraction (CameraImuPose::update).

    The returned rotation is re-projected onto SO(3) with one Newton polar
    step, R <- R (3I - R^T R)/2. This is load-bearing: the tracking loop
    feeds fitted states back through the motion model as
    R_pred = R_cur (R_last^T R_cur), which passes any symmetric
    off-manifold error component through TWICE — the f32 roundoff seed
    (~1e-7) doubles every frame and reaches 1e-1 within ~20 frames,
    warping every reprojection while right-multiplicative LM steps are
    powerless to remove a left-side non-rotation factor (measured: the
    round-1 ~1 s tracking collapse, STATUS.md). One Newton step maps
    error eps -> O(eps^2), pinning the chain at machine noise.
    """
    dphi, dt, dv, dbg, dba = dx[..., 0:3], dx[..., 3:6], dx[..., 6:9], dx[..., 9:12], dx[..., 12:15]
    R = s.R_wb @ lie.exp_so3(dphi)
    RtR = jnp.einsum("...ji,...jk->...ik", R, R)
    R = 0.5 * (3.0 * R - jnp.einsum("...ij,...jk->...ik", R, RtR))
    t = s.t_wb + jnp.einsum("...ij,...j->...i", s.R_wb, dt)
    return KfState(R, t, s.v + dv, s.bg + dbg, s.ba + dba)


def camera_pose(s: KfState, R_cb, t_cb):
    """Body state -> (R_cw, t_cw)."""
    R_cw = R_cb @ jnp.swapaxes(s.R_wb, -1, -2)
    t_cw = t_cb - jnp.einsum("...ij,...j->...i", R_cw, s.t_wb)
    return R_cw, t_cw


def reprojection_residual(s: KfState, p_w: jnp.ndarray, uv: jnp.ndarray,
                          camera, R_cb, t_cb) -> jnp.ndarray:
    """Monocular reprojection residual [..., 2] (EdgeMono,
    G2oTypes.cpp:59-69): project(R_cw p_w + t_cw) - uv."""
    R_cw, t_cw = camera_pose(s, R_cb, t_cb)
    pc = jnp.einsum("...ij,...j->...i", R_cw, p_w) + t_cw
    return camera.project(pc) - uv


def point_depth(s: KfState, p_w: jnp.ndarray, R_cb, t_cb) -> jnp.ndarray:
    R_cw, t_cw = camera_pose(s, R_cb, t_cb)
    pc = jnp.einsum("...ij,...j->...i", R_cw, p_w) + t_cw
    return pc[..., 2]


class PreintEdge(NamedTuple):
    """Per-edge preintegration data, stackable over [E] edges."""

    dR: jnp.ndarray  # [..., 3, 3]
    dV: jnp.ndarray
    dP: jnp.ndarray
    JRg: jnp.ndarray
    JVg: jnp.ndarray
    JVa: jnp.ndarray
    JPg: jnp.ndarray
    JPa: jnp.ndarray
    bg0: jnp.ndarray  # linearization biases
    ba0: jnp.ndarray
    dt: jnp.ndarray  # [...]
    L_inv: jnp.ndarray  # [..., 9, 9] inverse Cholesky factor of C[:9,:9] (whitener)

    # Integration-noise floor (per-edge sigmas: kr*dt [rad], kv*dt [m/s],
    # kp*dt^2 [m]): the propagated covariance models SENSOR noise only,
    # but rectangular integration of a rotating specific force leaves a
    # DISCRETIZATION error ~0.5*|w||f|*dt_sample per second — measured on
    # the circle world: |ep| ~ 0.3 mm per 0.25 s edge against a claimed
    # sigma_dP of ~5 um, i.e. the whitening was ~60x overconfident. BA
    # then trusts the IMU chain over the visual anchors and the solution
    # follows IMU dead-reckoning: position drift INTEGRATES (measured
    # 84 cm ATE over 25 s; scaling the edge weights by 0.05 gave 5 cm).
    # The reference inherits the same formulation but its real-IMU noise
    # densities dominate its discretization error; on clean data the
    # floor is what keeps the MAP estimate consistent.
    INT_NOISE_R = 5e-4   # rad/s of edge duration (gyro integration is
    #                      near-exact for slowly-rotating axes; a coarse
    #                      rotation floor washes out the init's bias signal)
    INT_NOISE_V = 8e-3   # (m/s)/s of edge duration
    INT_NOISE_P = 6e-3   # m/s^2 -> sigma_p = kp * dt^2
    # The discretization error the floor models is ~0.5*|w||f|*dt_sample —
    # PROPORTIONAL TO THE ROTATION RATE. The constants above were
    # calibrated on the rotating circle world (|w| ~ 0.5 rad/s); applying
    # them unscaled to a rotation-free stretch (the corridor/KITTI
    # forward regime, |w| ~ 0) de-weights the inertial edges ~10x below
    # what the physics requires, and those edges are the ONLY restoring
    # force against the mono-VI velocity-gauge leak (inertial edges
    # measure velocity CHANGES; a slowly contracting velocity chain costs
    # each edge only drift_rate*dt against sigma_v — measured on the
    # corridor world: mean-speed gauge halves every ~7 s, old points then
    # project 100+ px off and the map starves). Scale the floor by the
    # edge's own measured rotation rate, clamped to [0.1, 1] of the
    # calibrated value; the sensor-noise covariance underneath is always
    # retained, so a tight floor can never overstate confidence beyond
    # the true sensor limit.
    INT_NOISE_W_REF = 0.5   # rad/s at which the calibrated floor applies
    # 0.25, not lower: at 0.1 the whitened ev sigma reaches ~0.2 mm/s and
    # ordinary visual velocity noise turns window starts into 100+ sigma
    # states — measured cost blowups to 1e7 with the LM unable to descend
    INT_NOISE_MIN_FRAC = 0.25

    @staticmethod
    def from_preintegrated(pre, eps: float = 1e-12):
        """Build a whitening edge from a models.imu.Preintegrated pytree."""
        C9 = pre.C[..., :9, :9]
        C9 = 0.5 * (C9 + jnp.swapaxes(C9, -1, -2))
        dt = pre.dt[..., None]
        # per-edge rotation rate from the preintegrated dR (trace formula;
        # arccos-free away from 0 is unnecessary — this is a weight, not a
        # differentiated quantity, but keep the clamp for JVP safety)
        tr = (pre.dR[..., 0, 0] + pre.dR[..., 1, 1] + pre.dR[..., 2, 2])
        cos_th = jnp.clip(0.5 * (tr - 1.0), -1.0 + 1e-6, 1.0 - 1e-6)
        theta = jnp.arccos(cos_th)
        rate = theta / jnp.maximum(pre.dt, 1e-3)
        frac = jnp.clip(rate / PreintEdge.INT_NOISE_W_REF,
                        PreintEdge.INT_NOISE_MIN_FRAC, 1.0)[..., None]
        floor = frac ** 2 * jnp.concatenate([
            jnp.broadcast_to((PreintEdge.INT_NOISE_R * dt) ** 2, dt.shape[:-1] + (3,)),
            jnp.broadcast_to((PreintEdge.INT_NOISE_V * dt) ** 2, dt.shape[:-1] + (3,)),
            jnp.broadcast_to((PreintEdge.INT_NOISE_P * dt * dt) ** 2, dt.shape[:-1] + (3,)),
        ], axis=-1)
        C9 = C9 + floor[..., None] * jnp.eye(9, dtype=jnp.float32)
        # scale-normalized Cholesky for f32 robustness
        tr = jnp.trace(C9, axis1=-2, axis2=-1) / 9.0
        s = jnp.maximum(tr, eps)
        Cn = C9 / s[..., None, None] + 1e-8 * jnp.eye(9, dtype=jnp.float32)
        L = jnp.linalg.cholesky(Cn)
        L_inv = jax.scipy.linalg.solve_triangular(
            L, jnp.broadcast_to(jnp.eye(9, dtype=jnp.float32), L.shape), lower=True
        ) / jnp.sqrt(s)[..., None, None]
        return PreintEdge(
            pre.dR, pre.dV, pre.dP, pre.JRg, pre.JVg, pre.JVa, pre.JPg, pre.JPa,
            pre.bg, pre.ba, pre.dt, L_inv,
        )

    def corrected(self, bg: jnp.ndarray, ba: jnp.ndarray):
        """First-order bias-corrected deltas (Imu.cpp:182-204)."""
        dbg = bg - self.bg0
        dba = ba - self.ba0
        dR = self.dR @ lie.exp_so3(jnp.einsum("...ij,...j->...i", self.JRg, dbg))
        dV = self.dV + jnp.einsum("...ij,...j->...i", self.JVg, dbg) \
            + jnp.einsum("...ij,...j->...i", self.JVa, dba)
        dP = self.dP + jnp.einsum("...ij,...j->...i", self.JPg, dbg) \
            + jnp.einsum("...ij,...j->...i", self.JPa, dba)
        return dR, dV, dP


def inertial_residual(s1: KfState, s2: KfState, edge: PreintEdge,
                      whiten: bool = True) -> jnp.ndarray:
    """9-D preintegration residual between consecutive states (EdgeInertial,
    G2oTypes.cpp:358-445), whitened by the covariance Cholesky."""
    dR, dV, dP = edge.corrected(s1.bg, s1.ba)
    Rb1w = jnp.swapaxes(s1.R_wb, -1, -2)
    dt = edge.dt[..., None]
    er = lie.log_so3(jnp.swapaxes(dR, -1, -2) @ Rb1w @ s2.R_wb)
    ev = jnp.einsum("...ij,...j->...i", Rb1w, s2.v - s1.v - G_I * dt) - dV
    ep = jnp.einsum(
        "...ij,...j->...i", Rb1w,
        s2.t_wb - s1.t_wb - s1.v * dt - 0.5 * G_I * dt * dt,
    ) - dP
    r = jnp.concatenate([er, ev, ep], axis=-1)
    if whiten:
        r = jnp.einsum("...ij,...j->...i", edge.L_inv, r)
    return r


def inertial_gs_residual(s1: KfState, s2: KfState, edge: PreintEdge,
                         R_wg: jnp.ndarray, log_scale: jnp.ndarray,
                         whiten: bool = True) -> jnp.ndarray:
    """9-D inertial residual with free gravity direction + global scale
    (EdgeInertialGS, G2oTypes.cpp:71-163). Poses are treated as fixed
    monocular-gauge poses: translations scale by exp(log_scale), gravity is
    R_wg @ (0, 0, -G)."""
    g = jnp.einsum("...ij,...j->...i", R_wg, G_I)
    scale = jnp.exp(log_scale)
    dR, dV, dP = edge.corrected(s1.bg, s1.ba)
    Rb1w = jnp.swapaxes(s1.R_wb, -1, -2)
    dt = edge.dt[..., None]
    er = lie.log_so3(jnp.swapaxes(dR, -1, -2) @ Rb1w @ s2.R_wb)
    ev = jnp.einsum("...ij,...j->...i", Rb1w, scale * (s2.v - s1.v) - g * dt) - dV
    ep = jnp.einsum(
        "...ij,...j->...i", Rb1w,
        scale * (s2.t_wb - s1.t_wb - s1.v * dt) - 0.5 * g * dt * dt,
    ) - dP
    r = jnp.concatenate([er, ev, ep], axis=-1)
    if whiten:
        r = jnp.einsum("...ij,...j->...i", edge.L_inv, r)
    return r


def gravity_rotation(theta: jnp.ndarray, R_wg0: jnp.ndarray) -> jnp.ndarray:
    """2-DoF gravity-direction retraction (VertexGravity, G2oTypes.h:74-93):
    R_wg = R_wg0 Exp([theta_x, theta_y, 0])."""
    w = jnp.concatenate([theta, jnp.zeros_like(theta[..., :1])], axis=-1)
    return R_wg0 @ lie.exp_so3(w)


def bias_walk_residual(s1: KfState, s2: KfState, inv_sigma_walk: jnp.ndarray) -> jnp.ndarray:
    """6-D random-walk residual between consecutive KFs (EdgeBiasWalk,
    G2oTypes.h:452-483), pre-whitened by the walk stddev."""
    r = jnp.concatenate([s2.bg - s1.bg, s2.ba - s1.ba], axis=-1)
    return r * inv_sigma_walk


def prior_residual(x: jnp.ndarray, x0: jnp.ndarray, inv_sigma: jnp.ndarray) -> jnp.ndarray:
    """Whitened prior (EdgePriori3D, G2oTypes.h:324-343)."""
    return (x - x0) * inv_sigma


def huber_weight(chi2: jnp.ndarray, delta2: float) -> jnp.ndarray:
    """IRLS Huber weight for squared error chi2 with threshold delta^2."""
    return jnp.where(chi2 <= delta2, 1.0, jnp.sqrt(delta2 / jnp.maximum(chi2, 1e-20)))


def huber_cost(chi2: jnp.ndarray, delta2: float) -> jnp.ndarray:
    """Huber rho(chi2) (g2o RobustKernelHuber convention)."""
    d = jnp.sqrt(delta2)
    e = jnp.sqrt(jnp.maximum(chi2, 0.0))
    return jnp.where(chi2 <= delta2, chi2, 2.0 * d * e - delta2)
