"""Levenberg-Marquardt Schur-complement bundle adjustment.

Replacement for g2o (reference links g2o_core/g2o_types_sba,
CMakeLists.txt:29; problems in modules/Backend/Optimize.cpp):

- `schur_ba`: structured visual(-inertial) bundle adjustment. Landmarks are
  eliminated with a batched 3x3-block Schur complement; the reduced camera
  system (<= K x 15 dims) is solved densely with one Cholesky, so the
  sparse block solvers g2o needs on CPU (Optimize.h:17-20) are
  unnecessary. The Schur reduction is expressed as dense [P, K] einsums
  rather than per-point pair loops.

Everything is fixed-shape and jit-compiled; variable problem sizes are
handled by validity masks (SURVEY.md §7 hard-part (a)).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import numpy as np
import jax.numpy as jnp

from ..utils import lie
from ..utils.precision import f32_matmuls
from . import residuals as res
from .residuals import KfState, PreintEdge

CHI2_MONO = 5.991  # 2-DoF 95% gate (Optimize.cpp poseOptimize chi2)

# damping candidates tried in parallel each LM iteration (relative to the
# carried lambda): one relax and one escalate. Every extra damping adds a
# batched reduced-system Cholesky, while the carried-lambda adaptation
# makes wider grids redundant: 2-, 3- and 4-point grids converge to
# identical cost on the bench window (cost 1118.6 after 10 iters for all
# of them).
# numpy, not jnp — device constants hoist as stale-able const buffers (jax 0.9)
LAM_GRID = np.array([0.3, 3.0], np.float32)


# ---------------------------------------------------------------------------
# Schur-complement bundle adjustment
# ---------------------------------------------------------------------------


class BAProblem(NamedTuple):
    """Fixed-capacity BA problem. K keyframes, P points, O observations,
    E inertial edges. Build with backend.problems helpers."""

    kf: KfState  # [K]
    kf_dof: jnp.ndarray  # [K, 15] float 0/1 per-dim free mask
    points: jnp.ndarray  # [P, 3]
    pt_active: jnp.ndarray  # [P] bool (False = fixed or padding)
    obs_kf: jnp.ndarray  # [O] int32
    obs_pt: jnp.ndarray  # [O] int32
    obs_uv: jnp.ndarray  # [O, 2]
    obs_inv_sigma2: jnp.ndarray  # [O]
    obs_valid: jnp.ndarray  # [O] bool
    ie_i: jnp.ndarray  # [E] int32
    ie_j: jnp.ndarray  # [E] int32
    ie_edge: PreintEdge  # [E]
    ie_valid: jnp.ndarray  # [E] bool
    walk_inv_sigma: jnp.ndarray  # [E, 6]
    walk_valid: jnp.ndarray  # [E] bool
    prior_inv_sigma: jnp.ndarray  # [K, 15] diag prior weights (0 = no prior)
    prior_ref: KfState  # [K] prior center


def _gather_kf(kf: KfState, idx) -> KfState:
    return jax.tree_util.tree_map(lambda a: a[idx], kf)


def inv3x3(M: jnp.ndarray) -> jnp.ndarray:
    """Closed-form batched 3x3 inverse (adjugate/det) — elementwise, far
    cheaper than a batched LU factorization for these tiny blocks."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-20, 1e-20, det)
    adj = jnp.stack([
        jnp.stack([A, -(b * i - c * h), b * f - c * e], -1),
        jnp.stack([B, a * i - c * g, -(a * f - c * d)], -1),
        jnp.stack([C, -(a * h - b * g), a * e - b * d], -1),
    ], -2)
    return adj * inv_det[..., None, None]


def _inv_spd_block(M: jnp.ndarray, n1: int, inv_a, inv_s) -> jnp.ndarray:
    """Blockwise SPD inverse via the Schur complement:
    [[A, B], [B^T, D]]^-1 with A (n1 x n1) inverted by `inv_a` and the
    Schur complement S = D - B^T A^-1 B inverted by `inv_s`."""
    A = M[..., :n1, :n1]
    B = M[..., :n1, n1:]
    D = M[..., n1:, n1:]
    Ai = inv_a(A)
    AiB = Ai @ B
    S = D - jnp.swapaxes(B, -1, -2) @ AiB
    Si = inv_s(S)
    TR = -AiB @ Si
    TL = Ai - TR @ jnp.swapaxes(AiB, -1, -2)
    top = jnp.concatenate([TL, TR], axis=-1)
    bot = jnp.concatenate([jnp.swapaxes(TR, -1, -2), Si], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def inv_spd6(M):
    return _inv_spd_block(M, 3, inv3x3, inv3x3)


def inv_spd9(M):
    return _inv_spd_block(M, 3, inv3x3, inv_spd6)


def inv_spd15(M):
    """Closed-form batched 15x15 SPD inverse (nested 3x3 Schur blocks).

    Replacement for batched LU on the frame optimizer's damped
    normal equations: every operation is a small matmul or elementwise op
    (trivially batchable over LM damping candidates),
    whereas lax.linalg.lu serializes. Callers must Jacobi-normalize first
    for f32 conditioning (see solve_spd15_jacobi)."""
    return _inv_spd_block(M, 6, inv_spd6, inv_spd9)


def inv_spd_blocks15(M: jnp.ndarray, kb: int) -> jnp.ndarray:
    """SPD inverse of a [..., 15*kb, 15*kb] matrix by recursing the
    blockwise Schur identity down to closed-form 15-dim blocks.

    The whole inverse is ~2*log2(kb) levels of dense matmuls
    (trivially batchable), vs the panel-serial blocked Cholesky.
    CAUTION: on visual-inertial reduced camera
    systems the post-Jacobi conditioning defeats this closed form in f32
    (velocity errors 3x the Cholesky path, not repairable by iterative
    refinement or Newton-Schulz — measured 2026-08-17), which is why
    schur_ba uses Cholesky. Kept for well-conditioned dense SPD uses;
    callers must Jacobi-normalize + damp first."""
    if kb == 1:
        return inv_spd15(M)
    k1 = (kb + 1) // 2
    return _inv_spd_block(
        M, 15 * k1,
        lambda A: inv_spd_blocks15(A, k1),
        lambda Sx: inv_spd_blocks15(Sx, kb - k1),
    )


def solve_spd15_jacobi(H: jnp.ndarray, g: jnp.ndarray) -> jnp.ndarray:
    """x = H^-1 g for batched damped-SPD 15x15 systems, with Jacobi
    pre/post-scaling for f32 robustness."""
    d = jnp.sqrt(jnp.maximum(jnp.abs(jnp.diagonal(H, axis1=-2, axis2=-1)), 1e-12))
    Hn = H / (d[..., :, None] * d[..., None, :])
    return (inv_spd15(Hn) @ (g / d)[..., None]).squeeze(-1) / d


def _vis_residuals(problem: BAProblem, camera, R_cb, t_cb, huber_delta2,
                   valid_override=None):
    """Residual-only evaluation (no Jacobians) — used for LM cost checks.

    `valid_override`: evaluate the cost over THIS observation set instead
    of the state-dependent depth gate. LM candidate costing must pass the
    linearization state's mask: with the state-dependent gate, a garbage
    step that flings points behind the cameras silently REMOVES their
    observations from the cost and gets accepted on an artificially tiny
    value (measured: cost 0.01 with 2.5-degree pose errors). Under a fixed
    mask, cheirality-breaking candidates instead produce huge/non-finite
    chi2, which is clipped to a large penalty and rejected."""
    s_o = _gather_kf(problem.kf, problem.obs_kf)
    p_o = problem.points[problem.obs_pt]
    r0 = res.reprojection_residual(s_o, p_o, problem.obs_uv, camera, R_cb, t_cb)
    depth = res.point_depth(s_o, p_o, R_cb, t_cb)
    if valid_override is None:
        valid = problem.obs_valid & (depth > 0.05)
    else:
        valid = valid_override
    chi2 = jnp.sum(r0 * r0, axis=-1) * problem.obs_inv_sigma2
    chi2 = jnp.where(jnp.isfinite(chi2) & (depth > 1e-4), chi2, 1e12)
    cost = jnp.sum(jnp.where(valid, res.huber_cost(chi2, huber_delta2), 0.0))
    return chi2, cost


def _vis_linearize(problem: BAProblem, camera, R_cb, t_cb, huber_delta2):
    """Per-observation residual + analytic Jacobians at the current state.

    Right-multiplicative pose tangent (retract_kf): with
    p_b = R_wb^T (p_w - t_wb) and p_c = R_cb p_b + t_cb,
      d p_c / d phi = R_cb hat(p_b),  d p_c / d t = -R_cb,
      d p_c / d p_w = R_cw = R_cb R_wb^T,
    and J = Jproj(p_c) composed with the above (the same chain the
    reference hand-derives in G2oTypes.cpp:59-69). Verified against jacfwd
    in tests/test_solver.py."""
    s_o = _gather_kf(problem.kf, problem.obs_kf)  # [O]
    p_o = problem.points[problem.obs_pt]

    p_b = jnp.einsum("oji,oj->oi", s_o.R_wb, p_o - s_o.t_wb)  # R_wb^T (p - t)
    p_c = p_b @ R_cb.T + t_cb
    r0 = camera.project(p_c) - problem.obs_uv  # [O, 2]

    Jproj = camera.proj_jacobian(p_c)  # [O, 2, 3]
    Jproj_Rcb = jnp.einsum("oij,jk->oik", Jproj, R_cb)  # [O, 2, 3]
    # compact pose-block Jacobian: visual residuals touch only the 6 pose
    # dims [dphi, dt] of the 15-dim KF tangent — keeping the zero columns
    # out lets the whole Schur pipeline (W scatter, Y product, the reduced
    # correction matmul) run on K*6 instead of K*15, a 2.5x saving
    Jc = jnp.concatenate([
        jnp.einsum("oij,ojk->oik", Jproj_Rcb, lie.hat(p_b)),
        -Jproj_Rcb,
    ], axis=-1)  # [O, 2, 6]
    R_cw = jnp.einsum("ij,okj->oik", R_cb, s_o.R_wb)  # [O, 3, 3]
    Jl = jnp.einsum("oij,ojk->oik", Jproj, R_cw)  # [O, 2, 3]

    depth = res.point_depth(s_o, p_o, R_cb, t_cb)
    base_valid = problem.obs_valid & (depth > 0.05)
    chi2 = jnp.sum(r0 * r0, axis=-1) * problem.obs_inv_sigma2
    w = (
        base_valid.astype(jnp.float32)
        * problem.obs_inv_sigma2
        * res.huber_weight(chi2, huber_delta2)
    )
    cost = jnp.sum(
        jnp.where(base_valid, res.huber_cost(chi2, huber_delta2), 0.0)
    )
    return r0, Jc, Jl, w, chi2, cost


def _inertial_linearize(problem: BAProblem):
    """Analytic Jacobians of the whitened 9-D preintegration residual wrt
    the 15-dim right-multiplicative tangent of each endpoint — the same
    hand derivation as the reference's EdgeInertial::linearizeOplus
    (G2oTypes.cpp:358-445), batched over edges. Replacing the per-edge
    `jacfwd` (30 forward re-evaluations of the residual, each a chain of
    tiny kernels) with ~15 batched einsums removes most of the backend
    linearization latency. Verified against jacfwd in
    tests/test_solver.py::test_analytic_inertial_jacobians_match_jacfwd."""
    s1 = _gather_kf(problem.kf, problem.ie_i)
    s2 = _gather_kf(problem.kf, problem.ie_j)
    e = problem.ie_edge
    E = problem.ie_i.shape[0]

    dbg = s1.bg - e.bg0
    dba = s1.ba - e.ba0
    Rb1w = jnp.swapaxes(s1.R_wb, -1, -2)
    dt = e.dt[..., None]

    # LATENCY NOTE: at SLAM edge counts (E ~ 32) every dot_general costs
    # ~10-40 us of dispatch regardless of FLOPs, so the ~15 small per-edge
    # matmuls of the straightforward form are stacked into a handful of
    # batched ones, grouped by dependency level.

    # level 0 — all matvecs available directly from the inputs, one dot:
    # bias-correction terms (Imu.cpp:182-204) + the frame-1 rotations of
    # the velocity/position mismatches
    dv_w = s2.v - s1.v - res.G_I * dt
    dp_w = s2.t_wb - s1.t_wb - s1.v * dt - 0.5 * res.G_I * dt * dt
    mats = jnp.stack([e.JRg, e.JVg, e.JVa, e.JPg, e.JPa, Rb1w, Rb1w], 1)
    vecs = jnp.stack([dbg, dbg, dba, dbg, dba, dv_w, dp_w], 1)
    mv = jnp.einsum("ecij,ecj->eci", mats, vecs)
    jrg_dbg = mv[:, 0]
    dV = e.dV + mv[:, 1] + mv[:, 2]
    dP = e.dP + mv[:, 3] + mv[:, 4]
    ev_arg, ep_arg = mv[:, 5], mv[:, 6]

    # Rotation chain eR = exp(JRg dbg)^T (dR^T R1^T R2) and its two Jacobian
    # blocks, restructured so same-dependency-level [E,3,3] products share
    # ONE stacked batched matmul each (6 dispatches instead of 10 — at SLAM
    # edge counts each batched 3x3 matmul is pure dispatch latency):
    R2 = s2.R_wb
    # lvl0: M = R1^T R2 (M^T = R21, reused in the pose blocks); X = dR^T R1^T
    MX = jnp.einsum("ecij,ecjk->ecik",
                    jnp.stack([Rb1w, jnp.swapaxes(e.dR, -1, -2)], 1),
                    jnp.stack([R2, Rb1w], 1))
    M, X = MX[:, 0], MX[:, 1]
    # lvl1: dRtM = X R2 = dR^T R1^T R2 ; Wg^2 for exp/Jr of jrg_dbg
    Wg = lie.hat(jrg_dbg)
    S1 = jnp.einsum("ecij,ecjk->ecik", jnp.stack([X, Wg], 1),
                    jnp.stack([R2, Wg], 1))
    dRtM, W2g = S1[:, 0], S1[:, 1]
    Ag, Bg, Cg = lie.exp_jr_coeffs(jrg_dbg)
    eye3 = jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), Wg.shape)
    expg = eye3 + Ag[..., None, None] * Wg + Bg[..., None, None] * W2g
    Jrg = eye3 - Bg[..., None, None] * Wg + Cg[..., None, None] * W2g
    # lvl2: eR = exp^T dRtM ; P = Jr(JRg dbg) JRg
    S2 = jnp.einsum("ecij,ecjk->ecik",
                    jnp.stack([jnp.swapaxes(expg, -1, -2), Jrg], 1),
                    jnp.stack([dRtM, e.JRg], 1))
    eR, P = S2[:, 0], S2[:, 1]
    er = lie.log_so3(eR)
    ev = ev_arg - dV
    ep = ep_arg - dP
    # lvl3: Q = eR^T P (the d er/d dbg1 chain, G2oTypes.cpp:358-445);
    # We^2 for Jr(er)^-1
    We = lie.hat(er)
    S3 = jnp.einsum("ecij,ecjk->ecik",
                    jnp.stack([jnp.swapaxes(eR, -1, -2), We], 1),
                    jnp.stack([P, We], 1))
    Q, W2e = S3[:, 0], S3[:, 1]
    De = lie.inv_jr_coeff(er)
    invJr = eye3 + 0.5 * We + De[..., None, None] * W2e
    # lvl4: both -invJr products in one stacked matmul
    ij2 = -invJr[:, None] @ jnp.stack([Q, jnp.swapaxes(M, -1, -2)], 1)
    der_dbg, mijR21 = ij2[:, 0], ij2[:, 1]

    Z3 = jnp.zeros((E, 3, 3), jnp.float32)

    # unwhitened block rows [er; ev; ep] x cols [phi, dt, dv, dbg, dba]
    J1 = jnp.concatenate([
        jnp.concatenate([mijR21, Z3, Z3, der_dbg, Z3], -1),
        jnp.concatenate([lie.hat(ev_arg), Z3, -Rb1w, -e.JVg, -e.JVa], -1),
        jnp.concatenate([lie.hat(ep_arg), -jnp.broadcast_to(
            jnp.eye(3, dtype=jnp.float32), (E, 3, 3)), -Rb1w * dt[..., None],
            -e.JPg, -e.JPa], -1),
    ], -2)
    J2 = jnp.concatenate([
        jnp.concatenate([invJr, Z3, Z3, Z3, Z3], -1),
        jnp.concatenate([Z3, Z3, Rb1w, Z3, Z3], -1),
        jnp.concatenate([Z3, M, Z3, Z3, Z3], -1),
    ], -2)
    # whiten residual + both Jacobians in ONE dot: [E,9,9] @ [E,9,31]
    r9 = jnp.concatenate([er, ev, ep], -1)
    W = e.L_inv @ jnp.concatenate([r9[..., None], J1, J2], -1)
    r0, J1, J2 = W[..., 0], W[..., 1:16], W[..., 16:31]

    w = problem.ie_valid.astype(jnp.float32)
    cost = jnp.sum(w * jnp.sum(r0 * r0, axis=-1))
    return r0, J1, J2, w, cost


def _walk_linearize(problem: BAProblem):
    s1 = _gather_kf(problem.kf, problem.ie_i)
    s2 = _gather_kf(problem.kf, problem.ie_j)
    r0 = res.bias_walk_residual(s1, s2, problem.walk_inv_sigma)  # [E, 6]
    # J wrt dims 9:15 of each endpoint: d r / d bg2 = +inv_sigma etc.
    E = r0.shape[0]
    J1 = jnp.zeros((E, 6, 15), jnp.float32)
    J2 = jnp.zeros((E, 6, 15), jnp.float32)
    eye6 = jnp.eye(6, dtype=jnp.float32)
    J1 = J1.at[:, :, 9:15].set(-problem.walk_inv_sigma[:, :, None] * eye6[None])
    J2 = J2.at[:, :, 9:15].set(problem.walk_inv_sigma[:, :, None] * eye6[None])
    w = problem.walk_valid.astype(jnp.float32)
    cost = jnp.sum(w * jnp.sum(r0 * r0, axis=-1))
    return r0, J1, J2, w, cost


def _prior_linearize(problem: BAProblem):
    """Diagonal priors on the euclidean dims (v, bg, ba) of each KF."""
    x = jnp.concatenate([problem.kf.v, problem.kf.bg, problem.kf.ba], axis=-1)  # [K, 9]
    x0 = jnp.concatenate(
        [problem.prior_ref.v, problem.prior_ref.bg, problem.prior_ref.ba], axis=-1
    )
    inv_sigma = problem.prior_inv_sigma[:, 6:15]
    r = (x - x0) * inv_sigma  # [K, 9] whitened
    cost = jnp.sum(r * r)
    return r, inv_sigma, cost


def _total_cost(problem: BAProblem, camera, R_cb, t_cb, huber_delta2,
                valid_override=None):
    _, c_vis = _vis_residuals(problem, camera, R_cb, t_cb, huber_delta2,
                              valid_override)
    s1 = _gather_kf(problem.kf, problem.ie_i)
    s2 = _gather_kf(problem.kf, problem.ie_j)
    r_e = res.inertial_residual(s1, s2, problem.ie_edge)
    c_ie = jnp.sum(problem.ie_valid.astype(jnp.float32) * jnp.sum(r_e * r_e, -1))
    r_w = res.bias_walk_residual(s1, s2, problem.walk_inv_sigma)
    c_walk = jnp.sum(problem.walk_valid.astype(jnp.float32) * jnp.sum(r_w * r_w, -1))
    _, _, c_prior = _prior_linearize(problem)
    return c_vis + c_ie + c_walk + c_prior


def _scatter_edge_blocks(Hcc, b_c, ie_i, ie_j, families):
    """Accumulate binary-edge Gauss-Newton blocks into the dense camera
    Hessian with a single concatenated scatter-add (fewer, larger
    scatters beat many tiny ones).

    families: iterable of (r [E,R], Ja [E,R,15], Jb [E,R,15], w [E])."""
    rows_a, rows_b, Hv, bv = [], [], [], []
    for (rr, Ja, Jb, ww) in families:
        JaW = Ja * ww[:, None, None]
        JbW = Jb * ww[:, None, None]
        # stack the four block products along a new leading axis -> one
        # einsum pair instead of four + two
        L = jnp.stack([JaW, JaW, JbW, JbW])  # [4, E, R, 15]
        Rj = jnp.stack([Ja, Jb, Ja, Jb])
        Hv.append(jnp.einsum("feik,feil->fekl", L, Rj).reshape(-1, 15, 15))
        bv.append(-jnp.einsum("feik,ei->fek",
                              jnp.stack([JaW, JbW]), rr).reshape(-1, 15))
        rows_a.extend([ie_i, ie_i, ie_j, ie_j])
        rows_b.extend([ie_i, ie_j, ie_i, ie_j])
    idx_a = jnp.concatenate(rows_a)
    idx_b = jnp.concatenate(rows_b)
    Hcc = Hcc.at[idx_a, idx_b].add(jnp.concatenate(Hv))
    idx_g = jnp.concatenate([ie_i, ie_j] * len(families))
    b_c = b_c.at[idx_g].add(jnp.concatenate(bv))
    return Hcc, b_c


def _retract_problem(problem: BAProblem, dx_c, dx_l) -> BAProblem:
    kf = res.retract_kf(problem.kf, dx_c * problem.kf_dof)
    pts = problem.points + dx_l * problem.pt_active[:, None]
    return problem._replace(kf=kf, points=pts)


def visual_block_sums(B, obs_kf, obs_pt, K: int, P: int):
    """Sums of the per-observation visual blocks B = (w Ja)^T Ja [O, 10, 10]
    (Ja = [Jc | Jl | -r], see schur_ba) into the normal equations.

    Returns (camk [K, 42] per-KF [Hc(36) | bc(6)], ptk [P, 12] per-point
    [Hll(9) | bl(3)], W_p [P, K*6, 3] pose-landmark coupling). Each is a
    segment sum / scatter-add in f32: exact summands, f32 accumulation in
    any order. A one-hot matmul formulation of the same sums runs in TF32
    on the GPU at DEFAULT or HIGH precision (relative errors up to 3.4e-4
    at the bench window on an H100) and at HIGHEST took 3x the scatter's
    time there. Invalid observations carry w = 0, so their rows add
    nothing wherever they point."""
    O = B.shape[0]
    camk = jax.ops.segment_sum(jnp.concatenate([
        B[:, :6, :6].reshape(O, 36),   # Hc
        B[:, :6, 9:10].reshape(O, 6),  # bc = -(w Jc)^T r
    ], -1), obs_kf, num_segments=K)
    ptk = jax.ops.segment_sum(jnp.concatenate([
        B[:, 6:9, 6:9].reshape(O, 9),   # Hll
        B[:, 6:9, 9:10].reshape(O, 3),  # bl
    ], -1), obs_pt, num_segments=P)
    # dense pose-landmark coupling in [P, K*6, 3] layout; downstream
    # contractions use dot_general over (p, v) directly, so no large
    # transposes materialize
    W_p = jnp.zeros((P, K, 18), jnp.float32).at[obs_pt, obs_kf].add(
        B[:, :6, 6:9].reshape(O, 18))
    return camk, ptk, W_p.reshape(P, K * 6, 3)


@partial(jax.jit, static_argnames=("n_iters", "huber_delta2", "deferred"))
@f32_matmuls
def schur_ba(problem: BAProblem, camera, R_cb, t_cb,
             n_iters: int = 10, huber_delta2: float = CHI2_MONO,
             lambda0: float = 1e-4, deferred: bool = True):
    """Visual(-inertial) BA with landmark Schur elimination.

    Returns (kf [K] KfState, points [P, 3], info dict with final chi2 per
    obs + costs).

    `deferred=True` (default) selects the zero-cost-pass LM: ONE damping
    per iteration, with accept/reject decided by the NEXT iteration's
    linearization cost (which is computed anyway) — a rejected step
    reverts the state and re-linearizes at the kept optimum with a larger
    lambda. This drops both the per-iteration candidate cost pass and the
    second damped Cholesky (the two biggest latency items after the
    linearize itself); a rejection costs one wasted linearize, which is
    rare once the iterate is in the LM basin; both variants reach the
    identical converged cost on the bench window. `deferred=False` keeps
    the 2-candidate parallel-lambda variant.

    Observations may come in any order: the assembly is a segment sum
    (`visual_block_sums`), so the flat and the grouped per-KF window
    layouts (problems.build_window_problem) solve through the same code."""
    K = problem.kf_dof.shape[0]
    P = problem.points.shape[0]

    def linearize_assemble(pb: BAProblem):
        r_v, Jc, Jl, w_v, chi2_v, c_vis = _vis_linearize(pb, camera, R_cb, t_cb, huber_delta2)
        r_e, J1, J2, w_e, c_ie = _inertial_linearize(pb)
        r_w, Jw1, Jw2, w_w, c_walk = _walk_linearize(pb)
        r_p, pr_inv_sigma, c_prior = _prior_linearize(pb)
        cost_here = c_vis + c_ie + c_walk + c_prior

        # ---- visual blocks (Jc touches only the 6 pose dims) ----
        # ONE augmented-Jacobian product B = (w Ja)^T Ja with
        # Ja = [Jc | Jl | -r] — its sub-blocks are ALL of Hc, Hll, W, bc
        # and bl at once — then one pass of segment sums
        Ja = jnp.concatenate([Jc, Jl, -r_v[:, :, None]], -1)  # [O, 2, 10]
        B = jnp.einsum("oik,oil->okl", Ja * w_v[:, None, None], Ja)
        camk, ptk, W_p = visual_block_sums(B, pb.obs_kf, pb.obs_pt, K, P)
        Hll = ptk[:, :9].reshape(P, 3, 3)
        b_l = ptk[:, 9:12]
        diag_idx = jnp.arange(K)

        Hcc = jnp.zeros((K, K, 15, 15), jnp.float32)
        Hcc = Hcc.at[diag_idx, diag_idx, :6, :6].add(camk[:, :36].reshape(K, 6, 6))
        b_c = jnp.zeros((K, 15), jnp.float32).at[:, :6].set(camk[:, 36:])

        # ---- inertial + walk blocks: batch the four (i,i)/(i,j)/(j,i)/
        # (j,j) block products of both edge families into ONE einsum and
        # ONE scatter-add each (8 tiny scatters -> 1; pure-latency win) ----
        Hcc, b_c = _scatter_edge_blocks(
            Hcc, b_c, pb.ie_i, pb.ie_j,
            ((r_e, J1, J2, w_e), (r_w, Jw1, Jw2, w_w)))

        # ---- priors (euclidean dims 6:15) ----
        pr_w2 = pr_inv_sigma * pr_inv_sigma  # [K, 9]
        pr_full = jnp.zeros((K, 15), jnp.float32).at[:, 6:15].set(pr_w2)
        Hcc = Hcc.at[diag_idx, diag_idx].add(jax.vmap(jnp.diag)(pr_full))
        b_c = b_c.at[:, 6:15].add(-pr_inv_sigma * r_p)

        # ---- Schur elimination of landmarks (6-dim pose blocks only) ----
        # Landmark damping is LAMBDA-INDEPENDENT (small fixed relative
        # damping) so the whole Schur pipeline runs ONCE per linearization
        # and only the cheap reduced solve repeats across the damping grid
        Hll_d = Hll + 1e-6 * jnp.eye(3, dtype=jnp.float32)[None] \
            + 1e-3 * jax.vmap(jnp.diag)(jnp.maximum(jax.vmap(jnp.diagonal)(Hll), 1e-8))
        Hll_inv = inv3x3(Hll_d)

        Y_p = jnp.einsum("pkv,pvw->pkw", W_p, Hll_inv)  # [P, K*6, 3]
        # full f32 (not TF32): the reduced system feeds the Cholesky
        S6 = jax.lax.dot_general(
            Y_p, W_p, (((0, 2), (0, 2)), ((), ())),
            precision=jax.lax.Precision.HIGHEST)  # [K*6, K*6]
        b6 = jnp.einsum("pkv,pv->k", Y_p, b_l)  # [K*6]

        S = Hcc.at[:, :, :6, :6].add(
            -S6.reshape(K, 6, K, 6).transpose(0, 2, 1, 3))
        b = b_c.at[:, :6].add(-b6.reshape(K, 6))

        # DOF masking on the reduced system (fixed KFs get unit diagonal)
        Sm = S.transpose(0, 2, 1, 3).reshape(K * 15, K * 15)
        dof = problem.kf_dof.reshape(-1)
        Sm = Sm * dof[:, None] * dof[None, :] + jnp.diag(1.0 - dof)
        bm = b.reshape(-1) * dof
        # base visual validity (w_v > 0 iff obs_valid & depth gate): the
        # candidate cost pass must reuse THIS mask (see _vis_residuals)
        return Sm, bm, W_p, Hll_inv, b_l, cost_here, w_v > 0

    def solve_reduced(Sm, bm, lam):
        Sd = Sm + jnp.diag(lam * jnp.maximum(jnp.diagonal(Sm), 1e-8))
        # Jacobi preconditioning for f32 robustness, then Cholesky: the
        # damped reduced system is SPD, and on VI problems its post-Jacobi
        # conditioning defeats the closed-form recursive inverse
        # (inv_spd_blocks15 + iterative refinement both measured to leave
        # 3x velocity errors) — factorization accuracy is load-bearing.
        # Jacobi-PCG on the bench reduced system needs ~128 iterations to
        # reach Cholesky accuracy (relerr 9e-7; 16 iterations leave 7.5e-2),
        # so at 480 dims the factorization stays.
        d = jnp.sqrt(jnp.maximum(jnp.diagonal(Sd), 1e-12))
        Sd_n = Sd / d[:, None] / d[None, :]
        L = jnp.linalg.cholesky(Sd_n)
        return (jax.scipy.linalg.cho_solve((L, True), bm / d) / d).reshape(K, 15)

    # Parallel-lambda LM: one linearization per iteration; the reduced
    # 15K-dim system is solved at a grid of 4 dampings simultaneously
    # (batched Cholesky), all 4 candidates are costed in one batched
    # residual pass, and the argmin is accepted if it improves. Every
    # iteration makes progress — no reject/re-linearize cadence — and the
    # expensive landmark elimination is never repeated per damping.
    def body(carry, _):
        kf, pts, lam, _cost = carry
        pb = problem._replace(kf=kf, points=pts)
        Sm, bm, W_p, Hll_inv, b_l, cost_lin, vmask = linearize_assemble(pb)

        lams = lam * LAM_GRID
        G = LAM_GRID.shape[0]
        dxc4 = jax.vmap(solve_reduced, in_axes=(None, None, 0))(Sm, bm, lams)
        acc4 = jnp.einsum("pkv,ck->cpv", W_p,
                          dxc4[:, :, :6].reshape(G, K * 6))  # [G, P, 3]
        dxl4 = jnp.einsum("pvw,cpw->cpv", Hll_inv, b_l[None] - acc4)

        kf4 = jax.vmap(lambda dc: res.retract_kf(kf, dc * problem.kf_dof))(dxc4)
        pts4 = pts[None] + dxl4 * problem.pt_active[None, :, None]
        cost4 = jax.vmap(lambda k_, p_: _total_cost(
            problem._replace(kf=k_, points=p_), camera, R_cb, t_cb,
            huber_delta2, valid_override=vmask))(kf4, pts4)

        i = jnp.argmin(cost4)
        best = cost4[i]
        improved = best < cost_lin
        kf = jax.tree_util.tree_map(
            lambda c, o: jnp.where(improved, c[i], o), kf4, kf)
        pts = jnp.where(improved, pts4[i], pts)
        lam = jnp.where(improved, jnp.clip(lams[i], 1e-9, 1e4),
                        jnp.minimum(lam * 25.0, 1e8))
        cost = jnp.where(improved, best, cost_lin)
        return (kf, pts, lam, cost), (cost, cost_lin)

    def body_deferred(carry, _):
        kf, pts, kf_b, pts_b, cost_b, lam = carry
        pb = problem._replace(kf=kf, points=pts)
        Sm, bm, W_p, Hll_inv, b_l, cost_lin, _ = linearize_assemble(pb)
        # NaN-robust: a diverged tentative step produces cost_lin = NaN,
        # which must REJECT (plain `cost_lin > cost_b` is False on NaN and
        # would accept the poisoned state); strict <= also lets a reverted
        # state (re-costing exactly cost_b) proceed instead of looping
        worse = jnp.logical_not(cost_lin <= cost_b)
        # adapt lambda from the outcome of the PREVIOUS tentative step
        lam = jnp.where(worse, jnp.minimum(lam * 16.0, 1e6),
                        jnp.maximum(lam * 0.33, 1e-9))
        # on regression: revert to the kept optimum and skip this step (the
        # linearization belongs to the rejected state); next iteration
        # re-linearizes the reverted state with the larger lambda
        kf_keep = jax.tree_util.tree_map(
            lambda b_, c_: jnp.where(worse, b_, c_), kf_b, kf)
        pts_keep = jnp.where(worse, pts_b, pts)
        cost_keep = jnp.where(worse, cost_b, cost_lin)

        dxc = solve_reduced(Sm, bm, lam)
        acc = jnp.einsum("pkv,k->pv", W_p, dxc[:, :6].reshape(K * 6))
        dxl = jnp.einsum("pvw,pw->pv", Hll_inv, b_l - acc)
        kf_new = res.retract_kf(kf, dxc * problem.kf_dof)
        pts_new = pts + dxl * problem.pt_active[:, None]
        kf_next = jax.tree_util.tree_map(
            lambda b_, n_: jnp.where(worse, b_, n_), kf_b, kf_new)
        pts_next = jnp.where(worse, pts_b, pts_new)
        return ((kf_next, pts_next, kf_keep, pts_keep, cost_keep, lam),
                (cost_keep, cost_lin))

    if deferred:
        init = (problem.kf, problem.points, problem.kf, problem.points,
                jnp.float32(jnp.inf), jnp.float32(lambda0))
        (kf_t, pts_t, kf_b, pts_b, cost_b, _), (cost_hist, cost_lin_hist) = \
            jax.lax.scan(body_deferred, init, None, length=n_iters)
        # the last tentative step was never evaluated: cost it once and
        # keep the better state
        cost_t = _total_cost(problem._replace(kf=kf_t, points=pts_t),
                             camera, R_cb, t_cb, huber_delta2)
        worse = jnp.logical_not(cost_t <= cost_b)  # NaN-robust
        kf_f = jax.tree_util.tree_map(
            lambda b_, t_: jnp.where(worse, b_, t_), kf_b, kf_t)
        pts_f = jnp.where(worse, pts_b, pts_t)
        cost = jnp.minimum(cost_t, cost_b)
    else:
        # no standalone initial-cost pass: iteration 1's linearize evaluates
        # the cost at the initial state anyway (deferred-accept), so cost0 is
        # the first element of the linearization-cost history
        (kf_f, pts_f, _, cost), (cost_hist, cost_lin_hist) = jax.lax.scan(
            body,
            (problem.kf, problem.points, jnp.float32(lambda0),
             jnp.float32(jnp.inf)),
            None, length=n_iters,
        )
    pb = problem._replace(kf=kf_f, points=pts_f)

    # final per-obs chi2 for inlier classification
    r_v, _, _, _, chi2, _ = _vis_linearize(pb, camera, R_cb, t_cb, huber_delta2)
    return pb.kf, pb.points, {
        "cost0": cost_lin_hist[0],
        "cost": cost,
        "cost_hist": cost_hist,
        "obs_chi2": chi2,
    }


