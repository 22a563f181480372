"""Batched two-view reconstruction: H/F RANSAC, decomposition, cheirality.

Analog of the reference TwoViewReconstruction
(modules/Frontend/TwoViewReconstruction.cpp). Design translation, not port:

- the reference computes Homography and Fundamental RANSAC in two forked
  std::threads (.cpp:65-70); here both model families' 200 hypotheses are
  DLT-solved and scored as one batched SVD + one dense scoring pass;
- ReconstructH's 8 Faugeras hypotheses (.cpp:347-476) and ReconstructF's 4
  E-decomposition hypotheses (.cpp:478-560, 707-725) go into a single
  12-slot motion-hypothesis bank; CheckRT (.cpp:598-688) triangulates and
  scores ALL hypotheses x ALL matches in one batched DLT, and the winning
  family is selected by the same RH = SH/(SH+SF) > 0.5 rule (.cpp:74-83);
- RANSAC sampling uses an explicit jax.random key — deterministic given the
  seed (SURVEY.md §7 stage 4).

All inputs are fixed-capacity padded arrays with validity masks; the whole
function is one jitted program.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..utils.precision import f32_matmuls

CHI2_H = 5.991
CHI2_F = 3.841
SCORE_TH = 5.991  # reference scores both models against 5.991
MIN_TRIANGULATED = 50
# The reference accepts 1.0 deg (TwoViewReconstruction minParallax). Round 1
# tightened this to 2.5 deg to protect early tracking from low-parallax
# depth noise — but under FORWARD motion (KITTI regime) the matched points
# sit near the focus of expansion and the 50th-percentile parallax never
# exceeds ~2 deg however long the baseline grows, so 2.5 deg makes the
# corridor worlds UNINITIALIZABLE. The per-point depth-uncertainty pipeline
# (pt_sigma_z weighting + graduation culling) landed since and absorbs what
# the tight gate used to block; reference parity restored.
MIN_PARALLAX_DEG = 1.0


def _masked_normalize(xy, valid):
    """Hartley normalization over valid points: zero-mean, unit mean-abs-dev.
    Returns (xy_n, T [3,3]) with xy_n = T @ [xy, 1]."""
    w = valid.astype(jnp.float32)
    n = jnp.maximum(jnp.sum(w), 1.0)
    mean = jnp.sum(xy * w[:, None], axis=0) / n
    d = jnp.abs(xy - mean) * w[:, None]
    mean_dev = jnp.sum(d, axis=0) / n
    s = 1.0 / jnp.maximum(mean_dev, 1e-6)
    xy_n = (xy - mean) * s
    T = jnp.array(
        [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]], jnp.float32
    )
    T = T.at[0, 0].set(s[0]).at[1, 1].set(s[1])
    T = T.at[0, 2].set(-mean[0] * s[0]).at[1, 2].set(-mean[1] * s[1])
    return xy_n, mean, s, T


def _dlt_homography(p1, p2):
    """[S, 8, 2] x [S, 8, 2] -> [S, 3, 3] homographies via batched SVD
    (reference ComputeH21, TwoViewReconstruction.cpp:163-193)."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    zero = jnp.zeros_like(x1)
    one = jnp.ones_like(x1)
    rows_a = jnp.stack([zero, zero, zero, -x1, -y1, -one, y2 * x1, y2 * y1, y2], axis=-1)
    rows_b = jnp.stack([x1, y1, one, zero, zero, zero, -x2 * x1, -x2 * y1, -x2], axis=-1)
    A = jnp.concatenate([rows_a, rows_b], axis=-2)  # [S, 16, 9]
    _, _, Vt = jnp.linalg.svd(A, full_matrices=True)
    h = Vt[..., -1, :]
    return h.reshape(*h.shape[:-1], 3, 3)


def _dlt_fundamental(p1, p2):
    """[S, 8, 2] x [S, 8, 2] -> [S, 3, 3] rank-2 fundamental matrices
    (reference ComputeF21, TwoViewReconstruction.cpp:195-225)."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    one = jnp.ones_like(x1)
    A = jnp.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, one], axis=-1
    )  # [S, 8, 9]
    _, _, Vt = jnp.linalg.svd(A, full_matrices=True)
    F = Vt[..., -1, :].reshape(*A.shape[:-2], 3, 3)
    # enforce rank 2
    U, S, Vt2 = jnp.linalg.svd(F)
    S = S.at[..., 2].set(0.0)
    return U @ (S[..., :, None] * Vt2)


def _score_homography(H21, xy1, xy2, valid, sigma2=1.0):
    """Symmetric-transfer score (reference CheckHomography, .cpp:227-303)."""
    H12 = jnp.linalg.inv(H21)

    def transfer(H, a, b):
        x = H[..., 0, 0] * a[:, 0] + H[..., 0, 1] * a[:, 1] + H[..., 0, 2]
        y = H[..., 1, 0] * a[:, 0] + H[..., 1, 1] * a[:, 1] + H[..., 1, 2]
        z = H[..., 2, 0] * a[:, 0] + H[..., 2, 1] * a[:, 1] + H[..., 2, 2]
        zi = 1.0 / jnp.where(jnp.abs(z) < 1e-12, 1e-12, z)
        du = x * zi - b[:, 0]
        dv = y * zi - b[:, 1]
        return (du * du + dv * dv) / sigma2

    chi2_21 = transfer(H21, xy1, xy2)
    chi2_12 = transfer(H12, xy2, xy1)
    ok = (chi2_21 < CHI2_H) & (chi2_12 < CHI2_H) & valid
    score = jnp.sum(
        jnp.where(ok, (SCORE_TH - chi2_21) + (SCORE_TH - chi2_12), 0.0)
    )
    return score, ok


def _score_fundamental(F21, xy1, xy2, valid, sigma2=1.0):
    """Epipolar-distance score (reference CheckFundamental, .cpp:305-345)."""
    one1 = jnp.ones_like(xy1[:, :1])
    p1 = jnp.concatenate([xy1, one1], axis=-1)  # [N, 3]
    p2 = jnp.concatenate([xy2, one1], axis=-1)
    l2 = p1 @ F21.T  # [N, 3] epipolar line in image 2
    l1 = p2 @ F21
    num2 = jnp.sum(l2 * p2, axis=-1)
    num1 = jnp.sum(l1 * p1, axis=-1)
    d2 = num2 * num2 / jnp.maximum(l2[:, 0] ** 2 + l2[:, 1] ** 2, 1e-12) / sigma2
    d1 = num1 * num1 / jnp.maximum(l1[:, 0] ** 2 + l1[:, 1] ** 2, 1e-12) / sigma2
    ok = (d2 < CHI2_F) & (d1 < CHI2_F) & valid
    score = jnp.sum(jnp.where(ok, (SCORE_TH - d2) + (SCORE_TH - d1), 0.0))
    return score, ok


def triangulate_dlt(P1, P2, xy1, xy2):
    """Batched linear triangulation (reference Triangulate, .cpp:689-705).

    P1, P2: [3, 4] (or broadcastable leading dims); xy1, xy2: [..., 2].
    Returns homogeneous-normalized [..., 3] points.
    """
    rows = [
        xy1[..., 0, None] * P1[..., 2, :] - P1[..., 0, :],
        xy1[..., 1, None] * P1[..., 2, :] - P1[..., 1, :],
        xy2[..., 0, None] * P2[..., 2, :] - P2[..., 0, :],
        xy2[..., 1, None] * P2[..., 2, :] - P2[..., 1, :],
    ]
    A = jnp.stack(rows, axis=-2)  # [..., 4, 4]
    # Inhomogeneous DLT: fix the w=1 gauge and solve the 3x3 normal
    # equations in closed form (Cramer). The reference's homogeneous SVD
    # null vector (.cpp:700-703) differs only in the algebraic-error
    # normalization, which matters only for points near infinity — and
    # those are rejected by the cheirality/parallax gates anyway. A
    # batched [N,4,4] SVD is an iterative, latency-bound kernel; this is a
    # handful of fused elementwise ops.
    A1 = A[..., :3]
    a4 = A[..., 3]
    M = jnp.einsum("...ri,...rj->...ij", A1, A1)
    b = -jnp.einsum("...ri,...r->...i", A1, a4)
    c00 = M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1]
    c01 = M[..., 1, 2] * M[..., 2, 0] - M[..., 1, 0] * M[..., 2, 2]
    c02 = M[..., 1, 0] * M[..., 2, 1] - M[..., 1, 1] * M[..., 2, 0]
    det = (M[..., 0, 0] * c00 + M[..., 0, 1] * c01 + M[..., 0, 2] * c02)
    det = jnp.where(jnp.abs(det) < 1e-20, 1e-20, det)

    def cram(col):
        Mi = M.at[..., :, col].set(b)
        d = (Mi[..., 0, 0] * (Mi[..., 1, 1] * Mi[..., 2, 2]
                              - Mi[..., 1, 2] * Mi[..., 2, 1])
             + Mi[..., 0, 1] * (Mi[..., 1, 2] * Mi[..., 2, 0]
                                - Mi[..., 1, 0] * Mi[..., 2, 2])
             + Mi[..., 0, 2] * (Mi[..., 1, 0] * Mi[..., 2, 1]
                                - Mi[..., 1, 1] * Mi[..., 2, 0]))
        return d / det

    return jnp.stack([cram(0), cram(1), cram(2)], axis=-1)


def decompose_essential(E):
    """E -> 4 motion hypotheses (R [4,3,3], t [4,3] unit) —
    reference DecomposeE (.cpp:707-725)."""
    U, _, Vt = jnp.linalg.svd(E)
    # ensure proper rotations
    U = U * jnp.sign(jnp.linalg.det(U))
    Vt = Vt * jnp.sign(jnp.linalg.det(Vt))
    W = jnp.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], jnp.float32)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]
    t = t / jnp.maximum(jnp.linalg.norm(t), 1e-12)
    Rs = jnp.stack([R1, R1, R2, R2])
    ts = jnp.stack([t, -t, t, -t])
    return Rs, ts


def decompose_homography(H, K):
    """Faugeras SVD decomposition of a calibrated homography into 8 motion
    hypotheses (reference ReconstructH, .cpp:347-476).

    Returns (R [8,3,3], t [8,3] unit-normalized).
    """
    Kinv = jnp.linalg.inv(K)
    A = Kinv @ H @ K
    U, S, Vt = jnp.linalg.svd(A)
    V = Vt.T
    s = jnp.linalg.det(U) * jnp.linalg.det(Vt)
    d1, d2, d3 = S[0], S[1], S[2]

    # guard: d1 > d2 > d3 strictly for the generic formulas
    eps = 1e-8
    d1 = jnp.maximum(d1, d2 + eps)
    d3 = jnp.minimum(d3, d2 - eps)

    aux1 = jnp.sqrt(jnp.maximum((d1 * d1 - d2 * d2) / (d1 * d1 - d3 * d3), 0.0))
    aux3 = jnp.sqrt(jnp.maximum((d2 * d2 - d3 * d3) / (d1 * d1 - d3 * d3), 0.0))
    x1s = jnp.array([1.0, 1.0, -1.0, -1.0], jnp.float32) * aux1
    x3s = jnp.array([1.0, -1.0, 1.0, -1.0], jnp.float32) * aux3

    # case d' = d2 (positive): rotation about y by theta
    aux_stheta = jnp.sqrt(
        jnp.maximum((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0)
    ) / ((d1 + d3) * d2)
    ctheta = (d2 * d2 + d1 * d3) / ((d1 + d3) * d2)
    stheta = jnp.array([1.0, -1.0, -1.0, 1.0], jnp.float32) * aux_stheta

    def make_Rt_pos(i):
        st, x1, x3 = stheta[i], x1s[i], x3s[i]
        Rp = jnp.array(
            [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]], jnp.float32
        )
        Rp = Rp.at[0, 0].set(ctheta).at[0, 2].set(-st).at[2, 0].set(st).at[2, 2].set(ctheta)
        R = s * (U @ Rp @ Vt)
        tp = jnp.array([x1, 0.0, -x3], jnp.float32) * (d1 - d3)
        t = U @ tp
        return R, t

    # case d' = -d2: rotation by phi with flip
    aux_sphi = jnp.sqrt(
        jnp.maximum((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0)
    ) / ((d1 - d3) * d2)
    cphi = (d1 * d3 - d2 * d2) / ((d1 - d3) * d2)
    sphi = jnp.array([1.0, -1.0, -1.0, 1.0], jnp.float32) * aux_sphi

    def make_Rt_neg(i):
        sp, x1, x3 = sphi[i], x1s[i], x3s[i]
        Rp = jnp.zeros((3, 3), jnp.float32)
        Rp = Rp.at[0, 0].set(cphi).at[0, 2].set(sp).at[1, 1].set(-1.0)
        Rp = Rp.at[2, 0].set(sp).at[2, 2].set(-cphi)
        R = s * (U @ Rp @ Vt)
        tp = jnp.array([x1, 0.0, x3], jnp.float32) * (d1 + d3)
        t = U @ tp
        return R, t

    Rs, ts = [], []
    for i in range(4):
        R, t = make_Rt_pos(i)
        Rs.append(R)
        ts.append(t)
    for i in range(4):
        R, t = make_Rt_neg(i)
        Rs.append(R)
        ts.append(t)
    Rs = jnp.stack(Rs)
    ts = jnp.stack(ts)
    ts = ts / jnp.maximum(jnp.linalg.norm(ts, axis=-1, keepdims=True), 1e-12)
    return Rs, ts


def check_rt(R, t, xy1, xy2, valid, K, sigma2=1.0, th_chi2=4.0):
    """Batched CheckRT (reference .cpp:598-688): triangulate all matches
    under motion hypothesis (R, t), gate on cheirality/parallax/reprojection.

    R: [3,3], t: [3]; xy1/xy2: [N, 2] pixel coords; returns
    (n_good, points3d [N, 3] in frame 1, good [N], median_parallax_cos).
    """
    P1 = jnp.concatenate([K, jnp.zeros((3, 1), jnp.float32)], axis=1)
    Rt = jnp.concatenate([R, t[:, None]], axis=1)
    P2 = K @ Rt

    X = triangulate_dlt(P1, P2, xy1, xy2)  # frame-1 coords
    finite = jnp.all(jnp.isfinite(X), axis=-1)

    O2 = -R.T @ t  # camera-2 center in frame 1
    n1 = X
    n2 = X - O2
    d1 = jnp.linalg.norm(n1, axis=-1)
    d2 = jnp.linalg.norm(n2, axis=-1)
    cos_par = jnp.sum(n1 * n2, axis=-1) / jnp.maximum(d1 * d2, 1e-12)

    z1 = X[:, 2]
    Xc2 = X @ R.T + t
    z2 = Xc2[:, 2]

    # reprojection errors
    uv1 = jnp.stack(
        [K[0, 0] * X[:, 0] / jnp.maximum(z1, 1e-9) + K[0, 2],
         K[1, 1] * X[:, 1] / jnp.maximum(z1, 1e-9) + K[1, 2]], axis=-1
    )
    uv2 = jnp.stack(
        [K[0, 0] * Xc2[:, 0] / jnp.maximum(z2, 1e-9) + K[0, 2],
         K[1, 1] * Xc2[:, 1] / jnp.maximum(z2, 1e-9) + K[1, 2]], axis=-1
    )
    e1 = jnp.sum((uv1 - xy1) ** 2, axis=-1) / sigma2
    e2 = jnp.sum((uv2 - xy2) ** 2, axis=-1) / sigma2

    has_parallax = cos_par < 0.99998
    good = (
        valid & finite & (z1 > 0) & (z2 > 0) & has_parallax
        & (e1 < th_chi2) & (e2 < th_chi2)
    )
    n_good = jnp.sum(good)

    # parallax statistic: ~50th-best parallax among good points (reference
    # takes the min(50th, last) sorted parallax, .cpp:676-682)
    cos_masked = jnp.where(good, cos_par, 1.0)
    sorted_cos = jnp.sort(cos_masked)  # ascending: best (smallest) first
    idx = jnp.minimum(49, jnp.maximum(n_good - 1, 0))
    parallax_cos = sorted_cos[idx]
    return n_good, X, good, parallax_cos


@partial(jax.jit, static_argnames=("n_iters",))
@f32_matmuls
def reconstruct_two_views(
    xy1: jnp.ndarray,  # [N, 2] undistorted pixel coords, frame 1
    xy2: jnp.ndarray,  # [N, 2] matched coords, frame 2
    valid: jnp.ndarray,  # [N] bool
    K: jnp.ndarray,  # [3, 3] ideal intrinsics
    key: jnp.ndarray,  # jax PRNG key (deterministic RANSAC)
    sigma2: float = 1.0,
    n_iters: int = 200,
):
    """Full two-view bootstrap (reference Reconstruct, .cpp:14-83).

    Returns dict: success (bool), R [3,3], t [3] (frame1->frame2, unit
    translation), points [N, 3] in frame 1, good [N] bool, rh (score ratio).
    """
    N = xy1.shape[0]
    w = valid.astype(jnp.float32)
    n_valid = jnp.sum(w)

    # --- RANSAC hypothesis generation (batched) ---
    probs = w / jnp.maximum(n_valid, 1.0)
    idx = jax.random.choice(key, N, shape=(n_iters, 8), p=probs)
    s1 = xy1[idx]  # [S, 8, 2]
    s2 = xy2[idx]

    _, mean1, sc1, T1 = _masked_normalize(xy1, valid)
    _, mean2, sc2, T2 = _masked_normalize(xy2, valid)
    s1n = (s1 - mean1) * sc1  # Hartley-normalized samples
    s2n = (s2 - mean2) * sc2

    Hn = _dlt_homography(s1n, s2n)  # [S, 3, 3]
    Fn = _dlt_fundamental(s1n, s2n)
    T2inv = jnp.linalg.inv(T2)
    H_all = T2inv[None] @ Hn @ T1[None]
    F_all = jnp.swapaxes(T2, -1, -2)[None] @ Fn @ T1[None]

    score_h = jax.vmap(lambda H: _score_homography(H, xy1, xy2, valid, sigma2)[0])(H_all)
    score_f = jax.vmap(lambda F: _score_fundamental(F, xy1, xy2, valid, sigma2)[0])(F_all)

    bh = jnp.argmax(score_h)
    bf = jnp.argmax(score_f)
    H_best = H_all[bh]
    F_best = F_all[bf]
    SH = score_h[bh]
    SF = score_f[bf]
    _, inliers_h = _score_homography(H_best, xy1, xy2, valid, sigma2)
    _, inliers_f = _score_fundamental(F_best, xy1, xy2, valid, sigma2)

    rh = SH / jnp.maximum(SH + SF, 1e-12)
    # Model selection. The reference uses RH > 0.5 (.cpp:74-83); we use 0.45
    # (upstream ORB-SLAM2/3's 0.40-0.45 band): for a planar scene the 8-point
    # null space degenerates to a family that fits ALL plane points, so
    # SF ~= SH and 0.5 becomes a coin flip — biasing toward H is strictly
    # safer since ReconstructH handles the planar case.
    use_h = rh > 0.45

    # --- joint 12-slot motion-hypothesis bank ---
    Rh, th = decompose_homography(H_best, K)  # [8, ...]
    E = K.T @ F_best @ K
    Rf, tf = decompose_essential(E)  # [4, ...]
    Rs = jnp.concatenate([Rh, Rf])
    ts = jnp.concatenate([th, tf])
    family_h = jnp.arange(12) < 8
    active = jnp.where(use_h, family_h, ~family_h)
    model_inliers = jnp.where(use_h, inliers_h, inliers_f)

    n_good, X, good, par_cos = jax.vmap(
        lambda R, t: check_rt(R, t, xy1, xy2, model_inliers, K, sigma2, th_chi2=4.0 * sigma2)
    )(Rs, ts)
    n_good = jnp.where(active, n_good, -1)

    best = jnp.argmax(n_good)
    best_n = n_good[best]
    n_inl = jnp.sum(model_inliers)

    # acceptance (reference ReconstructF acceptance, .cpp:536-559): a clear
    # winner with enough triangulated points and parallax
    n_similar = jnp.sum(n_good > 0.75 * best_n)
    min_good = jnp.maximum(0.7 * n_inl, float(MIN_TRIANGULATED))
    par_deg = jnp.degrees(jnp.arccos(jnp.clip(par_cos[best], -1.0, 1.0)))
    success = (
        (best_n >= min_good) & (n_similar == 1) & (par_deg > MIN_PARALLAX_DEG)
    )

    return {
        "success": success,
        "R": Rs[best],
        "t": ts[best],
        "points": X[best],
        "good": good[best],
        "rh": rh,
        "n_good": best_n,
        "parallax_deg": par_deg,
        # acceptance diagnostics (all already computed; free to return)
        "n_good_all": n_good,
        "n_similar": n_similar,
        "n_inliers": n_inl,
        "min_good": min_good,
    }
