"""SO(3) Lie-group toolbox, batched and jit-friendly.

Analog of the reference's SO(3) helpers
(reference: modules/Utils/LieAlgeBra.h:11-29): hat, ExpSO3, LogSO3,
right Jacobian + inverse, rotation normalization. All functions operate on
trailing axes and broadcast over arbitrary leading batch dimensions, use
float32 by default, and are safe to differentiate (small-angle branches are
implemented with `jnp.where` on both the value and its operands so gradients
never see NaN).
"""

from __future__ import annotations

import jax.numpy as jnp

_EPS2 = 1e-12  # squared-angle threshold below which Taylor branches kick in


def hat(w: jnp.ndarray) -> jnp.ndarray:
    """[..., 3] -> [..., 3, 3] skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([zero, -wz, wy], axis=-1),
            jnp.stack([wz, zero, -wx], axis=-1),
            jnp.stack([-wy, wx, zero], axis=-1),
        ],
        axis=-2,
    )


def vee(W: jnp.ndarray) -> jnp.ndarray:
    """[..., 3, 3] skew -> [..., 3]."""
    return jnp.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], axis=-1)


def _theta_terms(w: jnp.ndarray):
    """Returns (theta2, safe_theta, small_mask) for angle-dependent coefficients."""
    theta2 = jnp.sum(w * w, axis=-1)
    small = theta2 < _EPS2
    safe_theta = jnp.sqrt(jnp.where(small, 1.0, theta2))
    return theta2, safe_theta, small


def exp_jr_coeffs(w: jnp.ndarray):
    """Shared Rodrigues coefficients (A, B, C) of w, each [...]:
    exp(w) = I + A hat(w) + B hat(w)^2 ; Jr(w) = I - B hat(w) + C hat(w)^2.
    Exposed separately so callers that already hold hat(w) / hat(w)^2 (e.g.
    stacked-matmul chains where every batched 3x3 product is a dispatch) can
    assemble both maps without recomputing the trig terms."""
    theta2, theta, small = _theta_terms(w)
    safe_t2 = jnp.where(small, 1.0, theta2)
    sin_t, cos_t = jnp.sin(theta), jnp.cos(theta)
    A = jnp.where(small, 1.0 - theta2 / 6.0, sin_t / theta)
    B = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - cos_t) / safe_t2)
    C = jnp.where(small, 1.0 / 6.0 - theta2 / 120.0,
                  (theta - sin_t) / (safe_t2 * theta))
    return A, B, C


def inv_jr_coeff(w: jnp.ndarray) -> jnp.ndarray:
    """D(w) [...] with Jr(w)^-1 = I + 0.5 hat(w) + D hat(w)^2 (same contract
    as `exp_jr_coeffs`: the caller supplies the hat powers)."""
    theta2, theta, small = _theta_terms(w)
    safe_t2 = jnp.where(small, 1.0, theta2)
    sin_t, cos_t = jnp.sin(theta), jnp.cos(theta)
    return jnp.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        1.0 / safe_t2 - (1.0 + cos_t) / jnp.where(small, 1.0, 2.0 * theta * sin_t),
    )


def exp_so3(w: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues exponential map, [..., 3] -> [..., 3, 3]."""
    A, B, _ = exp_jr_coeffs(w)
    W = hat(w)
    W2 = W @ W
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + A[..., None, None] * W + B[..., None, None] * W2


def log_so3(R: jnp.ndarray) -> jnp.ndarray:
    """Logarithm map, [..., 3, 3] -> [..., 3].

    Uses the trace formula with a small-angle branch; near theta = pi the
    axis is recovered from the diagonal of R (Rodrigues symmetric part) to
    stay well-conditioned.
    """
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = jnp.clip((tr - 1.0) * 0.5, -1.0, 1.0)
    # arccos has infinite derivative at +-1; keep its input strictly interior
    # so jacfwd through the OTHER branches stays finite, and keep the
    # small-angle branch arccos-free entirely (3 - tr ~= theta^2).
    theta = jnp.arccos(jnp.clip(cos_t, -1.0 + 1e-7, 1.0 - 1e-7))
    w_asym = vee(R - jnp.swapaxes(R, -1, -2))  # = 2 sin(theta) * axis

    small = cos_t > 1.0 - 1e-7
    near_pi = cos_t < -1.0 + 5e-7

    sin_t = jnp.sin(theta)
    factor_small = 0.5 + (3.0 - tr) / 24.0  # = (theta/(2 sin theta)) Taylor
    factor = jnp.where(small, factor_small, theta / jnp.where(small, 1.0, 2.0 * sin_t))
    w_generic = factor[..., None] * w_asym

    # Near pi: axis^2 ~ (diag(R) + 1) / 2; sign fixed from the skew part.
    diag = jnp.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], axis=-1)
    axis2 = jnp.clip((diag + 1.0) * 0.5, 0.0, 1.0)
    axis = jnp.sqrt(axis2)
    sign = jnp.where(w_asym >= 0.0, 1.0, -1.0)
    # Fall back to largest-component sign chain when skew part vanishes exactly;
    # for residual-scale rotations this path is effectively never exercised.
    w_pi = theta[..., None] * axis * sign
    return jnp.where(near_pi[..., None], w_pi, w_generic)


def right_jacobian_so3(w: jnp.ndarray) -> jnp.ndarray:
    """Right Jacobian Jr(w): [..., 3] -> [..., 3, 3]."""
    _, B, C = exp_jr_coeffs(w)
    W = hat(w)
    W2 = W @ W
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye - B[..., None, None] * W + C[..., None, None] * W2


def inv_right_jacobian_so3(w: jnp.ndarray) -> jnp.ndarray:
    """Inverse right Jacobian Jr(w)^-1: [..., 3] -> [..., 3, 3]."""
    D = inv_jr_coeff(w)
    W = hat(w)
    W2 = W @ W
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + 0.5 * W + D[..., None, None] * W2


def normalize_rotation(R: jnp.ndarray) -> jnp.ndarray:
    """Project a near-rotation onto SO(3) via SVD (reference re-orthonormalizes
    with the same construction)."""
    U, _, Vt = jnp.linalg.svd(R)
    Rn = U @ Vt
    det = jnp.linalg.det(Rn)
    # Flip the last column of U when the product lands on a reflection.
    U_fixed = U.at[..., :, 2].multiply(jnp.where(det < 0.0, -1.0, 1.0)[..., None])
    return U_fixed @ Vt


def rot_to_quat(R: jnp.ndarray) -> jnp.ndarray:
    """[..., 3, 3] -> quaternion [..., 4] as (w, x, y, z), unit norm.

    Branch-free Shepperd-style construction: computes all four candidate
    quaternions and selects the best-conditioned one per element.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]

    tr = m00 + m11 + m22
    qw = jnp.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], axis=-1)
    qx = jnp.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], axis=-1)
    qy = jnp.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], axis=-1)
    qz = jnp.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], axis=-1)

    cands = jnp.stack([qw, qx, qy, qz], axis=-2)  # [..., 4, 4]
    scores = jnp.stack([tr, m00, m11, m22], axis=-1)
    best = jnp.argmax(scores, axis=-1)
    q = jnp.take_along_axis(cands, best[..., None, None].repeat(4, axis=-1), axis=-2)[..., 0, :]
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    # canonical sign: w >= 0
    return q * jnp.where(q[..., :1] < 0.0, -1.0, 1.0)


def quat_to_rot(q: jnp.ndarray) -> jnp.ndarray:
    """Unit quaternion (w, x, y, z) [..., 4] -> [..., 3, 3]."""
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r0 = jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], axis=-1)
    r1 = jnp.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], axis=-1)
    r2 = jnp.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], axis=-1)
    return jnp.stack([r0, r1, r2], axis=-2)
