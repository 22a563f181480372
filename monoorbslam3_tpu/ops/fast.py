"""Vectorized FAST-16/9 corner detection with grid-bucketed selection.

Analog of the reference's per-cell FAST + quadtree distribution
(ORBExtractor.cpp:572-638, DistributeOctree 640-830). Instead of scalar
pixel loops and a recursive quadtree, the whole level is scored at once:

- the 16-point Bresenham circle becomes 16 static shifts of the image;
- the "9 contiguous brighter/darker" test and the OpenCV-style corner
  score (max-min over all 9-arcs) are computed with log-time sliding
  minima over the circularly extended stack;
- 3x3 non-max suppression is a reduce_window max;
- the quadtree's spatial-uniformity goal is met by per-grid-cell top-k
  followed by a global top-quota — same outcome (spread keypoints,
  strongest first, weak-texture cells still contribute above the low
  threshold), but one fused kernel (SURVEY.md §7 design note).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

# 16-point Bresenham circle of radius 3 in circular order, (dy, dx)
CIRCLE = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)

ARC_LEN = 9


def fast_score_raw(img: jnp.ndarray) -> jnp.ndarray:
    """[H, W] float -> [H, W] un-thresholded corner score.

    Score is the OpenCV-style V value: the largest t' such that some
    9-contiguous arc is entirely brighter/darker than center by t',
    computed as max over arcs of the arc-min |difference|. Kept
    un-thresholded so sub-pixel peak interpolation sees the true local
    score surface (thresholded neighbors would bias the parabola).
    """
    diffs = jnp.stack(
        [jnp.roll(img, (-int(dy), -int(dx)), axis=(0, 1)) - img for dy, dx in CIRCLE],
        axis=0,
    )  # [16, H, W]; roll wrap-around is masked by the border margin later

    def arc_min_max(d):
        # sliding min of window 9 over circular axis 0, then max over starts
        circ = jnp.concatenate([d, d[: ARC_LEN - 1]], axis=0)  # [24, H, W]
        w1 = circ
        w2 = jnp.minimum(w1[:-1], w1[1:])  # window 2
        w4 = jnp.minimum(w2[:-2], w2[2:])  # window 4
        w8 = jnp.minimum(w4[:-4], w4[4:])  # window 8
        w9 = jnp.minimum(w8[:-1], w1[8 : 8 + w8.shape[0] - 1])  # window 9
        return jnp.max(w9[:16], axis=0)

    v_bright = arc_min_max(diffs)  # bright arcs: min diff over arc, max over arcs
    v_dark = arc_min_max(-diffs)
    return jnp.maximum(v_bright, v_dark)


def fast_score_map(img: jnp.ndarray, threshold: float) -> jnp.ndarray:
    """[H, W] float -> [H, W] corner score, zeroed where <= threshold."""
    score = fast_score_raw(img)
    return jnp.where(score > threshold, score, 0.0)


def subpixel_peak_offsets(score: jnp.ndarray, ys: jnp.ndarray,
                          xs: jnp.ndarray, valid: jnp.ndarray):
    """Separable quadratic peak interpolation at integer keypoints.

    Fit a parabola through (prev, center, next) of the RAW score surface
    per axis; the peak offset is 0.5*(prev-next)/(prev+next-2*center),
    in (-0.5, 0.5) whenever center is a strict local max (select feeds
    NMS maxima, so the curvature guard only trips on flat plateaus).
    The reference keeps integer FAST corners (ORBExtractor.cpp:572-617);
    sub-pixel localization is a deliberate accuracy improvement — it
    costs five [N]-sized gathers, and integer quantization (sigma ~0.29
    px uniform) otherwise dominates the measurement noise floor.

    Returns (offx [N], offy [N]) float32, zero for invalid slots.
    """
    C = score[ys, xs]
    L = score[ys, xs - 1]
    R = score[ys, xs + 1]
    U = score[ys - 1, xs]
    D = score[ys + 1, xs]

    def axis_offset(prev, nxt):
        den = prev + nxt - 2.0 * C
        off = 0.5 * (prev - nxt) / jnp.where(den < -1e-6, den, -1.0)
        return jnp.where(den < -1e-6, jnp.clip(off, -0.5, 0.5), 0.0)

    m = valid.astype(jnp.float32)
    return axis_offset(L, R) * m, axis_offset(U, D) * m


def nms3(score: jnp.ndarray) -> jnp.ndarray:
    """3x3 non-maximum suppression."""
    local_max = jax.lax.reduce_window(
        score, -jnp.inf, jax.lax.max, (3, 3), (1, 1), "SAME"
    )
    return jnp.where(score >= local_max, score, 0.0)


@partial(jax.jit, static_argnames=("cell", "per_cell", "quota", "margin"))
def select_keypoints(
    score: jnp.ndarray,  # [H, W] NMS'd score map
    quota: int,  # number of keypoints to keep at this level
    cell: int = 16,  # grid-cell size in pixels
    per_cell: int = 4,  # max keypoints per cell (spatial-uniformity cap)
    margin: int = 24,  # border exclusion (descriptor patch half-size)
):
    """Grid-bucketed top-k selection.

    Returns (xy [quota, 2] float32 (x, y) at this level, response [quota],
    valid [quota] bool).
    """
    h, w = score.shape
    # mask the border margin (also kills jnp.roll wrap-around artifacts)
    ys = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    ok = (ys >= margin) & (ys < h - margin) & (xs >= margin) & (xs < w - margin)
    s = jnp.where(ok, score, 0.0)

    # pad to multiples of cell
    hp = -(-h // cell) * cell
    wp = -(-w // cell) * cell
    s = jnp.pad(s, ((0, hp - h), (0, wp - w)))
    ncy, ncx = hp // cell, wp // cell
    cells = s.reshape(ncy, cell, ncx, cell).transpose(0, 2, 1, 3).reshape(ncy * ncx, cell * cell)

    vals, idx = jax.lax.top_k(cells, per_cell)  # [ncells, per_cell]
    cy = jnp.arange(ncy * ncx, dtype=jnp.int32) // ncx
    cx = jnp.arange(ncy * ncx, dtype=jnp.int32) % ncx
    py = cy[:, None] * cell + idx // cell
    px = cx[:, None] * cell + idx % cell

    flat_vals = vals.reshape(-1)
    flat_y = py.reshape(-1)
    flat_x = px.reshape(-1)

    top_vals, top_i = jax.lax.top_k(flat_vals, quota)
    valid = top_vals > 0.0
    y = jnp.where(valid, flat_y[top_i], 0)
    x = jnp.where(valid, flat_x[top_i], 0)
    xy = jnp.stack([x, y], axis=-1).astype(jnp.float32)
    return xy, top_vals, valid
