"""Fused masked matching: gate + Hamming + top-2 in one formulation.

The original matching path (ops/matching.py) builds the [N, M] candidate
mask as a separate op and selects with top_k; this module computes the
gate from per-side vectors inside the match and replaces top_k with
min/argmin reductions that XLA fuses into the consumer of the Hamming
matmul:

    d   = hamming(A, B)                          # +-1 bf16 matmul, f32 acc
    d   = INF where NOT [ valid & |uv_a - xy_b|^2 < r2_a & node_gate ]
    (best, second, first-occurrence argmin) per row

Covers the tracker's three hot searches (projection-window, reference-KF /
SearchByBow, local-map) — the gates are the circular projection radius
(r2 = +inf degrades to no spatial gate) and the vocabulary node-id
equality with the -1 pass-through sentinel (ops/matching.py::node_gate).
Mutual consistency runs as a second, transposed call (best-only).

Tie-breaking matches the mask path exactly (first occurrence), so
`projected_match` is bit-identical to mask-build + `match_descriptors`
(unit-tested).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from . import matching

INF = 1e9


def _match_rows(desc_a, desc_b, ax, ay, r2a, ga, va, bx, by, r2b, gb, vb):
    """Row-side stats (best [N] f32, second [N] f32, idx [N] i32), with
    first-occurrence tie-breaking."""
    d = matching.hamming_matrix(desc_a, desc_b).astype(jnp.float32)
    dx = ax[:, None] - bx[None, :]
    dy = ay[:, None] - by[None, :]
    q = dx * dx + dy * dy
    gate = (va[:, None] > 0) & (vb[None, :] > 0)
    gate &= (q < r2a[:, None]) & (q < r2b[None, :])
    gate &= matching.node_gate(ga, gb)
    d = jnp.where(gate, d, INF)
    best = jnp.min(d, axis=1)
    idx = jnp.argmin(d, axis=1).astype(jnp.int32)
    lane = jax.lax.broadcasted_iota(jnp.int32, d.shape, 1)
    d2 = jnp.where(lane == idx[:, None], INF, d)
    second = jnp.min(d2, axis=1)
    idx = jnp.where(best < INF, idx, -1)
    return best, second, idx


@partial(jax.jit, static_argnames=("mutual", "use_ratio"))
def _projected_match_impl(desc_a, desc_b, ax, ay, r2, ga, va, bx, by, gb, vb,
                          max_dist, ratio, mutual, use_ratio):
    infc = jnp.full_like(bx, INF)
    best, second, idx = _match_rows(desc_a, desc_b, ax, ay, r2, ga, va,
                                    bx, by, infc, gb, vb)
    ok = (idx >= 0) & (best <= max_dist)
    if use_ratio:
        ok &= best < ratio * second
    if mutual:
        # transposed pass (column-wise first-occurrence argmin) under the
        # SAME pairwise gate: the radius rides on the now-column side
        _, _, idx_b = _match_rows(desc_b, desc_a, bx, by, infc, gb, vb,
                                  ax, ay, r2, ga, va)
        safe = jnp.maximum(idx, 0)
        ok &= idx_b[safe] == jnp.arange(desc_a.shape[0])
    out_idx = jnp.where(ok, idx, -1)
    big = jnp.float32(1 << 20)
    return out_idx, jnp.where(ok, best, big).astype(jnp.int32)


def projected_match(desc_a, desc_b, *, uv_a=None, xy_b=None, radius=None,
                    groups_a=None, groups_b=None, valid_a, valid_b,
                    max_dist, ratio=0.9, mutual=True, use_ratio=True):
    """Fused analog of projection_mask/node_gate + match_descriptors.

    radius: per-row search radius (None = no spatial gate); groups: vocab
    node ids with -1 pass-through. Returns (idx [N] i32, dist [N] i32)
    exactly like match_descriptors.
    """
    N, M = desc_a.shape[0], desc_b.shape[0]
    z = jnp.zeros
    ax, ay = ((uv_a[:, 0], uv_a[:, 1]) if uv_a is not None
              else (z(N, jnp.float32), z(N, jnp.float32)))
    bx, by = ((xy_b[:, 0], xy_b[:, 1]) if xy_b is not None
              else (z(M, jnp.float32), z(M, jnp.float32)))
    r2 = (jnp.asarray(radius, jnp.float32) ** 2 if radius is not None
          else jnp.full(N, INF, jnp.float32))
    ga = (jnp.asarray(groups_a, jnp.float32) if groups_a is not None
          else jnp.full(N, -1.0, jnp.float32))
    gb = (jnp.asarray(groups_b, jnp.float32) if groups_b is not None
          else jnp.full(M, -1.0, jnp.float32))
    return _projected_match_impl(
        jnp.asarray(desc_a), jnp.asarray(desc_b),
        jnp.asarray(ax, jnp.float32), jnp.asarray(ay, jnp.float32), r2,
        ga, jnp.asarray(valid_a, jnp.float32),
        jnp.asarray(bx, jnp.float32), jnp.asarray(by, jnp.float32), gb,
        jnp.asarray(valid_b, jnp.float32),
        jnp.asarray(max_dist, jnp.float32), jnp.asarray(ratio, jnp.float32),
        mutual, use_ratio)
