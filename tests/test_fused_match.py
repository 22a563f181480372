"""Fused masked match (ops/fused_match.py): exact equivalence with the
mask-build + match_descriptors path."""

import numpy as np
import jax.numpy as jnp
import pytest

from monoorbslam3_tpu.ops import matching
from monoorbslam3_tpu.ops.fused_match import projected_match

RNG = np.random.default_rng(11)


def _mk(N, M, with_groups=True, n_groups=7):
    da = RNG.integers(0, 2**32, (N, 8), dtype=np.uint32)
    db = RNG.integers(0, 2**32, (M, 8), dtype=np.uint32)
    # correlated pairs so real matches exist
    k = min(N, M) // 2
    db[:k] = da[:k]
    for i in range(k):
        w = RNG.integers(0, 8)
        db[i, w] ^= np.uint32(1) << np.uint32(RNG.integers(0, 32))
    uv_a = RNG.uniform(0, 700, (N, 2)).astype(np.float32)
    xy_b = np.empty((M, 2), np.float32)
    xy_b[:k] = uv_a[:k] + RNG.normal(0, 4, (k, 2))
    xy_b[k:] = RNG.uniform(0, 700, (M - k, 2))
    radius = RNG.uniform(8, 20, N).astype(np.float32)
    va = RNG.random(N) > 0.1
    vb = RNG.random(M) > 0.1
    ga = RNG.integers(-1, n_groups, N).astype(np.int32) if with_groups else None
    gb = RNG.integers(-1, n_groups, M).astype(np.int32) if with_groups else None
    return da, db, uv_a, xy_b, radius, va, vb, ga, gb


def _reference(da, db, uv_a, xy_b, radius, va, vb, ga, gb, max_dist, ratio,
               mutual=True, use_ratio=True):
    """The existing composition: projection mask (+ node gate) + matcher."""
    mask = matching.projection_mask(
        jnp.asarray(uv_a), jnp.asarray(va), jnp.asarray(xy_b),
        jnp.asarray(vb), jnp.asarray(radius))
    if ga is not None:
        mask &= matching.node_gate(jnp.asarray(ga), jnp.asarray(gb))
    return matching.match_descriptors(
        jnp.asarray(da), jnp.asarray(db), mask, max_dist=max_dist,
        ratio=ratio, mutual=mutual, use_ratio=use_ratio)


def _check(N=256, M=300, **kw):
    da, db, uv_a, xy_b, radius, va, vb, ga, gb = _mk(N, M, **kw)
    for max_dist, ratio, mutual in [(matching.TH_HIGH, 0.9, True),
                                    (matching.TH_LOW, 0.75, False)]:
        ref_idx, ref_dist = _reference(da, db, uv_a, xy_b, radius, va, vb,
                                       ga, gb, max_dist, ratio, mutual)
        idx, dist = projected_match(
            da, db, uv_a=jnp.asarray(uv_a), xy_b=jnp.asarray(xy_b),
            radius=radius, groups_a=ga, groups_b=gb, valid_a=va, valid_b=vb,
            max_dist=max_dist, ratio=ratio, mutual=mutual)
        np.testing.assert_array_equal(np.asarray(idx), np.asarray(ref_idx))
        hit = np.asarray(idx) >= 0
        np.testing.assert_array_equal(np.asarray(dist)[hit],
                                      np.asarray(ref_dist)[hit])


def _check_no_spatial_gate():
    """radius=None (the SearchByBow mode: descriptor + node gate only)."""
    da, db, uv_a, xy_b, radius, va, vb, ga, gb = _mk(256, 256)
    mask = (jnp.asarray(va)[:, None] & jnp.asarray(vb)[None, :]
            & matching.node_gate(jnp.asarray(ga), jnp.asarray(gb)))
    ref_idx, _ = matching.match_descriptors(
        jnp.asarray(da), jnp.asarray(db), mask, max_dist=matching.TH_LOW,
        ratio=0.75)
    idx, _ = projected_match(
        da, db, groups_a=ga, groups_b=gb, valid_a=va, valid_b=vb,
        max_dist=matching.TH_LOW, ratio=0.75)
    np.testing.assert_array_equal(np.asarray(idx), np.asarray(ref_idx))


@pytest.mark.parametrize("case", ["groups", "no_groups", "no_spatial_gate"])
def test_fused_match_matches_reference(case):
    if case == "no_spatial_gate":
        _check_no_spatial_gate()
    else:
        _check(with_groups=case == "groups")
