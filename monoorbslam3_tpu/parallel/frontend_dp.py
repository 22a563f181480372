"""Data-parallel bulk frontend: ORB extraction over a device mesh.

The reference runs one frame at a time on the tracking thread
(Tracking.cpp:93 constructs a Frame per image); its only frontend
"scaling" is real-time pacing. Here the frontend is a fixed-shape XLA
program, so scaling frames/s across cards is plain data parallelism:
shard a batch of images over the mesh's `dp` axis with `shard_map` and
let each device run the full single-frame pipeline (pyramid -> FAST ->
select -> patch gather -> BRIEF) on its local shard. No collectives are
needed — extraction is embarrassingly parallel — so scaling efficiency is
bounded only by per-device dispatch, which the local `lax.map` amortizes
across the shard.

Use cases mirroring the reference's offline tooling (test/extractorTest
.cpp, dataset preprocessing): bulk feature extraction for mapping
sessions, multi-sequence batch processing, and the N-host frames/s
scaling benchmark (BASELINE.md: >= 75% scaling efficiency at 2+ hosts).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_batch_extractor(ext, mesh: Mesh, axis: str = "dp"):
    """Returns a jitted `fn(images [B, H, W]) -> features` with every
    output batched as [B, ...] and sharded over `axis`.

    B must be a multiple of the mesh axis size. Each device traces the
    single-frame extractor ONCE and `lax.map`s it over its local shard —
    sequential per device (matching how a tracker drives the chip),
    parallel across devices.
    """
    n_dev = mesh.shape[axis]

    def local(images):
        # images: [B/n_dev, H, W] local shard
        return jax.lax.map(ext._extract, images)

    spec = P(axis)
    fn = shard_map(
        local, mesh=mesh,
        in_specs=(spec,),
        out_specs=spec,
        check_vma=False,
    )

    @jax.jit
    def run(images):
        B = images.shape[0]
        if B % n_dev:
            raise ValueError(f"batch {B} not divisible by mesh axis {n_dev}")
        return fn(images.astype(jnp.float32))

    return run


def shard_images(images, mesh: Mesh, axis: str = "dp"):
    """Places a [B, H, W] image batch with its batch dim sharded over
    `axis` (host-side helper so `make_batch_extractor` input starts on
    the right devices instead of being broadcast then resharded)."""
    return jax.device_put(images, NamedSharding(mesh, P(axis)))
