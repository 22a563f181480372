"""SE(3) pose utilities over (R [..., 3, 3], t [..., 3]) array pairs.

Analog of the reference `Pose` value type (modules/BasicObject/
Pose.h:11-32): composition, inversion, point mapping, and quaternion I/O —
expressed as pure functions over batched arrays rather than a pointer type,
so whole keyframe sets transform in one fused op.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from . import lie


class Pose(NamedTuple):
    """Rigid transform y = R x + t. Batched over leading axes."""

    R: jnp.ndarray  # [..., 3, 3]
    t: jnp.ndarray  # [..., 3]

    @staticmethod
    def identity(batch_shape=(), dtype=jnp.float32) -> "Pose":
        R = jnp.broadcast_to(jnp.eye(3, dtype=dtype), (*batch_shape, 3, 3))
        t = jnp.zeros((*batch_shape, 3), dtype=dtype)
        return Pose(R, t)

    def apply(self, p: jnp.ndarray) -> jnp.ndarray:
        """Map points [..., 3]."""
        return jnp.einsum("...ij,...j->...i", self.R, p) + self.t

    def compose(self, other: "Pose") -> "Pose":
        """self ∘ other: first apply `other`, then `self`."""
        return Pose(self.R @ other.R, self.apply(other.t))

    def inverse(self) -> "Pose":
        Rt = jnp.swapaxes(self.R, -1, -2)
        return Pose(Rt, -jnp.einsum("...ij,...j->...i", Rt, self.t))

    def normalized(self) -> "Pose":
        return Pose(lie.normalize_rotation(self.R), self.t)

    def to_quat_t(self):
        """Returns (q [..., 4] (w,x,y,z), t [..., 3]) for trajectory export."""
        return lie.rot_to_quat(self.R), self.t


def from_quat_t(q: jnp.ndarray, t: jnp.ndarray) -> Pose:
    return Pose(lie.quat_to_rot(q), t)
