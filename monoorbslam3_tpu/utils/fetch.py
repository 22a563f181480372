"""Counted device->host reads.

Dispatches and host->device transfers are asynchronous; a blocking read
of a jit output makes the host wait for the device. Per pipeline stage
the code dispatches everything, then reads ONCE through `fetch(...)`,
and this module counts the reads so a run can report blocking reads per
frame (chip_smoke.py phase a). What a read costs on a local GPU is not
measured yet.
"""

from __future__ import annotations

import jax

_count = [0]


def fetch(*trees):
    """One blocking device->host read of every array in the given pytrees
    (numpy leaves pass through untouched). Returns the same structure(s),
    with device arrays replaced by numpy. Counts as ONE sync point."""
    _count[0] += 1
    out = jax.device_get(trees)
    return out if len(trees) > 1 else out[0]


def sync_count() -> int:
    return _count[0]


def reset_sync_count():
    _count[0] = 0
