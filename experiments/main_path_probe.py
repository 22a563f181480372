"""The SLAM main path on the GPU: TF32 sensitivity of the geometry jits and
run-to-run repeatability.

    python experiments/main_path_probe.py [--runs 2] [--capture 3]
                                          [--world circle:t_end=10,fps=20]

Runs chip_smoke's phase a (the synthetic circle world through
`runners.datasets.main`) `--runs` times in this one process, so every run
after the first uses the same compiled executables. Per run it prints the
phase-a readings, the map size, a hash of the keyframe trajectory, and
whether that trajectory equals the first run's byte for byte.

During the first run it keeps the inputs of the first `--capture` calls
after warmup of the ORB extractor and of each geometry jit: the coarse
and local track kernels, pair triangulation, fuse projection and two-view
reconstruction. It then
replays each capture
- at the default matmul precision and under
  `jax.default_matmul_precision("highest")`, and prints the largest
  difference of the float outputs and the number of differing integer or
  boolean outputs (`reconstruct_two_views` runs inside `f32_matmuls`, so
  it is replayed a second time with that scope taken off);
- three times at the default precision, and prints whether the outputs
  repeat bit for bit.

Set XLA_FLAGS=--xla_gpu_deterministic_ops=true to compare. `--world
circle:t_end=3,fps=20 --runs 2` is a short rehearsal on the CPU.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Capture:
    """Stands in for a jitted kernel: forwards every call (and attribute,
    e.g. `_cache_size`) to it, and keeps the first `n` calls' inputs once
    `armed`."""

    armed = False

    def __init__(self, name, fn, n):
        self.name, self.fn, self.n, self.calls = name, fn, n, []

    def __call__(self, *args, **kwargs):
        if Capture.armed and len(self.calls) < self.n:
            self.calls.append((args, kwargs))
        return self.fn(*args, **kwargs)

    def __getattr__(self, attr):
        return getattr(self.fn, attr)


def leaves(tree):
    import jax

    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def compare(a, b):
    """(largest float difference, count of differing non-float elements)."""
    fmax, nbad = 0.0, 0
    for x, y in zip(leaves(a), leaves(b)):
        if np.issubdtype(x.dtype, np.floating):
            ok = np.isfinite(x) & np.isfinite(y)
            if ok.any():
                fmax = max(fmax, float(np.abs(x[ok] - y[ok]).max()))
            nbad += int((np.isfinite(x) != np.isfinite(y)).sum())
        else:
            nbad += int((x != y).sum())
    return fmax, nbad


def same_bits(a, b):
    return all(x.tobytes() == y.tobytes() for x, y in zip(leaves(a), leaves(b)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--capture", type=int, default=3)
    ap.add_argument("--world", default="circle:t_end=10,fps=20")
    args = ap.parse_args()

    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    import jax

    import chip_smoke
    import monoorbslam3_tpu.frontend.local_mapping as L
    import monoorbslam3_tpu.frontend.tracking as T
    from monoorbslam3_tpu.ops.orb import OrbExtractor
    from monoorbslam3_tpu.system import System

    dev = jax.devices()[0]
    print(json.dumps({"probe": "device", "platform": dev.platform,
                      "kind": dev.device_kind,
                      "xla_flags": os.environ.get("XLA_FLAGS", "")}),
          flush=True)

    caps = []
    for mod, name in ((T, "_coarse_track_kernel"), (T, "_local_track_kernel"),
                      (T, "reconstruct_two_views"),
                      (L, "_triangulate_pair_kernel"),
                      (L, "_fuse_project_kernel")):
        cap = Capture(name, getattr(mod, name), args.capture)
        setattr(mod, name, cap)
        caps.append(cap)
    extract = Capture("orb_extract", lambda ext, img: ext._fn(img),
                      args.capture)
    OrbExtractor.__call__ = lambda ext, img: extract(ext, img)
    caps.insert(0, extract)
    # keep real frames' inputs only, not warmup's dummy ones
    warmup = System.warmup

    def warmup_then_arm(system, *a, **kw):
        out = warmup(system, *a, **kw)
        Capture.armed = True
        return out

    System.warmup = warmup_then_arm

    first = None
    for run in range(args.runs):
        out_dir = os.path.join(ROOT, "smoke_out", f"probe_run{run}")
        res = chip_smoke.phase_a(out_dir, world=args.world)
        with open(os.path.join(out_dir, "kf_traj.txt"), "rb") as f:
            traj = f.read()
        first = traj if first is None else first
        Capture.armed = False
        print(json.dumps({"probe": "run", "run": run, **res,
                          "traj_sha": hashlib.sha256(traj).hexdigest()[:16],
                          "traj_equal_to_run0": traj == first}), flush=True)

    for cap in caps:
        for i, (a, kw) in enumerate(cap.calls):
            base = cap.fn(*a, **kw)
            with jax.default_matmul_precision("highest"):
                high = cap.fn(*a, **kw)
            fmax, nbad = compare(base, high)
            rec = {"probe": "precision", "kernel": cap.name, "call": i,
                   "max_float_diff": fmax, "differing_discrete": nbad}
            if cap.name == "reconstruct_two_views":
                raw = jax.jit(inspect.unwrap(cap.fn),
                              static_argnames=("n_iters",))
                raw_base = raw(*a, **kw)
                with jax.default_matmul_precision("highest"):
                    raw_high = raw(*a, **kw)
                rec["unscoped_max_float_diff"], rec[
                    "unscoped_differing_discrete"] = compare(raw_base,
                                                             raw_high)
            rec["repeatable_of_3"] = all(
                same_bits(base, cap.fn(*a, **kw)) for _ in range(2))
            print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
