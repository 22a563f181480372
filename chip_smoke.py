#!/usr/bin/env python3
"""Smoke test of the SLAM main path on an NVIDIA GPU.

    python chip_smoke.py                 # phases a + b on one card
    python chip_smoke.py --four-cards    # phase c only, on four cards

a. End to end: the dataset-runner CLI (`runners.datasets.main`) streams
   the 10 s synthetic circle world through `System.track` at the profile
   of `settings/synthetic.yaml` and exports the keyframe trajectory. It
   passes with 0 LOST frames, the IMU fully initialized at shutdown and a
   keyframe ATE RMSE under 0.10 m (the bounds of tests/test_e2e_image.py).
b. Full-width kernels, each compared with its plain reference: the
   tracking step of `__graft_entry__.entry()` (752x480, 1024 features) on
   a rendered frame of the synthetic world against the host CPU backend
   and the true pose, the fused projected match, the ORB patch gather,
   the Schur-BA visual assembly sums, and `schur_ba` (flat and grouped)
   against the same problem on the host CPU backend.
c. Four cards: `sharded_schur_ba` on a flat 4-card mesh against
   single-card `schur_ba`, and `make_batch_extractor` against single-card
   extraction of the same images.

The script stops with a non-zero exit and no result line unless JAX's
first device is a GPU. Its last line of standard output is one JSON
object: {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# tolerances, each with its reason
BA_COST_RTOL = 1e-3  # f32 LM on two backends: summation order differs, so
#                      the converged costs differ in low bits (4e-5 on the
#                      H100 even with TF32 sums); a cost 1e-3 off means a
#                      different optimum
SUMS_RTOL = 1e-5     # f32 sums of <= 200 terms vs float64: ~1e-7 expected
ENTRY_ATOL = 1e-3    # pose of the tracking step, GPU vs CPU backend,
#                      both with f32 products at HIGHEST
ENTRY_MIN_INLIERS = 150  # of 1024 map points; ~300 from a prior one
#                          frame (50 ms) behind, on the CPU backend
ENTRY_INLIER_SLACK = 5   # inlier count, GPU vs CPU at HIGHEST (FAST ties
#                          may round differently in separately compiled
#                          programs)
ENTRY_MAX_ROT_DEG = 0.5  # pose vs the rendered truth; the CPU backend
ENTRY_MAX_TRANS_M = 0.05  # lands at 0.12 deg / 0.022 m
DP_MIN_MATCH = 0.99  # share of keypoints identical between 4-card and
#                      1-card extraction (separately compiled programs may
#                      round FAST scores differently at exact ties)
ATE_MAX_M = 0.10


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"
    return out.stdout.strip() or out.stderr.strip()


def log(*a):
    print(*a, flush=True)


def _timed_us(fn, *args, reps=50):
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps * 1e6


# ---------------------------------------------------------------- phase a

def jit_census(system) -> int:
    """Compiled-variant count across the hot jitted programs; growth
    between the end of warmup and the end of the run counts compiles
    inside the timed window."""
    import monoorbslam3_tpu.backend.problems as P
    import monoorbslam3_tpu.frontend.local_mapping as L
    import monoorbslam3_tpu.frontend.tracking as T

    fns = [P._pose_optimize_impl, P.schur_ba, T._coarse_track_kernel,
           T._local_track_kernel, T._predict_deltas,
           L._triangulate_pair_kernel, L._fuse_project_kernel,
           system.problems._preint_batch, system.problems._whiten_batch]
    return sum(f._cache_size() for f in fns)


class _Recorder:
    """Wraps System.warmup and System.track to time them and to keep the
    System the runner CLI builds."""

    def __init__(self):
        from monoorbslam3_tpu.system import System

        self.cls = System
        self.orig = (System.warmup, System.track)
        self.system = None
        self.warmup_s = None
        self.census_after_warmup = None
        self.frame_s, self.states, self.syncs = [], [], []

    def __enter__(self):
        from monoorbslam3_tpu.utils.fetch import sync_count

        rec = self
        warmup, track = self.orig

        def timed_warmup(system, *a, **kw):
            t0 = time.perf_counter()
            out = warmup(system, *a, **kw)
            rec.warmup_s = time.perf_counter() - t0
            rec.census_after_warmup = jit_census(system)
            return out

        def timed_track(system, *a, **kw):
            rec.system = system
            s0 = sync_count()
            t0 = time.perf_counter()
            state = track(system, *a, **kw)
            rec.frame_s.append(time.perf_counter() - t0)
            rec.syncs.append(sync_count() - s0)
            rec.states.append(int(state))
            return state

        self.cls.warmup, self.cls.track = timed_warmup, timed_track
        return self

    def __exit__(self, *exc):
        self.cls.warmup, self.cls.track = self.orig


def phase_a(out_dir: str, world: str = "circle:t_end=10,fps=20",
            settings: str = "settings/synthetic.yaml") -> dict:
    import numpy as np
    import jax

    from monoorbslam3_tpu import native
    from monoorbslam3_tpu.evaluation.metrics import evaluate_sequences
    from monoorbslam3_tpu.runners import datasets

    os.makedirs(out_dir, exist_ok=True)
    est = os.path.join(out_dir, "kf_traj.txt")
    gt = os.path.join(out_dir, "gt_traj.txt")
    log("native host modules loaded:",
        {m: native.get_ext(m) is not None for m in ("map_ops", "dataloader")})
    with _Recorder() as rec:
        datasets.main(["synthetic", os.path.join(ROOT, settings), world, est,
                       "--gt-out", gt, "--warmup"])
    system = rec.system
    (ate,) = evaluate_sequences([("smoke", est, gt)], max_dt=0.05, log=log)
    frame_ms = np.asarray(rec.frame_s) * 1e3
    states = np.asarray(rec.states)
    track_s = float(np.sum(rec.frame_s))
    stats = jax.devices()[0].memory_stats() or {}
    out = {
        "world": world, "frames": int(len(states)),
        "warmup_s": rec.warmup_s,
        "track_wall_s": track_s,
        "fps": len(states) / track_s, "camera_fps": 20.0,
        "frame_ms_p50": float(np.percentile(frame_ms, 50)),
        "frame_ms_p90": float(np.percentile(frame_ms, 90)),
        "frame_ms_max": float(frame_ms.max()),
        "jit_variants_after_warmup": rec.census_after_warmup,
        "jit_variants_after_run": jit_census(system),
        "blocking_reads_per_frame": float(np.mean(rec.syncs)),
        "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
        "lost_frames": int((states == 4).sum()),
        "ok_frames": int((states == 2).sum()),
        "imu_state": int(system.mapper.imu_state),
        "n_keyframes": int(system.store.n_keyframes()),
        "map_points": int(system.store.n_points()),
        "kf_ate_rmse_m": float(ate["rmse"]),
        "scale": float(ate["scale"]),
    }
    out["pass"] = (out["lost_frames"] == 0 and out["imu_state"] == 2
                   and out["kf_ate_rmse_m"] < ATE_MAX_M)
    return out


# ---------------------------------------------------------------- phase b

def _match_inputs(N, M, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    da = rng.integers(0, 2**32, (N, 8), dtype=np.uint32)
    db = rng.integers(0, 2**32, (M, 8), dtype=np.uint32)
    k = min(N, M) // 2  # near-duplicate pairs so real matches exist
    db[:k] = da[:k]
    flip = rng.integers(0, 32, k).astype(np.uint32)
    db[np.arange(k), rng.integers(0, 8, k)] ^= np.uint32(1) << flip
    uv_a = rng.uniform(0, 700, (N, 2)).astype(np.float32)
    xy_b = rng.uniform(0, 700, (M, 2)).astype(np.float32)
    xy_b[:k] = uv_a[:k] + rng.normal(0, 4, (k, 2)).astype(np.float32)
    radius = rng.uniform(8, 20, N).astype(np.float32)
    return da, db, uv_a, xy_b, radius, rng.random(N) > 0.1, rng.random(M) > 0.1


def check_projected_match(N=1024, M=1024, seed=0) -> dict:
    """Fused gate + Hamming + top-2 match vs the mask build +
    match_descriptors path, on the default device: must be bit-identical
    (the Hamming matmul takes +-1 bf16 operands with f32 accumulation,
    exact on any backend)."""
    import numpy as np
    import jax
    import jax.numpy as jnp

    from monoorbslam3_tpu.ops import matching
    from monoorbslam3_tpu.ops.fused_match import projected_match

    da, db, uv_a, xy_b, radius, va, vb = _match_inputs(N, M, seed)
    da, db = jnp.asarray(da), jnp.asarray(db)
    uv_a, xy_b = jnp.asarray(uv_a), jnp.asarray(xy_b)
    radius, va, vb = jnp.asarray(radius), jnp.asarray(va), jnp.asarray(vb)

    @jax.jit
    def fused(da, db, uv_a, xy_b, radius, va, vb):
        return projected_match(da, db, uv_a=uv_a, xy_b=xy_b, radius=radius,
                               valid_a=va, valid_b=vb,
                               max_dist=matching.TH_HIGH, ratio=0.9)

    @jax.jit
    def reference(da, db, uv_a, xy_b, radius, va, vb):
        mask = matching.projection_mask(uv_a, va, xy_b, vb, radius)
        return matching.match_descriptors(da, db, mask,
                                          max_dist=matching.TH_HIGH,
                                          ratio=0.9)

    args = (da, db, uv_a, xy_b, radius, va, vb)
    idx, dist = (np.asarray(x) for x in fused(*args))
    ref_idx, ref_dist = (np.asarray(x) for x in reference(*args))
    hit = idx >= 0
    same = bool(np.array_equal(idx, ref_idx)
                and np.array_equal(dist[hit], ref_dist[hit]))
    return {"shape": f"{N}x{M}", "matches": int(hit.sum()),
            "bit_identical": same, "fused_us": _timed_us(fused, *args),
            "reference_us": _timed_us(reference, *args)}


def check_patch_gather(height=480, width=752, n_features=1024,
                       seed=0) -> dict:
    """The extractor's patch gather at its atlas shape vs numpy slicing:
    must be bit-identical (a gather moves values, no arithmetic)."""
    import numpy as np
    import jax
    import jax.numpy as jnp

    from monoorbslam3_tpu.ops.orb import PATCH, OrbExtractor, gather_patches_dyn

    ext = OrbExtractor(height, width, n_features=n_features)
    rng = np.random.default_rng(seed)
    atlas = rng.uniform(0, 255, (ext.atlas_h, ext.atlas_w)).astype(np.float32)
    ys = rng.integers(0, ext.atlas_h - PATCH + 1, n_features).astype(np.int32)
    xs = rng.integers(0, ext.atlas_w - PATCH + 1, n_features).astype(np.int32)
    fn = jax.jit(gather_patches_dyn)
    args = (jnp.asarray(atlas), jnp.asarray(ys), jnp.asarray(xs))
    got = np.asarray(fn(*args))
    want = np.stack([atlas[y:y + PATCH, x:x + PATCH] for y, x in zip(ys, xs)])
    return {"atlas": f"{ext.atlas_h}x{ext.atlas_w}", "patches": n_features,
            "bit_identical": bool(np.array_equal(got, want)),
            "us": _timed_us(fn, *args)}


def _on(device, build_and_run):
    import jax

    with jax.default_device(device):
        return build_and_run()


def rendered_entry_args(height=480, width=752, n_features=1024, t0=2.0,
                        dt=0.05, seed=0):
    """Inputs of the tracking step from the synthetic circle world, with
    the rig of settings/synthetic.yaml: the map is frame t0's ORB
    features placed at the world points they see (their own descriptors,
    true 3-D positions), the image is the next frame (t0 + dt), and the
    pose prior is frame t0's camera pose. Returns (args as numpy arrays,
    the true camera pose (R_wc, t_wc) at t0 + dt)."""
    import numpy as np

    import __graft_entry__ as ge
    from monoorbslam3_tpu.config import build_imu_calib, load_settings
    from monoorbslam3_tpu.ops.orb import OrbExtractor
    from monoorbslam3_tpu.sim import ImageWorld, Trajectory

    cam = ge.euroc_camera(height, width)
    calib = build_imu_calib(load_settings(
        os.path.join(ROOT, "settings", "synthetic.yaml")))
    R_bc = np.asarray(calib.R_bc, np.float64)
    t_bc = np.asarray(calib.t_bc, np.float64)
    world = ImageWorld(traj=Trajectory())
    rng = np.random.default_rng(seed)
    img0, pts_w = world.render(t0, cam, R_bc, t_bc, rng=rng,
                               return_points=True)
    img1 = world.render(t0 + dt, cam, R_bc, t_bc, rng=rng)
    feats = OrbExtractor(height, width, n_features=n_features)(img0)
    xy = np.asarray(feats["xy"], np.float64)
    px = np.clip(np.rint(xy).astype(np.int64), 0, [width - 1, height - 1])
    # the depth the nearest pixel sees, along the keypoint's own ray
    R_cw, t_cw = world.pose_cw(t0, R_bc, t_bc)
    depth = (pts_w[px[:, 1], px[:, 0]] @ R_cw.T + t_cw)[:, 2]
    rays = np.asarray(cam.back_project(xy.astype(np.float32)), np.float64)
    pt_xyz = ((rays * depth[:, None] - t_cw) @ R_cw).astype(np.float32)

    def pose_wc(t):
        R_cw, t_cw = world.pose_cw(t, R_bc, t_bc)
        return (R_cw.T.astype(np.float32),
                (-R_cw.T @ t_cw).astype(np.float32))

    R0, p0 = pose_wc(t0)
    args = (img1, pt_xyz, np.asarray(feats["desc"]),
            np.asarray(feats["valid"]), R0, p0)
    return args, pose_wc(t0 + dt)


def check_entry(height=480, width=752, n_features=1024,
                min_inliers=ENTRY_MIN_INLIERS) -> dict:
    """The flagship tracking step (extract -> project -> fused match ->
    pose LM) on a rendered frame against a map of the previous frame.

    At the default matmul precision (TF32 on the GPU, as the tracker runs)
    the pose must land near the true one with enough inliers. With every
    f32 product at HIGHEST, the default device must agree with the host
    CPU backend (the plain reference)."""
    import numpy as np
    import jax

    import __graft_entry__ as ge

    args, (R_true, t_true) = rendered_entry_args(height, width, n_features)
    fn, _ = ge.entry(height, width, n_features)

    def run():
        return [np.asarray(o) for o in fn(*args)]

    def pose_err(R, t):
        cos = np.clip((np.trace(R_true.T @ R) - 1) / 2, -1.0, 1.0)
        return float(np.degrees(np.arccos(cos))), float(np.linalg.norm(t - t_true))

    def diff(a, b):
        return max(float(np.abs(a[0] - b[0]).max()),
                   float(np.abs(a[1] - b[1]).max()))

    R, t, n = run()
    with jax.default_matmul_precision("highest"):
        R_h, t_h, n_h = run()
        R_c, t_c, n_c = _on(jax.devices("cpu")[0], run)
    rot_deg, trans_m = pose_err(R, t)
    err = diff((R_h, t_h), (R_c, t_c))
    return {"size": f"{width}x{height}", "features": n_features,
            "map_points": int(args[3].sum()), "min_inliers": min_inliers,
            # default precision on the default device vs the truth
            "inliers": int(n), "rot_err_deg": rot_deg, "trans_err_m": trans_m,
            "max_rot_deg": ENTRY_MAX_ROT_DEG, "max_trans_m": ENTRY_MAX_TRANS_M,
            # HIGHEST on the default device vs the CPU backend
            "inliers_highest": int(n_h), "inliers_cpu": int(n_c),
            "pose_max_diff": err, "atol": ENTRY_ATOL,
            "pose_diff_default_vs_highest": diff((R, t), (R_h, t_h)),
            "ok": bool(np.isfinite(R).all() and np.isfinite(t).all()
                       and R.shape == (3, 3) and t.shape == (3,)
                       and min(int(n), int(n_h), int(n_c)) >= min_inliers
                       and rot_deg <= ENTRY_MAX_ROT_DEG
                       and trans_m <= ENTRY_MAX_TRANS_M
                       and abs(int(n_h) - int(n_c)) <= ENTRY_INLIER_SLACK
                       and err <= ENTRY_ATOL)}


def block_sums_float64(B, obs_kf, obs_pt, K, P):
    """Plain float64 reference of solver.visual_block_sums."""
    import numpy as np

    B = np.asarray(B, np.float64)
    O = B.shape[0]
    camk = np.zeros((K, 42))
    ptk = np.zeros((P, 12))
    W = np.zeros((P, K, 18))
    np.add.at(camk, obs_kf, np.concatenate(
        [B[:, :6, :6].reshape(O, 36), B[:, :6, 9:10].reshape(O, 6)], -1))
    np.add.at(ptk, obs_pt, np.concatenate(
        [B[:, 6:9, 6:9].reshape(O, 9), B[:, 6:9, 9:10].reshape(O, 3)], -1))
    np.add.at(W, (obs_pt, obs_kf), B[:, :6, 6:9].reshape(O, 18))
    return camk, ptk, W.reshape(P, K * 6, 3)


def check_assembly_sums(problem_kw=None) -> dict:
    """The Schur-BA visual assembly sums (per-KF, per-point and the
    pose-landmark coupling) on the default device vs float64 numpy."""
    import numpy as np
    import jax
    import jax.numpy as jnp

    import bench
    from monoorbslam3_tpu.backend import solver
    from monoorbslam3_tpu.utils.precision import f32_matmuls

    problem, cam = bench.build_problem(**(problem_kw or {}))
    K, P = problem.kf_dof.shape[0], problem.points.shape[0]

    @jax.jit
    @f32_matmuls
    def blocks(pb):
        r_v, Jc, Jl, w_v, _, _ = solver._vis_linearize(
            pb, cam, jnp.eye(3), jnp.zeros(3), solver.CHI2_MONO)
        Ja = jnp.concatenate([Jc, Jl, -r_v[:, :, None]], -1)
        return jnp.einsum("oik,oil->okl", Ja * w_v[:, None, None], Ja)

    B = blocks(problem)
    sums = jax.jit(solver.visual_block_sums, static_argnums=(3, 4))
    got = [np.asarray(x, np.float64)
           for x in sums(B, problem.obs_kf, problem.obs_pt, K, P)]
    want = block_sums_float64(np.asarray(B), np.asarray(problem.obs_kf),
                              np.asarray(problem.obs_pt), K, P)
    rel = [float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))
           for g, w in zip(got, want)]
    return {"obs": int(B.shape[0]), "max_rel_err": max(rel),
            "rtol": SUMS_RTOL, "method": "f32 segment sum / scatter-add",
            "us": _timed_us(sums, B, problem.obs_kf, problem.obs_pt, K, P),
            "ok": max(rel) <= SUMS_RTOL}


def check_schur_ba(layout: str, problem_kw=None, n_iters=10) -> dict:
    """schur_ba on the default device vs the same jitted problem on the
    host CPU backend: converged costs within BA_COST_RTOL. `layout`
    "grouped" keeps the observations in per-KF blocks (the polish layout);
    "flat" shuffles them (the sliding-window layout)."""
    import numpy as np
    import jax

    import bench
    from monoorbslam3_tpu.backend.solver import schur_ba

    cpu = jax.devices("cpu")[0]
    problem, cam = _on(cpu, lambda: bench.build_problem(**(problem_kw or {})))
    if layout == "flat":
        perm = np.random.default_rng(1).permutation(problem.obs_kf.shape[0])
        problem = problem._replace(**{
            f: getattr(problem, f)[perm] for f in (
                "obs_kf", "obs_pt", "obs_uv", "obs_inv_sigma2", "obs_valid")})
    args = (problem, cam, np.eye(3, dtype=np.float32),
            np.zeros(3, np.float32))

    def run(device):
        _, _, info = schur_ba(*jax.device_put(args, device), n_iters=n_iters)
        return float(info["cost0"]), float(info["cost"])

    cost0, cost = run(jax.devices()[0])
    _, cost_cpu = run(cpu)
    rel = abs(cost - cost_cpu) / abs(cost_cpu)
    return {"layout": layout, "cost0": cost0, "cost": cost,
            "cost_cpu": cost_cpu, "rel_diff": rel, "rtol": BA_COST_RTOL,
            "ok": bool(cost < cost0 and rel <= BA_COST_RTOL)}


def phase_b() -> dict:
    out = {"entry": check_entry(),
           "match_1024": check_projected_match(1024, 1024),
           "match_local_map_2048": check_projected_match(2048, 1024, seed=1),
           "patch_gather": check_patch_gather(),
           "assembly_sums": check_assembly_sums(),
           "schur_ba_flat": check_schur_ba("flat"),
           "schur_ba_grouped": check_schur_ba("grouped")}
    out["pass"] = all(v.get("ok", v.get("bit_identical"))
                      for v in out.values())
    return out


# ---------------------------------------------------------------- phase c

def check_sharded_ba(devices, problem_kw=None, n_iters=10) -> dict:
    """Point-sharded Schur BA on a flat mesh vs single-device schur_ba on
    the same problem: converged costs within BA_COST_RTOL."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    import bench
    from monoorbslam3_tpu.backend.solver import schur_ba
    from monoorbslam3_tpu.parallel.sharded_ba import (
        shard_problem_by_point, sharded_schur_ba,
    )

    kw = problem_kw or dict(n_kf=32, n_fixed=8, n_pts=16384, obs_per_kf=768)
    problem, cam = bench.build_problem(**kw)
    R_cb, t_cb = jnp.eye(3), jnp.zeros(3)
    mesh = Mesh(np.asarray(devices), ("dp",))
    sharded, _ = shard_problem_by_point(problem, len(devices))
    _, _, info_s = sharded_schur_ba(sharded, cam, R_cb, t_cb, mesh,
                                    n_iters=n_iters)
    _, _, info_1 = schur_ba(problem, cam, R_cb, t_cb, n_iters=n_iters)
    cost_s, cost_1 = float(info_s["cost"]), float(info_1["cost"])
    rel = abs(cost_s - cost_1) / abs(cost_1)
    t_s = _timed_us(lambda p: sharded_schur_ba(p, cam, R_cb, t_cb, mesh,
                                               n_iters=n_iters)[1],
                    sharded, reps=5)
    t_1 = _timed_us(lambda p: schur_ba(p, cam, R_cb, t_cb,
                                       n_iters=n_iters)[1], problem, reps=5)
    return {"window": kw, "cards": len(devices),
            "cost0": float(info_1["cost0"]), "cost_sharded": cost_s,
            "cost_single": cost_1, "rel_diff": rel, "rtol": BA_COST_RTOL,
            "sharded_ms": t_s / 1e3, "single_ms": t_1 / 1e3,
            "ok": bool(cost_s < float(info_s["cost0"])
                       and rel <= BA_COST_RTOL)}


def check_batch_extract(devices, height=480, width=752, n_features=1024,
                        per_card=2, seed=0) -> dict:
    """make_batch_extractor over a flat mesh vs single-device extraction of
    the same images."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from monoorbslam3_tpu.ops.orb import OrbExtractor
    from monoorbslam3_tpu.parallel.frontend_dp import (
        make_batch_extractor, shard_images,
    )

    mesh = Mesh(np.asarray(devices), ("dp",))
    ext = OrbExtractor(height, width, n_features=n_features)
    rng = np.random.default_rng(seed)
    B = per_card * len(devices)
    base = rng.uniform(0, 255, (B, height // 8, width // 8)).astype(np.float32)
    images = np.stack([np.kron(b, np.ones((8, 8), np.float32)) for b in base])
    batched = make_batch_extractor(ext, mesh)(
        shard_images(jnp.asarray(images), mesh))
    batched = jax.tree_util.tree_map(np.asarray, batched)
    single = [jax.tree_util.tree_map(np.asarray, ext(images[i]))
              for i in range(B)]
    want = {k: np.stack([s[k] for s in single]) for k in batched}
    same_kp = ((batched["valid"] == want["valid"])
               & (batched["xy"] == want["xy"]).all(-1)
               & (batched["desc"] == want["desc"]).all(-1))
    share = float(same_kp.mean())
    return {"images": B, "valid_keypoints": int(want["valid"].sum()),
            "identical_share": share, "min_share": DP_MIN_MATCH,
            "ok": bool(share >= DP_MIN_MATCH and want["valid"].sum() > 0)}


def phase_c(devices) -> dict:
    out = {"sharded_ba": check_sharded_ba(devices),
           "batch_extract": check_batch_extract(devices)}
    out["pass"] = all(v["ok"] for v in out.values())
    return out


# ---------------------------------------------------------------- main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card phase")
    ap.add_argument("--out-dir", default=os.path.join(ROOT, "smoke_out"),
                    help="where phase a writes its trajectories")
    args = ap.parse_args(argv)

    log("card:", card_line())  # before JAX touches the card
    platforms = os.environ.get("JAX_PLATFORMS")
    if platforms and "cpu" not in platforms.split(","):
        # the CPU backend is the reference of several phase-b checks
        os.environ["JAX_PLATFORMS"] = platforms + ",cpu"
    import jax

    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        print(f"no GPU: JAX's first device is {dev.platform} "
              f"({dev.device_kind})", file=sys.stderr)
        return 2
    need = 4 if args.four_cards else 1
    if len(devices) < need:
        print(f"need {need} GPUs, JAX sees {len(devices)}", file=sys.stderr)
        return 2

    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    from monoorbslam3_tpu.utils.compile_cache import enable_compile_cache

    log("jax", jax.__version__, "| compile cache:", enable_compile_cache())
    log("devices:", [d.device_kind for d in devices])

    phases = ({"c": lambda: phase_c(devices[:4])} if args.four_cards else
              {"a": lambda: phase_a(args.out_dir), "b": phase_b})
    ok = True
    for name, run in phases.items():
        t0 = time.perf_counter()
        res = run()
        res["phase_s"] = time.perf_counter() - t0
        log(f"phase {name}:", json.dumps(res))
        ok &= bool(res["pass"])
    if not ok:
        print("FAILED: a phase did not pass", file=sys.stderr)
        return 1
    log("card:", card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
