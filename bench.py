"""Benchmark: local-BA iteration throughput on the current default device.

Prints ONE JSON line:
  {"metric": "local_ba_iters_per_s", "value": N, "unit": "iters/s",
   "vs_baseline": R, ...}

The problem matches the reference's local-BA shape (Optimize.cpp:1064-1310):
a sliding window of 24 optimized + 8 fixed keyframes, ~2k landmarks, ~6k
observations, inertial+bias-walk edges between consecutive KFs — the
hottest mapper loop (SURVEY.md §3.3). One "iteration" = full relinearize +
Schur landmark elimination + reduced-camera solve + retraction, i.e. the
same work as one g2o LM iteration.

Baseline: single-thread g2o on a desktop CPU runs this window at roughly
25-50 LM iterations/s (sparse Schur, ~6k reprojection edges); we use
40 iters/s as the reference point (BASELINE.md target: >= 10x g2o).
"""

import json
import time

import numpy as np

G2O_BASELINE_ITERS_PER_S = 40.0


def build_problem(n_kf=32, n_fixed=8, n_pts=2048, obs_per_kf=192, seed=0):
    """The window as a BAProblem + camera. Built at full f32 matmul
    precision, so every backend gets the same observations (TF32 would
    move them by ~0.1 px and with them the optimum)."""
    import jax

    with jax.default_matmul_precision("highest"):
        return _build_problem(n_kf, n_fixed, n_pts, obs_per_kf, seed)


def _build_problem(n_kf, n_fixed, n_pts, obs_per_kf, seed):
    import jax.numpy as jnp

    from monoorbslam3_tpu.backend.residuals import KfState, PreintEdge
    from monoorbslam3_tpu.backend.solver import BAProblem
    from monoorbslam3_tpu.models.camera import Pinhole
    from monoorbslam3_tpu.utils import lie

    rng = np.random.default_rng(seed)
    cam = Pinhole.create(fx=458.654, fy=457.296, cx=367.215, cy=248.375,
                         width=752, height=480)

    # keyframes along an arc, landmarks in front
    ts = np.cumsum(rng.uniform(0.2, 0.3, n_kf))
    R_list = [np.asarray(lie.exp_so3(jnp.asarray([0.0, 0.02 * k, 0.0], jnp.float32)))
              for k in range(n_kf)]
    t_list = [np.array([0.3 * k, 0.02 * k, 0.05 * np.sin(k)], np.float32)
              for k in range(n_kf)]
    kf_gt = KfState(
        jnp.asarray(np.stack(R_list)), jnp.asarray(np.stack(t_list)),
        jnp.asarray(rng.normal(0, 0.5, (n_kf, 3)).astype(np.float32)),
        jnp.zeros((n_kf, 3)), jnp.zeros((n_kf, 3)),
    )
    pts = np.stack([
        rng.uniform(-6, 6 + 0.3 * n_kf, n_pts),
        rng.uniform(-4, 4, n_pts),
        rng.uniform(6, 14, n_pts),
    ], -1).astype(np.float32)

    O = n_kf * obs_per_kf
    obs_kf = np.repeat(np.arange(n_kf, dtype=np.int32), obs_per_kf)
    obs_pt = rng.integers(0, n_pts, O).astype(np.int32)

    from monoorbslam3_tpu.backend import residuals as res
    R_cb = jnp.eye(3)
    t_cb = jnp.zeros(3)
    s_o = jax_tree_gather(kf_gt, obs_kf)
    uv = np.asarray(res.reprojection_residual(
        s_o, jnp.asarray(pts[obs_pt]), jnp.zeros((O, 2), jnp.float32),
        cam, R_cb, t_cb))
    uv = uv + rng.normal(0, 0.4, uv.shape).astype(np.float32)
    valid = np.isfinite(uv).all(1) & (np.abs(uv[:, 0] - 376) < 2000)

    dof = np.zeros((n_kf, 15), np.float32)
    dof[:-n_fixed] = 1.0

    E = n_kf - 1
    eye9 = jnp.broadcast_to(jnp.eye(9), (E, 9, 9))
    edge = PreintEdge(
        dR=jnp.broadcast_to(jnp.eye(3), (E, 3, 3)), dV=jnp.zeros((E, 3)),
        dP=jnp.zeros((E, 3)), JRg=jnp.zeros((E, 3, 3)), JVg=jnp.zeros((E, 3, 3)),
        JVa=jnp.zeros((E, 3, 3)), JPg=jnp.zeros((E, 3, 3)), JPa=jnp.zeros((E, 3, 3)),
        bg0=jnp.zeros((E, 3)), ba0=jnp.zeros((E, 3)), dt=jnp.full(E, 0.25),
        L_inv=eye9,
    )
    # perturb the optimized states so iterations do real work
    dx = rng.normal(0, 0.01, (n_kf, 15)).astype(np.float32) * dof
    kf0 = res.retract_kf(kf_gt, jnp.asarray(dx))

    problem = BAProblem(
        kf=kf0, kf_dof=jnp.asarray(dof),
        points=jnp.asarray(pts + rng.normal(0, 0.02, pts.shape).astype(np.float32)),
        pt_active=jnp.ones(n_pts, bool),
        obs_kf=jnp.asarray(obs_kf), obs_pt=jnp.asarray(obs_pt),
        obs_uv=jnp.asarray(uv.astype(np.float32)),
        obs_inv_sigma2=jnp.ones(O), obs_valid=jnp.asarray(valid),
        ie_i=jnp.arange(E, dtype=jnp.int32),
        ie_j=jnp.arange(1, E + 1, dtype=jnp.int32),
        ie_edge=edge, ie_valid=jnp.ones(E, bool),
        walk_inv_sigma=jnp.full((E, 6), 30.0), walk_valid=jnp.ones(E, bool),
        prior_inv_sigma=jnp.zeros((n_kf, 15)), prior_ref=kf0,
    )
    return problem, cam


def jax_tree_gather(kf, idx):
    import jax
    return jax.tree_util.tree_map(lambda a: a[idx], kf)


def _scan_time_ms(stage_fn, reps: int, tries: int = 3):
    """On-device timing: run `stage_fn` (eps-scalar -> array) `reps` times
    inside ONE jitted lax.scan (the carried perturbation defeats CSE), so a
    measurement is a single dispatch + a single block and host dispatch
    cost stays out of the per-rep time. Returns the best of `tries`."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def run():
        def body(acc, _):
            out = stage_fn(acc * 1e-20)
            return acc + out.ravel()[0].astype(jnp.float32) * 1e-30, None

        acc, _ = jax.lax.scan(body, jnp.float32(0.0), None, length=reps)
        return acc

    out = run()
    jax.block_until_ready(out)
    best = float("inf")
    for _ in range(tries):
        t0 = time.perf_counter()
        out = run()
        jax.block_until_ready(out)
        best = min(best, time.perf_counter() - t0)
    return best / reps * 1e3


def bench_frontend(reps: int = 300):
    """ORB extraction + local-map Hamming match + pose-opt: one tracking
    step (the reference's implicit real-time target, SURVEY.md §6)."""
    import __graft_entry__ as ge

    fn, args = ge.entry()
    image, rest = args[0], args[1:]

    def step(eps):
        R, t, n = fn(image + eps, *rest)
        return t

    return 1e3 / _scan_time_ms(step, reps)


def main():
    import jax
    import jax.numpy as jnp

    from monoorbslam3_tpu.backend.solver import schur_ba
    from monoorbslam3_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    problem, cam = build_problem()
    R_cb = jnp.eye(3)
    t_cb = jnp.zeros(3)
    n_iters = 10

    # converged cost for the honesty check (same optimum as the f64 CPU run)
    kf, pts, info = schur_ba(problem, cam, R_cb, t_cb, n_iters=n_iters)
    jax.block_until_ready((kf, pts))

    def ba_step(eps):
        pb = problem._replace(points=problem.points + eps)
        _, pts_out, _ = schur_ba(pb, cam, R_cb, t_cb, n_iters=n_iters)
        return pts_out

    dt = _scan_time_ms(ba_step, reps=40) / 1e3  # see _scan_time_ms
    iters_per_s = n_iters / dt
    frontend_fps = bench_frontend()
    dev = jax.devices()[0]

    out = {
        "metric": "local_ba_iters_per_s",
        "value": round(iters_per_s, 2),
        "unit": "iters/s",
        "vs_baseline": round(iters_per_s / G2O_BASELINE_ITERS_PER_S, 2),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "window": "24 opt + 8 fixed KFs, 2048 pts, 6144 obs, VI edges",
        "cost0": float(info["cost0"]),
        "cost": float(info["cost"]),
        # secondary: full tracking-step throughput (752x480 image, 1024 feat)
        # vs the reference's implicit 20 Hz real-time target
        "frontend_fps": round(frontend_fps, 1),
        "frontend_vs_20hz": round(frontend_fps / 20.0, 2),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
