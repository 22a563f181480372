"""BA plateau forensics: per-stage timings of the
schur_ba iteration at the bench window on the current default device, plus
candidate levers:

- the reduced-system solve in isolation: lax Cholesky vs the closed-form
  log-depth recursion (inv_spd_blocks15) at 480 dims, single + batched;
- end-to-end schur_ba throughput with each lever, with the converged-cost
  honesty check (the bench window's f64-checked optimum is ~1118.6 after
  10 iters; a lever that degrades convergence is a non-result).

All timings scan-amortized: N reps inside one jitted lax.scan with a
carried perturbation, one block, best of 3 (see bench._scan_time_ms).
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402


def scan_time_ms(stage_fn, reps, tries=3):
    import jax
    import jax.numpy as jnp

    @jax.jit
    def run():
        def body(acc, _):
            out = stage_fn(acc * 1e-20)
            return acc + out.ravel()[0].astype(jnp.float32) * 1e-30, None

        acc, _ = jax.lax.scan(body, jnp.float32(0.0), None, length=reps)
        return acc

    jax.block_until_ready(run())
    best = float("inf")
    for _ in range(tries):
        t0 = time.perf_counter()
        jax.block_until_ready(run())
        best = min(best, time.perf_counter() - t0)
    return best / reps * 1e3


def main():
    import jax
    import jax.numpy as jnp

    from monoorbslam3_tpu.backend.solver import (
        inv_spd_blocks15, schur_ba,
    )

    dev = jax.devices()[0]
    out = {"device": {"platform": dev.platform, "kind": dev.device_kind}}
    problem, cam = bench.build_problem()
    R_cb = jnp.eye(3)
    t_cb = jnp.zeros(3)
    n_iters = 10

    # --- end-to-end schur_ba ---
    kf, pts, info = schur_ba(problem, cam, R_cb, t_cb, n_iters=n_iters)
    jax.block_until_ready(pts)

    def ba_step(eps):
        pb = problem._replace(points=problem.points + eps)
        return schur_ba(pb, cam, R_cb, t_cb, n_iters=n_iters)[1]

    dt = scan_time_ms(ba_step, reps=40)
    out["ba"] = {"ms_per_iter": round(dt / n_iters, 4),
                 "iters_per_s": round(1e3 * n_iters / dt, 1),
                 "cost": round(float(info["cost"]), 1)}
    print(json.dumps({"ba": out["ba"]}), flush=True)

    # --- reduced solve in isolation at the real shape (480 = 32*15) ---
    n = 480
    rng = np.random.default_rng(0)
    A = rng.normal(size=(n, n)).astype(np.float32) / np.sqrt(n)
    S = jnp.asarray(A @ A.T + 0.1 * np.eye(n, dtype=np.float32))
    b = jnp.asarray(rng.normal(size=n).astype(np.float32))

    def chol_solve(eps):
        Sd = S + eps * jnp.eye(n)
        d = jnp.sqrt(jnp.maximum(jnp.diagonal(Sd), 1e-12))
        Sn = Sd / d[:, None] / d[None, :]
        L = jnp.linalg.cholesky(Sn)
        return (jax.scipy.linalg.cho_solve((L, True), b / d) / d)

    def rec_solve(eps):
        Sd = S + eps * jnp.eye(n)
        d = jnp.sqrt(jnp.maximum(jnp.diagonal(Sd), 1e-12))
        Sn = Sd / d[:, None] / d[None, :]
        return (inv_spd_blocks15(Sn, n // 15) @ (b / d)[:, None])[:, 0] / d

    out["chol_480_ms"] = round(scan_time_ms(chol_solve, 200), 4)
    out["recursion_480_ms"] = round(scan_time_ms(rec_solve, 200), 4)
    # accuracy of the recursion on this matrix
    x_c = np.asarray(chol_solve(jnp.float32(0.0)))
    x_r = np.asarray(rec_solve(jnp.float32(0.0)))
    resid = lambda x: float(np.linalg.norm(np.asarray(S) @ x - np.asarray(b))
                            / np.linalg.norm(np.asarray(b)))
    out["chol_relres"] = round(resid(x_c), 8)
    out["recursion_relres"] = round(resid(x_r), 8)

    # batched (the deferred LM uses G=1; parallel-lambda uses G=2)
    S2 = jnp.stack([S, S * 1.01])
    b2 = jnp.stack([b, b])

    def chol_solve2(eps):
        Sd = S2 + eps * jnp.eye(n)
        d = jnp.sqrt(jnp.maximum(
            jnp.diagonal(Sd, axis1=-2, axis2=-1), 1e-12))
        Sn = Sd / d[..., :, None] / d[..., None, :]
        L = jnp.linalg.cholesky(Sn)
        y = jax.scipy.linalg.solve_triangular(L, (b2 / d)[..., None],
                                              lower=True)
        x = jax.scipy.linalg.solve_triangular(
            jnp.swapaxes(L, -1, -2), y, lower=False)
        return x[..., 0] / d

    out["chol_480_G2_ms"] = round(scan_time_ms(chol_solve2, 200), 4)

    print(json.dumps(out))


if __name__ == "__main__":
    main()
