"""Schur-BA assembly on the GPU: precision, time and run-to-run repeatability.

    python experiments/ba_assembly_probe.py [--tree DIR] [--label NAME] [--sums]
                                            [--small]

Imports `monoorbslam3_tpu` and `bench` from DIR (default: this checkout),
so another checkout (the parent commit unpacked with `git archive`, say)
is measured the same way in its own process. One JSON line per reading:

- `sums` (with --sums, this checkout's solver only): the visual
  assembly's per-KF, per-point and pose-landmark coupling sums at the
  bench window, as the stacked one-hot matmul at DEFAULT, HIGH and
  HIGHEST and as `solver.visual_block_sums`, each against float64 numpy
  (largest error relative to the largest magnitude of each sum) and timed;
- `solve`: `schur_ba`, 10 iterations, at the bench window (24+8 KFs, 2048
  points, 6144 observations) with the observations in per-KF order
  ("grouped") and shuffled ("flat"), and at the full-polish shape (96
  KFs, 4096 points, 96 x 192 observations, grouped): ms per solve (host
  clock around a blocking call, median of 20), the converged cost, and
  how many distinct results 5 solves of the same input give (1 means
  bitwise repeatable). A tree whose `schur_ba` takes `grouped_obs` gets
  it for the grouped order, as its mapper passed it.

The problems are built on the host CPU backend, so every tree and every
precision setting solves the same observations. Set
XLA_FLAGS=--xla_gpu_deterministic_ops=true to see its effect. `--small`
shrinks every shape for a rehearsal on the CPU.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import os
import statistics
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BENCH = dict(n_kf=32, n_fixed=8, n_pts=2048, obs_per_kf=192)
POLISH = dict(n_kf=96, n_fixed=1, n_pts=4096, obs_per_kf=192)
SMALL = dict(n_kf=6, n_fixed=2, n_pts=96, obs_per_kf=24)


def emit(probe, label, **kw):
    print(json.dumps({"probe": probe, "tree": label, **kw}), flush=True)


def build(bench, jax, kw, flat):
    with jax.default_device(jax.devices("cpu")[0]):
        problem, cam = bench.build_problem(**kw)
    if flat:
        perm = np.random.default_rng(1).permutation(problem.obs_kf.shape[0])
        problem = problem._replace(**{
            f: np.asarray(getattr(problem, f))[perm] for f in (
                "obs_kf", "obs_pt", "obs_uv", "obs_inv_sigma2", "obs_valid")})
    problem = jax.tree_util.tree_map(np.asarray, problem)
    return jax.device_put(problem, jax.devices()[0]), cam


def digest(tree, jax):
    h = hashlib.sha256()
    for leaf in jax.tree_util.tree_leaves(tree):
        h.update(np.ascontiguousarray(np.asarray(leaf)).tobytes())
    return h.hexdigest()[:16]


def probe_solves(label, jax, bench, schur_ba, small=False):
    import jax.numpy as jnp

    takes_grouped = "grouped_obs" in inspect.signature(schur_ba).parameters
    R_cb, t_cb = jnp.eye(3), jnp.zeros(3)
    bench_kw, polish_kw = (SMALL, SMALL) if small else (BENCH, POLISH)
    for shape, kw, flat in (("bench_grouped", bench_kw, False),
                            ("bench_flat", bench_kw, True),
                            ("polish_grouped", polish_kw, False)):
        problem, cam = build(bench, jax, kw, flat)
        extra = ({"grouped_obs": kw["obs_per_kf"]}
                 if takes_grouped and not flat else {})

        def solve():
            kf, pts, info = schur_ba(problem, cam, R_cb, t_cb, n_iters=10,
                                     **extra)
            return jax.block_until_ready((kf, pts, info))

        t0 = time.perf_counter()
        kf, pts, info = solve()
        compile_s = time.perf_counter() - t0
        times = []
        for _ in range(20):
            t0 = time.perf_counter()
            solve()
            times.append((time.perf_counter() - t0) * 1e3)
        outs = {digest(solve()[:2], jax) for _ in range(5)}
        emit("solve", label, shape=shape, K=kw["n_kf"], P=kw["n_pts"],
             O=kw["n_kf"] * kw["obs_per_kf"], grouped_obs=bool(extra),
             first_call_s=compile_s, ms_median=statistics.median(times),
             ms_min=min(times), cost0=float(info["cost0"]),
             cost=float(info["cost"]), distinct_of_5=len(outs))


def probe_sums(label, jax, bench, small=False):
    import jax.numpy as jnp

    sys.path.insert(0, ROOT)
    import chip_smoke
    from monoorbslam3_tpu.backend import solver
    from monoorbslam3_tpu.utils.precision import f32_matmuls

    problem, cam = build(bench, jax, SMALL if small else BENCH, flat=False)
    K, P = problem.kf_dof.shape[0], problem.points.shape[0]

    @jax.jit
    @f32_matmuls
    def blocks(pb):
        r_v, Jc, Jl, w_v, _, _ = solver._vis_linearize(
            pb, cam, jnp.eye(3), jnp.zeros(3), solver.CHI2_MONO)
        Ja = jnp.concatenate([Jc, Jl, -r_v[:, :, None]], -1)
        return jnp.einsum("oik,oil->okl", Ja * w_v[:, None, None], Ja)

    B = blocks(problem)
    obs_kf, obs_pt = problem.obs_kf, problem.obs_pt
    want = chip_smoke.block_sums_float64(
        np.asarray(B), np.asarray(obs_kf), np.asarray(obs_pt), K, P)

    def onehot(precision):
        @jax.jit
        def sums(B, obs_kf, obs_pt):
            # the stacked one-hot formulation the assembly used before the
            # segment sums: [Ek | Ep]^T @ [Hc | bc | Hll | bl | W expanded]
            O = B.shape[0]
            Ek = (obs_kf[:, None] == jnp.arange(K)[None]).astype(jnp.float32)
            Ep = (obs_pt[:, None] == jnp.arange(P)[None]).astype(jnp.float32)
            cols = jnp.concatenate([
                B[:, :6, :6].reshape(O, 36), B[:, :6, 9:10].reshape(O, 6),
                B[:, 6:9, 6:9].reshape(O, 9), B[:, 6:9, 9:10].reshape(O, 3),
                (Ek[:, :, None] * B[:, :6, 6:9].reshape(O, 1, 18)
                 ).reshape(O, K * 18)], -1)
            S = jnp.matmul(jnp.concatenate([Ek, Ep], 1).T, cols,
                           precision=precision)
            return (S[:K, :42], S[K:, 42:54],
                    S[K:, 54:].reshape(P, K * 6, 3))
        return sums

    variants = {f"onehot_{p.name}": onehot(p) for p in (
        jax.lax.Precision.DEFAULT, jax.lax.Precision.HIGH,
        jax.lax.Precision.HIGHEST)}
    variants["visual_block_sums"] = jax.jit(
        lambda B, k, p: solver.visual_block_sums(B, k, p, K, P))
    for name, fn in variants.items():
        got = [np.asarray(x, np.float64) for x in fn(B, obs_kf, obs_pt)]
        rel = [float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))
               for g, w in zip(got, want)]
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(50):
                out = fn(B, obs_kf, obs_pt)
            jax.block_until_ready(out)
            times.append((time.perf_counter() - t0) / 50 * 1e6)
        emit("sums", label, variant=name,
             max_rel_err_cam_pt_coupling=rel, us_median=statistics.median(times))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--label", default="this")
    ap.add_argument("--sums", action="store_true")
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args()

    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    platforms = os.environ.get("JAX_PLATFORMS")
    if platforms and "cpu" not in platforms.split(","):
        os.environ["JAX_PLATFORMS"] = platforms + ",cpu"
    import jax

    import bench
    from monoorbslam3_tpu.backend.solver import schur_ba

    assert os.path.dirname(os.path.abspath(bench.__file__)) == tree, bench.__file__
    dev = jax.devices()[0]
    emit("device", args.label, platform=dev.platform, kind=dev.device_kind,
         xla_flags=os.environ.get("XLA_FLAGS", ""))
    if args.sums:
        probe_sums(args.label, jax, bench, args.small)
    probe_solves(args.label, jax, bench, schur_ba, args.small)


if __name__ == "__main__":
    main()
