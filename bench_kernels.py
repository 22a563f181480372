"""Per-kernel speed-of-light benchmark (BASELINE.md: "BA + matching
kernels at speed-of-light per chip").

For each hot kernel this prints one JSON line with the measured time
(scan-amortized on device, see bench.py:_scan_time_ms) and the roofline
bound on this card — max(FLOPs / peak_flops, bytes / peak_bw) — plus the
achieved fraction of speed-of-light.

Two regimes matter and are reported separately:
- real-time shapes (one 752x480 frame, 1024 features, the 24-KF BA
  window): small problems are LATENCY-bound — the bound is the kernel-
  launch floor, not bandwidth;
- bulk shapes (large Hamming blocks): these are where roofline fractions
  are meaningful.

Peaks come from `PEAKS`, keyed by `device_kind`; a device that is not in
the table is an error. There is no CPU mode.

Usage: python bench_kernels.py   (never concurrently with bench.py)
"""

import json

import numpy as np

# Dense (no sparsity) rates from NVIDIA's H100 SXM data sheet.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bps": 3.35e12},
}


def device_peaks(device) -> dict:
    kind = device.device_kind
    if kind not in PEAKS:
        raise SystemExit(f"no peak table for device kind {kind!r} "
                         f"(platform {device.platform}); known: {sorted(PEAKS)}")
    return PEAKS[kind]


def report(name, ms, flops, bytes_, shape, peaks, note=""):
    sol_us = max(flops / peaks["bf16_flops"], bytes_ / peaks["hbm_bps"]) * 1e6
    frac = sol_us / (ms * 1e3) if ms > 0 else 0.0
    print(json.dumps({
        "metric": f"kernel_{name}",
        "value": round(ms * 1e3, 1), "unit": "us",
        "sol_us": round(sol_us, 1),
        "sol_fraction": round(frac, 3),
        "shape": shape, "note": note,
    }))


def main():
    import jax
    import jax.numpy as jnp

    from bench import _scan_time_ms
    from monoorbslam3_tpu.ops import matching
    from monoorbslam3_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    peaks = device_peaks(dev)
    print(json.dumps({"device": {"platform": dev.platform,
                                 "kind": dev.device_kind,
                                 "count": len(jax.devices())}}))
    rng = np.random.default_rng(0)

    # ---- Hamming distance matrix (the matching core) -------------------
    # real-time shape: 1024 x 1024 x 256 bits
    for N, M, reps, tag in [(1024, 1024, 400, "rt"), (8192, 8192, 60, "bulk")]:
        da = jnp.asarray(rng.integers(0, 2**32, (N, 8), dtype=np.uint32))
        db = jnp.asarray(rng.integers(0, 2**32, (M, 8), dtype=np.uint32))

        def ham(eps, da=da, db=db):
            return matching.hamming_matrix(
                da ^ eps.astype(jnp.uint32), db).astype(jnp.float32)

        ms = _scan_time_ms(ham, reps)
        flops = 2.0 * N * M * 256  # bf16 matmul
        bytes_ = (N + M) * 256 * 2 + N * M * 4  # unpacked operands + i32 out
        report(f"hamming_{tag}", ms, flops, bytes_, f"{N}x{M}x256b", peaks,
               "+-1 bit-plane bf16 matmul (ops/matching.py)")

    # ---- full masked match step (the production fused path) ------------
    from monoorbslam3_tpu.ops.fused_match import projected_match

    da = jnp.asarray(rng.integers(0, 2**32, (1024, 8), dtype=np.uint32))
    db = jnp.asarray(rng.integers(0, 2**32, (1024, 8), dtype=np.uint32))
    uv = jnp.asarray(rng.uniform(0, 700, (1024, 2)).astype(np.float32))
    xy = jnp.asarray(rng.uniform(0, 700, (1024, 2)).astype(np.float32))
    rad = jnp.full(1024, 15.0, jnp.float32)
    ones = np.ones(1024, bool)

    def match(eps):
        idx, dist = projected_match(
            da ^ eps.astype(jnp.uint32), db, uv_a=uv, xy_b=xy, radius=rad,
            valid_a=ones, valid_b=ones, max_dist=matching.TH_HIGH, ratio=0.9)
        return dist.astype(jnp.float32)

    ms = _scan_time_ms(match, 300)
    flops = 2 * (2.0 * 1024 * 1024 * 256)  # fwd + transposed mutual pass
    bytes_ = 2 * 2 * 1024 * 256 * 2
    report("match_step_rt", ms, flops, bytes_, "1024x1024 gated", peaks,
           "fused gate + hamming + top-2 + mutual")

    # ---- ORB extraction: one frame --------------------------------------
    from monoorbslam3_tpu.ops.orb import OrbExtractor

    ext = OrbExtractor(480, 752, n_features=1024)
    img = jnp.asarray(rng.uniform(0, 255, (480, 752)).astype(np.float32))

    def extract(eps):
        return ext(img + eps)["xy"]

    ms = _scan_time_ms(extract, 100)
    # dominant data: pyramid f32 reads/writes across 8 levels (~3.26x area)
    # x (blur + FAST + score + gather passes ~ 5 touches)
    px = 752 * 480 * 3.26
    report("orb_extract_frame", ms, 0.0, px * 4 * 5, "752x480, 8 levels",
           peaks, "latency regime: a chain of small fused kernels")

    # ---- IMU preintegration scan (200 samples = one 1 s KF window) -----
    from monoorbslam3_tpu.models.imu import ImuBuffer, ImuCalib

    calib = ImuCalib.create(R_bc=np.eye(3), t_bc=np.zeros(3),
                            noise_gyro=1.7e-4, noise_acc=2e-3,
                            walk_gyro=2e-5, walk_acc=3e-3, freq=200.0)
    buf = ImuBuffer()
    for _ in range(200):
        buf.add(rng.normal(0, 0.01, 3), [0, 0, 9.8] + rng.normal(0, 0.01, 3),
                0.005)
    bg = jnp.zeros(3, jnp.float32)

    def preint(eps):
        pre = buf.integrate(bg + eps, np.zeros(3, np.float32), calib)
        return pre.dP

    ms = _scan_time_ms(preint, 100)
    report("preintegrate_200", ms, 200 * 3000.0, 200 * 7 * 4,
           "200 samples, 15x15 cov", peaks, "log-depth tree reduction")

    # ---- BA single iteration (the 10x-vs-g2o window) --------------------
    from bench import build_problem
    from monoorbslam3_tpu.backend.solver import schur_ba

    problem, cam = build_problem()
    R_cb = jnp.eye(3)
    t_cb = jnp.zeros(3)

    def ba1(eps):
        pb = problem._replace(points=problem.points + eps)
        _, pts_out, _ = schur_ba(pb, cam, R_cb, t_cb, n_iters=1)
        return pts_out

    ms = _scan_time_ms(ba1, 60)
    # visual linearize dominates FLOPs: 6144 obs x (jac 2x21 + outer 21^2)
    o = 6144
    flops = o * (2 * 21 * 40 + 21 * 21 * 2 * 2)
    bytes_ = o * (21 * 2 + 21 * 21) * 4 + 2048 * 9 * 4
    report("schur_ba_iter", ms, flops, bytes_,
           "32 KF, 2048 pts, 6144 obs", peaks,
           "relinearize + landmark Schur + reduced Cholesky + retract")


if __name__ == "__main__":
    main()
