"""Golden tests for IMU preintegration against an analytic trajectory.

Deterministic analog of the reference's imu_test dead-reckoning check
(test/Imu/imuTest.cpp:58-98), with exact analytic ground truth instead of a
saved trajectory.
"""

import numpy as np
import jax.numpy as jnp

from monoorbslam3_tpu.models.imu import (
    GRAVITY_VALUE, ImuBuffer, ImuCalib, preintegrate,
)
from monoorbslam3_tpu.sim import Trajectory

G_W = np.array([0.0, 0.0, -GRAVITY_VALUE])

CALIB = ImuCalib.create(
    R_bc=np.eye(3), t_bc=np.zeros(3),
    noise_gyro=1.7e-4, noise_acc=2e-3, walk_gyro=2e-5, walk_acc=3e-3,
    freq=200.0,
)


def _expected_deltas(traj, t0, t1):
    R0 = traj.R_wb(t0)
    R1 = traj.R_wb(t1)
    p0, p1 = traj.pos(t0), traj.pos(t1)
    v0, v1 = traj.vel(t0), traj.vel(t1)
    dt = t1 - t0
    dR = R0.T @ R1
    dV = R0.T @ (v1 - v0 - G_W * dt)
    dP = R0.T @ (p1 - p0 - v0 * dt - 0.5 * G_W * dt * dt)
    return dR, dV, dP


def test_preintegration_matches_analytic():
    traj = Trajectory()
    t0, t1, freq = 2.0, 2.5, 200.0
    gyro, acc, dts = traj.imu_samples(t0, t1, freq)
    mask = np.ones(len(dts), np.float32)
    pre = preintegrate(gyro, acc, dts, mask, jnp.zeros(3), jnp.zeros(3), CALIB)

    dR, dV, dP = _expected_deltas(traj, t0, t0 + len(dts) / freq)
    np.testing.assert_allclose(np.asarray(pre.dR), dR, atol=2e-3)
    np.testing.assert_allclose(np.asarray(pre.dV), dV, atol=6e-3)
    np.testing.assert_allclose(np.asarray(pre.dP), dP, atol=4e-3)
    assert abs(float(pre.dt) - len(dts) / freq) < 1e-6


def test_mask_padding_is_noop():
    traj = Trajectory()
    gyro, acc, dts = traj.imu_samples(0.0, 0.3, 200.0)
    n = len(dts)
    pad = 32
    gyro_p = np.concatenate([gyro, np.full((pad, 3), 99.0, np.float32)])
    acc_p = np.concatenate([acc, np.full((pad, 3), -55.0, np.float32)])
    dts_p = np.concatenate([dts, np.full(pad, 0.5, np.float32)])
    mask = np.concatenate([np.ones(n, np.float32), np.zeros(pad, np.float32)])

    a = preintegrate(gyro, acc, dts, np.ones(n, np.float32), jnp.zeros(3), jnp.zeros(3), CALIB)
    b = preintegrate(gyro_p, acc_p, dts_p, mask, jnp.zeros(3), jnp.zeros(3), CALIB)
    np.testing.assert_allclose(np.asarray(a.dR), np.asarray(b.dR), atol=1e-6)
    np.testing.assert_allclose(np.asarray(a.dP), np.asarray(b.dP), atol=1e-6)
    np.testing.assert_allclose(np.asarray(a.C), np.asarray(b.C), atol=1e-9)


def test_bias_correction_first_order():
    """Preintegrating at bias b0 then first-order-correcting to b1 should
    approximate preintegrating at b1 (reference getters, Imu.cpp:182-204)."""
    traj = Trajectory()
    bg_true = np.array([0.004, -0.003, 0.002], np.float32)
    ba_true = np.array([0.03, 0.01, -0.02], np.float32)
    gyro, acc, dts = traj.imu_samples(1.0, 1.5, 200.0, bg=bg_true, ba=ba_true)
    mask = np.ones(len(dts), np.float32)

    pre0 = preintegrate(gyro, acc, dts, mask, jnp.zeros(3), jnp.zeros(3), CALIB)
    pre1 = preintegrate(gyro, acc, dts, mask, jnp.asarray(bg_true), jnp.asarray(ba_true), CALIB)

    dR_corr = pre0.delta_rotation(jnp.asarray(bg_true))
    dV_corr = pre0.delta_velocity(jnp.asarray(bg_true), jnp.asarray(ba_true))
    dP_corr = pre0.delta_position(jnp.asarray(bg_true), jnp.asarray(ba_true))

    np.testing.assert_allclose(np.asarray(dR_corr), np.asarray(pre1.dR), atol=2e-4)
    np.testing.assert_allclose(np.asarray(dV_corr), np.asarray(pre1.dV), atol=2e-3)
    np.testing.assert_allclose(np.asarray(dP_corr), np.asarray(pre1.dP), atol=1e-3)


def test_covariance_psd_and_growth():
    traj = Trajectory()
    gyro, acc, dts = traj.imu_samples(0.0, 1.0, 200.0)
    mask = np.ones(len(dts), np.float32)
    pre = preintegrate(gyro, acc, dts, mask, jnp.zeros(3), jnp.zeros(3), CALIB)
    C = np.asarray(pre.C, np.float64)
    C = (C + C.T) / 2
    eig = np.linalg.eigvalsh(C)
    assert eig.min() > -1e-10
    # longer windows accumulate more uncertainty
    pre_short = preintegrate(gyro[:50], acc[:50], dts[:50], mask[:50],
                             jnp.zeros(3), jnp.zeros(3), CALIB)
    assert np.trace(np.asarray(pre.C)[:9, :9]) > np.trace(np.asarray(pre_short.C)[:9, :9])


def test_imu_buffer_merge_equivalence():
    """Merging two windows == integrating the concatenated samples
    (reference MergeNext, Imu.cpp:157-172)."""
    traj = Trajectory()
    g1, a1, d1 = traj.imu_samples(0.0, 0.4, 200.0)
    g2, a2, d2 = traj.imu_samples(0.4, 0.8, 200.0)

    buf1 = ImuBuffer()
    for g, a, d in zip(g1, a1, d1):
        buf1.add(g, a, d)
    buf2 = ImuBuffer()
    for g, a, d in zip(g2, a2, d2):
        buf2.add(g, a, d)
    buf1.extend(buf2)
    merged = buf1.integrate(np.zeros(3), np.zeros(3), CALIB)

    g_all = np.concatenate([g1, g2])
    a_all = np.concatenate([a1, a2])
    d_all = np.concatenate([d1, d2])
    direct = preintegrate(g_all, a_all, d_all, np.ones(len(d_all), np.float32),
                          jnp.zeros(3), jnp.zeros(3), CALIB)
    np.testing.assert_allclose(np.asarray(merged.dR), np.asarray(direct.dR), atol=1e-6)
    np.testing.assert_allclose(np.asarray(merged.dP), np.asarray(direct.dP), atol=1e-5)


def test_tree_preintegration_matches_sequential():
    """preintegrate_tree (log-depth associative reduction, the hot
    path) must reproduce the sequential scan exactly (to f32 rounding):
    deltas, 15x15 covariance, and all five bias Jacobians, including
    mask padding."""
    import jax.numpy as jnp

    from monoorbslam3_tpu.models.imu import (
        ImuCalib, preintegrate, preintegrate_tree,
    )

    calib = ImuCalib.create(
        R_bc=np.eye(3), t_bc=np.zeros(3), noise_gyro=1.7e-4, noise_acc=2e-3,
        walk_gyro=2e-5, walk_acc=3e-3, freq=200.0)
    rng = np.random.default_rng(3)
    for n, n_real in [(1, 1), (7, 7), (64, 50), (200, 177)]:
        g = rng.normal(0, 0.4, (n, 3)).astype(np.float32)
        a = (np.array([0, 0, 9.8], np.float32)
             + rng.normal(0, 0.8, (n, 3)).astype(np.float32))
        d = rng.uniform(0.004, 0.006, n).astype(np.float32)
        m = np.zeros(n, np.float32)
        m[:n_real] = 1.0
        bg = np.array([0.01, -0.02, 0.005], np.float32)
        ba = np.array([0.05, 0.02, -0.03], np.float32)

        seq = preintegrate(g, a, d, m, jnp.asarray(bg), jnp.asarray(ba), calib)
        tree = preintegrate_tree(g, a, d, m, jnp.asarray(bg), jnp.asarray(ba),
                                 calib)
        for name in ("dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa"):
            np.testing.assert_allclose(
                np.asarray(getattr(tree, name)), np.asarray(getattr(seq, name)),
                rtol=2e-4, atol=2e-5, err_msg=f"{name} n={n}")
        np.testing.assert_allclose(float(tree.dt), float(seq.dt), rtol=1e-6)
        np.testing.assert_allclose(np.asarray(tree.C), np.asarray(seq.C),
                                   rtol=3e-3, atol=1e-12,
                                   err_msg=f"C n={n}")


def test_decimated_preserves_integral():
    """ImuBuffer.decimated halves the sample count but preserves total dt
    and the preintegrated delta to discretization accuracy (the merged
    full-polish windows rely on this instead of silent truncation)."""
    import jax.numpy as jnp

    from monoorbslam3_tpu.models.imu import ImuBuffer, ImuCalib

    calib = ImuCalib.create(
        R_bc=np.eye(3), t_bc=np.zeros(3), noise_gyro=1.7e-4, noise_acc=2e-3,
        walk_gyro=2e-5, walk_acc=3e-3, freq=200.0)
    rng = np.random.default_rng(5)
    buf = ImuBuffer()
    # smooth slowly-varying signal at 200 Hz, 6 s -> 1200 samples
    tgrid = np.arange(1200) * 0.005
    for i, t in enumerate(tgrid):
        g = 0.2 * np.sin(0.8 * t + np.arange(3))
        a = np.array([0.3 * np.cos(0.5 * t), 0.1, 9.8])
        buf.add(g, a, 0.005)
    dec = buf.decimated(512)
    assert dec.n <= 512
    np.testing.assert_allclose(dec.dts[:dec.n].sum(),
                               buf.dts[:buf.n].sum(), rtol=1e-5)
    bg = jnp.zeros(3)
    ba = jnp.zeros(3)
    p_full = buf.integrate(bg, ba, calib, capacity=2048)
    p_dec = dec.integrate(bg, ba, calib, capacity=512)
    np.testing.assert_allclose(float(p_dec.dt), float(p_full.dt), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(p_dec.dR), np.asarray(p_full.dR),
                               atol=2e-3)
    np.testing.assert_allclose(np.asarray(p_dec.dV), np.asarray(p_full.dV),
                               rtol=0, atol=3e-2)
    np.testing.assert_allclose(np.asarray(p_dec.dP), np.asarray(p_full.dP),
                               rtol=4e-3, atol=1e-2)
