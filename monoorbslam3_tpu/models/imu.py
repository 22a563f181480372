"""IMU calibration + on-manifold preintegration as a `lax.scan`.

Analog of the reference IMU layer (modules/Sensor/Imu.h:15-147,
Imu.cpp:101-205): Forster-style preintegrated ΔR/ΔV/ΔP with 15x15 covariance
(9x9 propagated navigation block + accumulated 6x6 bias random walk) and
first-order bias-correction Jacobians JRg/JVg/JVa/JPg/JPa.

Design changes vs the reference:
- the per-sample update loop (Imu.cpp:101-148) becomes a single `lax.scan`
  over fixed-capacity, mask-padded sample arrays — one compiled kernel per
  capacity, replayable for re-integration after bias updates;
- `ImuCalib` is an immutable pytree, not a singleton;
- raw measurements live in host-side `ImuBuffer`s; re-integration and
  keyframe-merge (Imu.cpp:150-172) are a re-run of the scan on concatenated
  sample arrays.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils import lie

GRAVITY_VALUE = 9.80  # reference: Imu.h:15
# numpy, not jnp — device constants hoist as stale-able const buffers (jax 0.9)
GRAVITY_W = np.array([0.0, 0.0, -GRAVITY_VALUE], np.float32)


class ImuCalib(NamedTuple):
    """Extrinsics + noise model (reference: Imu.cpp:16-56)."""

    R_bc: jnp.ndarray  # [3, 3] camera->body rotation
    t_bc: jnp.ndarray  # [3]
    R_cb: jnp.ndarray  # [3, 3]
    t_cb: jnp.ndarray  # [3]
    cov_noise: jnp.ndarray  # [6] diagonal: gyro^2 x3, acc^2 x3 (discrete, per-sample)
    cov_walk: jnp.ndarray  # [6] diagonal bias random-walk per sample
    bg0: jnp.ndarray  # [3] initial gyro bias
    ba0: jnp.ndarray  # [3] initial acc bias
    freq: float

    @staticmethod
    def create(R_bc, t_bc, noise_gyro, noise_acc, walk_gyro, walk_acc,
               bg0=None, ba0=None, freq=200.0) -> "ImuCalib":
        R_bc = jnp.asarray(R_bc, jnp.float32)
        t_bc = jnp.asarray(t_bc, jnp.float32)
        R_cb = R_bc.T
        t_cb = -R_cb @ t_bc
        # noise/walk parameters are CONTINUOUS densities (the EuRoC yaml
        # convention: rad/s/sqrt(Hz), (rad/s)/s/sqrt(Hz)); the preintegration
        # consumes DISCRETE per-sample covariances. Discretization at the
        # sample rate (the reference's sf = sqrt(freq), Imu.cpp:39-50):
        #   noise:  sigma_discrete = density * sqrt(freq) -> var * freq
        #   walk:   increment over dt has var = density^2 * dt = var / freq
        # Getting this wrong (density used as discrete sigma) makes every
        # inertial edge freq-times overconfident in variance — measured as
        # ground-truth states standing at 25-60 sigma of the edge whitening,
        # which let the window BA crush vision and ramp the bias estimates.
        cov_noise = jnp.array([noise_gyro**2 * freq] * 3
                              + [noise_acc**2 * freq] * 3, jnp.float32)
        cov_walk = jnp.array([walk_gyro**2 / freq] * 3
                             + [walk_acc**2 / freq] * 3, jnp.float32)
        bg0 = jnp.zeros(3, jnp.float32) if bg0 is None else jnp.asarray(bg0, jnp.float32)
        ba0 = jnp.zeros(3, jnp.float32) if ba0 is None else jnp.asarray(ba0, jnp.float32)
        return ImuCalib(R_bc, t_bc, R_cb, t_cb, cov_noise, cov_walk, bg0, ba0, float(freq))


class Preintegrated(NamedTuple):
    """Result of preintegrating one sample window at a fixed linearization bias."""

    dR: jnp.ndarray  # [3, 3]
    dV: jnp.ndarray  # [3]
    dP: jnp.ndarray  # [3]
    C: jnp.ndarray  # [15, 15] covariance (r, v, p, bg, ba)
    JRg: jnp.ndarray  # [3, 3] d(dR)/d(bg)
    JVg: jnp.ndarray
    JVa: jnp.ndarray
    JPg: jnp.ndarray
    JPa: jnp.ndarray
    dt: jnp.ndarray  # [] total time
    bg: jnp.ndarray  # [3] linearization gyro bias
    ba: jnp.ndarray  # [3] linearization acc bias

    # --- first-order bias-corrected deltas (reference: Imu.cpp:182-204) ---

    def delta_rotation(self, bg_new: jnp.ndarray) -> jnp.ndarray:
        return lie.normalize_rotation(self.dR @ lie.exp_so3(self.JRg @ (bg_new - self.bg)))

    def delta_velocity(self, bg_new: jnp.ndarray, ba_new: jnp.ndarray) -> jnp.ndarray:
        return self.dV + self.JVg @ (bg_new - self.bg) + self.JVa @ (ba_new - self.ba)

    def delta_position(self, bg_new: jnp.ndarray, ba_new: jnp.ndarray) -> jnp.ndarray:
        return self.dP + self.JPg @ (bg_new - self.bg) + self.JPa @ (ba_new - self.ba)


def _empty_state(bg, ba):
    eye3 = jnp.eye(3, dtype=jnp.float32)
    zero3 = jnp.zeros(3, jnp.float32)
    zero33 = jnp.zeros((3, 3), jnp.float32)
    return Preintegrated(
        dR=eye3, dV=zero3, dP=zero3, C=jnp.zeros((15, 15), jnp.float32),
        JRg=zero33, JVg=zero33, JVa=zero33, JPg=zero33, JPa=zero33,
        dt=jnp.float32(0.0), bg=bg, ba=ba,
    )


def preintegrate(
    gyro: jnp.ndarray,  # [N, 3]
    acc: jnp.ndarray,  # [N, 3]
    dts: jnp.ndarray,  # [N]
    mask: jnp.ndarray,  # [N] bool/0-1; padded samples are skipped entirely
    bg: jnp.ndarray,  # [3] linearization gyro bias
    ba: jnp.ndarray,  # [3]
    calib: ImuCalib,
) -> Preintegrated:
    """Scan equivalent of PreIntegrator::IntegrateNewMeasurement (Imu.cpp:101-148)."""
    gyro = jnp.asarray(gyro, jnp.float32)
    acc = jnp.asarray(acc, jnp.float32)
    dts = jnp.asarray(dts, jnp.float32)
    maskf = jnp.asarray(mask, jnp.float32)

    cov_noise = jnp.diag(calib.cov_noise)
    cov_walk15 = jnp.zeros((15, 15), jnp.float32).at[9:, 9:].set(jnp.diag(calib.cov_walk))

    def step(s: Preintegrated, inputs):
        g, a_raw, dt, m = inputs
        w = g - bg
        a = a_raw - ba
        dt2 = dt * dt

        dP = s.dP + s.dV * dt + 0.5 * dt2 * (s.dR @ a)
        dV = s.dV + dt * (s.dR @ a)

        a_hat = lie.hat(a)
        dR_ahat = s.dR @ a_hat

        # A [9,9], B [9,6] exactly as Imu.cpp:105-138 (state order r, v, p)
        A = jnp.eye(9, dtype=jnp.float32)
        A = A.at[3:6, 0:3].set(-dR_ahat * dt)
        A = A.at[6:9, 0:3].set(-0.5 * dR_ahat * dt2)
        A = A.at[6:9, 3:6].set(jnp.eye(3) * dt)

        B = jnp.zeros((9, 6), jnp.float32)
        B = B.at[3:6, 3:6].set(s.dR * dt)
        B = B.at[6:9, 3:6].set(0.5 * s.dR * dt2)

        JPg = s.JPg + s.JVg * dt - 0.5 * dt2 * (dR_ahat @ s.JRg)
        JPa = s.JPa + s.JVa * dt - 0.5 * dt2 * s.dR
        JVg = s.JVg - dt * (dR_ahat @ s.JRg)
        JVa = s.JVa - dt * s.dR

        delta_w = w * dt
        deltaR = lie.exp_so3(delta_w)
        rightJ = lie.right_jacobian_so3(delta_w)
        dR = lie.normalize_rotation(s.dR @ deltaR)

        A = A.at[0:3, 0:3].set(deltaR.T)
        B = B.at[0:3, 0:3].set(rightJ * dt)

        C9 = A @ s.C[:9, :9] @ A.T + B @ cov_noise @ B.T
        C = s.C.at[:9, :9].set(C9) + cov_walk15

        JRg = deltaR.T @ s.JRg - rightJ * dt

        new = Preintegrated(
            dR=dR, dV=dV, dP=dP, C=C, JRg=JRg, JVg=JVg, JVa=JVa, JPg=JPg, JPa=JPa,
            dt=s.dt + dt, bg=s.bg, ba=s.ba,
        )
        # masked samples are a strict no-op
        out = jax.tree_util.tree_map(lambda n, o: m * n + (1.0 - m) * o, new, s)
        return out, None

    init = _empty_state(jnp.asarray(bg, jnp.float32), jnp.asarray(ba, jnp.float32))
    final, _ = jax.lax.scan(step, init, (gyro, acc, dts, maskf))
    return final


from ..utils.precision import f32_matmuls

preintegrate_jit = jax.jit(f32_matmuls(preintegrate))


# ---------------------------------------------------------------------------
# Tree (associative) preintegration — the hot path.
#
# The sequential scan above costs O(N) dependent micro-steps (each a chain
# of tiny 3x3/9x9 ops) per keyframe window. But preintegrated segments form a MONOID: two adjacent
# segments compose in closed form — state deltas, the 9x9 error transition
# A, the accumulated covariance, and all five bias Jacobians — so the window
# reduces as a binary tree: log2(N) levels of BATCHED small matmuls instead
# of N sequential steps. The composition below is derived exactly from the
# per-step recursions (Imu.cpp:101-148), so it matches `preintegrate` to
# f32 rounding (unit-tested).
#
# Error-coordinate bookkeeping: the per-step A mixes the cumulative rotation
# from the WINDOW start into the v/p rows. In a standalone segment those
# rows use the segment-local rotation; conjugating by
# Gamma(dR1) = blockdiag(I, dR1, dR1) re-expresses segment 2's propagation
# in segment 1's start frame:  A_ctx = Gamma(dR1) A2 Gamma(dR1)^T.
# ---------------------------------------------------------------------------


class _Seg(NamedTuple):
    dR: jnp.ndarray   # [..., 3, 3]
    dV: jnp.ndarray   # [..., 3]
    dP: jnp.ndarray   # [..., 3]
    dt: jnp.ndarray   # [...]
    A: jnp.ndarray    # [..., 9, 9] standalone error transition (r, v, p)
    C9: jnp.ndarray   # [..., 9, 9] accumulated measurement-noise covariance
    JRg: jnp.ndarray  # [..., 3, 3]
    JVg: jnp.ndarray
    JVa: jnp.ndarray
    JPg: jnp.ndarray
    JPa: jnp.ndarray
    n: jnp.ndarray    # [...] number of (real) samples — scales the bias walk


def _leaf_segments(gyro, acc, dts, maskf, bg, ba, calib) -> _Seg:
    """Vectorized single-sample segments; masked samples become the exact
    identity element (dt=0 => dR=I, A=I, C=0, J=0)."""
    dt = dts * maskf  # [N]
    w = (gyro - bg) * maskf[:, None]
    a = (acc - ba) * maskf[:, None]
    dt_ = dt[:, None, None]
    dt2_ = (dt * dt)[:, None, None]

    # exp and Jr of the same rotation increment share theta/hat/hat^2
    wdt = w * dt[:, None]
    Aw, Bw, Cw = lie.exp_jr_coeffs(wdt)
    Wh = lie.hat(wdt)
    W2h = Wh @ Wh
    eye_n = jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), Wh.shape)
    dR = eye_n + Aw[:, None, None] * Wh + Bw[:, None, None] * W2h  # [N, 3, 3]
    Jr = eye_n - Bw[:, None, None] * Wh + Cw[:, None, None] * W2h
    a_hat = jax.vmap(lie.hat)(a)

    N = gyro.shape[0]
    eye3 = jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), (N, 3, 3))
    A = jnp.zeros((N, 9, 9), jnp.float32)
    A = A.at[:, 0:3, 0:3].set(jnp.swapaxes(dR, -1, -2))
    A = A.at[:, 3:6, 0:3].set(-a_hat * dt_)
    A = A.at[:, 3:6, 3:6].set(eye3)
    A = A.at[:, 6:9, 0:3].set(-0.5 * a_hat * dt2_)
    A = A.at[:, 6:9, 3:6].set(eye3 * dt_)
    A = A.at[:, 6:9, 6:9].set(eye3)

    # C9 = B Sigma_noise B^T with B = [[Jr dt, 0], [0, I dt], [0, 0.5 I dt^2]]
    sg = calib.cov_noise[:3]  # gyro variances (diagonal)
    sa = calib.cov_noise[3:]
    JrD = Jr * dt_
    C9 = jnp.zeros((N, 9, 9), jnp.float32)
    C9 = C9.at[:, 0:3, 0:3].set(jnp.einsum("nij,j,nkj->nik", JrD, sg, JrD))
    diag_a = jnp.zeros((N, 3, 3), jnp.float32).at[
        :, jnp.arange(3), jnp.arange(3)].set(sa[None, :])
    C9 = C9.at[:, 3:6, 3:6].set(diag_a * dt2_)
    C9 = C9.at[:, 3:6, 6:9].set(diag_a * 0.5 * dt_ * dt2_)
    C9 = C9.at[:, 6:9, 3:6].set(diag_a * 0.5 * dt_ * dt2_)
    C9 = C9.at[:, 6:9, 6:9].set(diag_a * 0.25 * dt2_ * dt2_)

    z33 = jnp.zeros((N, 3, 3), jnp.float32)
    return _Seg(
        dR=dR, dV=a * dt[:, None], dP=0.5 * a * (dt * dt)[:, None], dt=dt,
        A=A, C9=C9,
        JRg=-JrD, JVg=z33, JVa=-eye3 * dt_, JPg=z33,
        JPa=-0.5 * eye3 * dt2_, n=maskf,
    )


def _compose_segments(s1: _Seg, s2: _Seg) -> _Seg:
    """Batched monoid op: s1 (earlier) then s2 (later)."""
    mm = jnp.matmul
    dR1, dR2 = s1.dR, s2.dR
    dt2 = s2.dt[..., None]

    # product of two rotations is near-SO(3) by construction: one Newton
    # polar step (eps -> O(eps^2)) replaces the batched 3x3 SVD the
    # sequential path uses (a latency-bound iterative kernel)
    dR = mm(dR1, dR2)
    eye3 = jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), dR.shape)
    dR = mm(dR, 1.5 * eye3 - 0.5 * mm(jnp.swapaxes(dR, -1, -2), dR))
    dV = s1.dV + jnp.einsum("nij,nj->ni", dR1, s2.dV)
    dP = s1.dP + s1.dV * dt2 + jnp.einsum("nij,nj->ni", dR1, s2.dP)

    # A_ctx = Gamma(dR1) A2 Gamma(dR1)^T with Gamma = blockdiag(I, dR1, dR1):
    # left-multiply v/p block-rows by dR1, right-multiply v/p block-cols by dR1^T
    A2 = s2.A
    N = A2.shape[0]

    def gamma_left(M):  # Gamma(dR1) @ M
        top = M[:, 0:3, :]
        mid = mm(dR1, M[:, 3:6, :])
        bot = mm(dR1, M[:, 6:9, :])
        return jnp.concatenate([top, mid, bot], axis=1)

    def gamma_right_T(M):  # M @ Gamma(dR1)^T
        left = M[:, :, 0:3]
        mid = mm(M[:, :, 3:6], jnp.swapaxes(dR1, -1, -2))
        right = mm(M[:, :, 6:9], jnp.swapaxes(dR1, -1, -2))
        return jnp.concatenate([left, mid, right], axis=2)

    A_ctx = gamma_right_T(gamma_left(A2))
    A = mm(A_ctx, s1.A)
    C9 = (mm(mm(A_ctx, s1.C9), jnp.swapaxes(A_ctx, -1, -2))
          + gamma_right_T(gamma_left(s2.C9)))

    A2_vt = A2[:, 3:6, 0:3]
    A2_pt = A2[:, 6:9, 0:3]
    JRg = mm(jnp.swapaxes(dR2, -1, -2), s1.JRg) + s2.JRg
    JVg = s1.JVg + mm(dR1, s2.JVg + mm(A2_vt, s1.JRg))
    JVa = s1.JVa + mm(dR1, s2.JVa)
    JPg = (s1.JPg + s1.JVg * dt2[..., None]
           + mm(dR1, s2.JPg + mm(A2_pt, s1.JRg)))
    JPa = s1.JPa + s1.JVa * dt2[..., None] + mm(dR1, s2.JPa)

    return _Seg(dR=dR, dV=dV, dP=dP, dt=s1.dt + s2.dt, A=A, C9=C9,
                JRg=JRg, JVg=JVg, JVa=JVa, JPg=JPg, JPa=JPa, n=s1.n + s2.n)


def preintegrate_tree(gyro, acc, dts, mask, bg, ba, calib: ImuCalib) -> Preintegrated:
    """Associative-reduction equivalent of `preintegrate`: identical result
    (to f32 rounding), log2(N) batched levels instead of N scan steps."""
    gyro = jnp.asarray(gyro, jnp.float32)
    acc = jnp.asarray(acc, jnp.float32)
    dts = jnp.asarray(dts, jnp.float32)
    maskf = jnp.asarray(mask, jnp.float32)
    bg = jnp.asarray(bg, jnp.float32)
    ba = jnp.asarray(ba, jnp.float32)

    n = gyro.shape[0]
    n_pad = max(1, 1 << (n - 1).bit_length())
    if n_pad != n:
        pad = n_pad - n
        gyro = jnp.pad(gyro, ((0, pad), (0, 0)))
        acc = jnp.pad(acc, ((0, pad), (0, 0)))
        dts = jnp.pad(dts, ((0, pad),))
        maskf = jnp.pad(maskf, ((0, pad),))

    seg = _leaf_segments(gyro, acc, dts, maskf, bg, ba, calib)
    while seg.dt.shape[0] > 1:
        a = jax.tree_util.tree_map(lambda x: x[0::2], seg)
        b = jax.tree_util.tree_map(lambda x: x[1::2], seg)
        seg = _compose_segments(a, b)
    seg = jax.tree_util.tree_map(lambda x: x[0], seg)

    C = jnp.zeros((15, 15), jnp.float32)
    C = C.at[:9, :9].set(seg.C9)
    C = C.at[jnp.arange(9, 15), jnp.arange(9, 15)].set(seg.n * calib.cov_walk)
    return Preintegrated(
        dR=seg.dR, dV=seg.dV, dP=seg.dP, C=C, JRg=seg.JRg, JVg=seg.JVg,
        JVa=seg.JVa, JPg=seg.JPg, JPa=seg.JPa, dt=seg.dt, bg=bg, ba=ba,
    )


preintegrate_tree_jit = jax.jit(f32_matmuls(preintegrate_tree))


class ImuBuffer:
    """Host-side raw-sample store backing one preintegration window.

    Plays the role of PreIntegrator::measurements (Imu.h:134): keeps raw
    (gyro, acc, dt) so the window can be re-integrated at a new bias
    (Imu.cpp:150-155) or merged into a neighbor on keyframe culling
    (Imu.cpp:157-172) by re-running the scan.
    """

    def __init__(self, capacity: int = 512):
        self.capacity = capacity
        self.gyro = np.zeros((capacity, 3), np.float32)
        self.acc = np.zeros((capacity, 3), np.float32)
        self.dts = np.zeros(capacity, np.float32)
        self.n = 0

    def add(self, gyro, acc, dt):
        if self.n >= self.capacity:
            self._grow()
        self.gyro[self.n] = gyro
        self.acc[self.n] = acc
        self.dts[self.n] = dt
        self.n += 1

    def _grow(self):
        new_cap = self.capacity * 2
        for name in ("gyro", "acc"):
            arr = np.zeros((new_cap, 3), np.float32)
            arr[: self.n] = getattr(self, name)[: self.n]
            setattr(self, name, arr)
        dts = np.zeros(new_cap, np.float32)
        dts[: self.n] = self.dts[: self.n]
        self.dts = dts
        self.capacity = new_cap

    def extend(self, other: "ImuBuffer"):
        for i in range(other.n):
            self.add(other.gyro[i], other.acc[i], other.dts[i])

    def clear(self):
        self.n = 0

    def decimated(self, cap: int) -> "ImuBuffer":
        """Time-weighted pairwise merge until n <= cap.

        Merged full-polish windows can span many keyframes
        (problems._merged_windows); `padded` would silently TRUNCATE past
        the preintegration capacity, leaving an edge whose delta covers
        less time than the keyframe gap it constrains — a systematically
        wrong measurement. Merging consecutive samples (dt summed, rates
        dt-weighted) preserves the integral's span with only a
        discretization-bandwidth loss, which the rotation-rate-adaptive
        integration-noise floor already models (residuals.PreintEdge)."""
        if self.n <= cap:
            return self
        out = ImuBuffer(self.capacity)
        g, a, d, n = self.gyro, self.acc, self.dts, self.n
        while n > cap:
            m = n // 2
            dt2 = d[: 2 * m : 2] + d[1 : 2 * m : 2]
            w = np.maximum(dt2, 1e-9)[:, None]
            g2 = (g[: 2 * m : 2] * d[: 2 * m : 2, None]
                  + g[1 : 2 * m : 2] * d[1 : 2 * m : 2, None]) / w
            a2 = (a[: 2 * m : 2] * d[: 2 * m : 2, None]
                  + a[1 : 2 * m : 2] * d[1 : 2 * m : 2, None]) / w
            if n % 2:
                g = np.concatenate([g2, g[n - 1 : n]])
                a = np.concatenate([a2, a[n - 1 : n]])
                d = np.concatenate([dt2, d[n - 1 : n]])
                n = m + 1
            else:
                g, a, d, n = g2, a2, dt2, m
        out.gyro[:n], out.acc[:n], out.dts[:n] = g[:n], a[:n], d[:n]
        out.n = n
        return out

    def padded(self, capacity: int | None = None):
        """Returns (gyro, acc, dts, mask) padded to a power-of-two capacity so
        the preintegration scan compiles for a small set of shapes."""
        cap = capacity or max(64, 1 << (max(1, self.n - 1)).bit_length())
        g = np.zeros((cap, 3), np.float32)
        a = np.zeros((cap, 3), np.float32)
        d = np.zeros(cap, np.float32)
        m = np.zeros(cap, np.float32)
        k = min(self.n, cap)
        g[:k] = self.gyro[:k]
        a[:k] = self.acc[:k]
        d[:k] = self.dts[:k]
        m[:k] = 1.0
        return g, a, d, m

    def integrate(self, bg, ba, calib: ImuCalib, capacity: int | None = None) -> Preintegrated:
        g, a, d, m = self.padded(capacity)
        # tree reduction: log2(N) batched levels vs N sequential scan steps
        return preintegrate_tree_jit(g, a, d, m, jnp.asarray(bg, jnp.float32),
                                     jnp.asarray(ba, jnp.float32), calib)
