"""Solver tests on synthetic graphs with known optima (SURVEY.md §7 stage 5)."""

import numpy as np
import jax
import jax.numpy as jnp

from monoorbslam3_tpu.backend import residuals as res
from monoorbslam3_tpu.backend.residuals import KfState, PreintEdge
from monoorbslam3_tpu.backend import solver as sol
from monoorbslam3_tpu.backend.solver import BAProblem, schur_ba
from monoorbslam3_tpu.models.camera import Pinhole
from monoorbslam3_tpu.models.imu import ImuCalib, preintegrate
from monoorbslam3_tpu.sim import Trajectory
from monoorbslam3_tpu.utils import lie

RNG = np.random.default_rng(21)
CAM = Pinhole.create(fx=450.0, fy=450.0, cx=376.0, cy=240.0, width=752, height=480)
R_CB = jnp.eye(3)
T_CB = jnp.zeros(3)
# body == camera for these tests: R_cb = I, t_cb = 0


def _random_pose(scale_rot=0.3, scale_t=1.0):
    R = np.asarray(lie.exp_so3(jnp.asarray(RNG.normal(size=3) * scale_rot, jnp.float32)))
    t = RNG.normal(size=3) * scale_t
    return R.astype(np.float32), t.astype(np.float32)


def _make_states(R_wb, t_wb, v=None, bg=None, ba=None):
    n = len(R_wb)
    z = np.zeros((n, 3), np.float32)
    return KfState(
        jnp.asarray(np.stack(R_wb)), jnp.asarray(np.stack(t_wb)),
        jnp.asarray(v if v is not None else z),
        jnp.asarray(bg if bg is not None else z),
        jnp.asarray(ba if ba is not None else z),
    )


def _build_ba_problem(n_kf=6, n_pts=200, noise=0.3, perturb=True):
    """Cameras on an arc looking at a point cloud; first two KFs fixed."""
    pts = np.stack(
        [RNG.uniform(-4, 4, n_pts), RNG.uniform(-3, 3, n_pts), RNG.uniform(6, 14, n_pts)],
        axis=-1,
    ).astype(np.float32)
    R_list, t_list = [], []
    for k in range(n_kf):
        w = np.array([0.0, 0.04 * k, 0.0], np.float32)
        R = np.asarray(lie.exp_so3(jnp.asarray(w)))
        t = np.array([0.4 * k, 0.02 * k, 0.0], np.float32)
        R_list.append(R)
        t_list.append(t)
    kf_gt = _make_states(R_list, t_list)

    obs_kf, obs_pt, obs_uv = [], [], []
    for k in range(n_kf):
        s = jax.tree_util.tree_map(lambda a: a[k], kf_gt)
        uv = np.asarray(res.reprojection_residual(s, pts, np.zeros((n_pts, 2), np.float32), CAM, R_CB, T_CB))
        vis = np.asarray(CAM.is_in_image(jnp.asarray(uv)))
        for p in np.nonzero(vis)[0]:
            obs_kf.append(k)
            obs_pt.append(p)
            obs_uv.append(uv[p] + RNG.normal(scale=noise, size=2))
    O = len(obs_kf)

    kf0 = kf_gt
    pts0 = pts.copy()
    if perturb:
        dR = lie.exp_so3(jnp.asarray(RNG.normal(size=(n_kf, 3)) * 0.01, jnp.float32))
        R_p = np.array(kf_gt.R_wb @ dR)
        t_p = np.asarray(kf_gt.t_wb) + RNG.normal(size=(n_kf, 3)).astype(np.float32) * 0.05
        R_p[:2] = np.asarray(kf_gt.R_wb)[:2]
        t_p[:2] = np.asarray(kf_gt.t_wb)[:2]
        kf0 = _make_states(list(R_p), list(t_p))
        pts0 = pts + RNG.normal(size=pts.shape).astype(np.float32) * 0.1

    dof = np.zeros((n_kf, 15), np.float32)
    dof[2:, :6] = 1.0  # first two fixed; visual-only: pose dims only

    E = 1  # dummy inertial edge slot (disabled)
    edge = PreintEdge(
        dR=jnp.eye(3)[None], dV=jnp.zeros((E, 3)), dP=jnp.zeros((E, 3)),
        JRg=jnp.zeros((E, 3, 3)), JVg=jnp.zeros((E, 3, 3)), JVa=jnp.zeros((E, 3, 3)),
        JPg=jnp.zeros((E, 3, 3)), JPa=jnp.zeros((E, 3, 3)),
        bg0=jnp.zeros((E, 3)), ba0=jnp.zeros((E, 3)), dt=jnp.ones(E),
        L_inv=jnp.eye(9)[None],
    )
    problem = BAProblem(
        kf=kf0,
        kf_dof=jnp.asarray(dof),
        points=jnp.asarray(pts0),
        pt_active=jnp.ones(n_pts, bool),
        obs_kf=jnp.asarray(obs_kf, jnp.int32),
        obs_pt=jnp.asarray(obs_pt, jnp.int32),
        obs_uv=jnp.asarray(np.array(obs_uv), jnp.float32),
        obs_inv_sigma2=jnp.ones(O, jnp.float32),
        obs_valid=jnp.ones(O, bool),
        ie_i=jnp.zeros(E, jnp.int32),
        ie_j=jnp.zeros(E, jnp.int32),
        ie_edge=edge,
        ie_valid=jnp.zeros(E, bool),
        walk_inv_sigma=jnp.zeros((E, 6)),
        walk_valid=jnp.zeros(E, bool),
        prior_inv_sigma=jnp.zeros((n_kf, 15)),
        prior_ref=kf0,
    )
    return problem, kf_gt, pts


def test_schur_ba_visual_converges():
    problem, kf_gt, pts_gt = _build_ba_problem()
    kf, pts, info = schur_ba(problem, CAM, R_CB, T_CB, n_iters=10)
    assert float(info["cost"]) < float(info["cost0"]) * 0.5
    # pose error vs ground truth (gauge fixed by the two anchored KFs)
    for k in range(2, 6):
        dR = np.asarray(kf.R_wb[k]).T @ np.asarray(kf_gt.R_wb[k])
        ang = np.degrees(np.linalg.norm(np.asarray(lie.log_so3(jnp.asarray(dR)))))
        assert ang < 0.2, f"kf{k} rotation error {ang}"
        terr = np.linalg.norm(np.asarray(kf.t_wb[k]) - np.asarray(kf_gt.t_wb[k]))
        assert terr < 0.03, f"kf{k} translation error {terr}"
    # mean point error small
    perr = np.linalg.norm(np.asarray(pts) - pts_gt, axis=1)
    assert np.median(perr) < 0.05, f"median point error {np.median(perr)}"


def test_schur_ba_visual_inertial_converges():
    """VI-BA on the analytic trajectory: poses+velocities+biases recover."""
    traj = Trajectory()
    calib = ImuCalib.create(
        R_bc=np.eye(3), t_bc=np.zeros(3),
        noise_gyro=1.7e-4, noise_acc=2e-3, walk_gyro=2e-5, walk_acc=3e-3,
    )
    n_kf = 6
    times = 2.0 + 0.4 * np.arange(n_kf)
    bg_true = np.array([0.002, -0.001, 0.003], np.float32)
    ba_true = np.array([0.02, -0.01, 0.015], np.float32)

    R_list = [traj.R_wb(t).astype(np.float32) for t in times]
    t_list = [traj.pos(t).astype(np.float32) for t in times]
    v_arr = np.stack([traj.vel(t) for t in times]).astype(np.float32)
    kf_gt = _make_states(R_list, t_list, v=v_arr,
                         bg=np.tile(bg_true, (n_kf, 1)), ba=np.tile(ba_true, (n_kf, 1)))

    # landmarks + observations: with R_cb = I the camera looks along world +z,
    # so put the landmark field overhead
    pts = np.stack(
        [RNG.uniform(-8, 8, 300), RNG.uniform(-8, 8, 300), RNG.uniform(5, 14, 300)],
        axis=-1,
    ).astype(np.float32)
    obs_kf, obs_pt, obs_uv = [], [], []
    for k in range(n_kf):
        s = jax.tree_util.tree_map(lambda a: a[k], kf_gt)
        pc_depth = np.asarray(res.point_depth(s, pts, R_CB, T_CB))
        uv = np.asarray(res.reprojection_residual(s, pts, np.zeros((300, 2), np.float32), CAM, R_CB, T_CB))
        vis = np.asarray(CAM.is_in_image(jnp.asarray(uv))) & (pc_depth > 0.5)
        for p in np.nonzero(vis)[0]:
            obs_kf.append(k)
            obs_pt.append(p)
            obs_uv.append(uv[p] + RNG.normal(scale=0.3, size=2))
    O = len(obs_kf)
    assert O > 300, f"too few observations ({O}) — sim geometry broken"

    # preintegrated edges at the true bias linearization = zero-bias estimate
    edges = []
    for k in range(n_kf - 1):
        g, a, d = traj.imu_samples(times[k], times[k + 1], 200.0, bg=bg_true, ba=ba_true)
        pre = preintegrate(g, a, d, np.ones(len(d), np.float32),
                           jnp.zeros(3), jnp.zeros(3), calib)
        edges.append(PreintEdge.from_preintegrated(pre))
    edge = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *edges)
    E = n_kf - 1

    # perturb: all but first KF
    dR = lie.exp_so3(jnp.asarray(RNG.normal(size=(n_kf, 3)) * 0.01, jnp.float32))
    R_p = np.array(kf_gt.R_wb @ dR)
    t_p = np.asarray(kf_gt.t_wb) + RNG.normal(size=(n_kf, 3)).astype(np.float32) * 0.05
    v_p = v_arr + RNG.normal(size=(n_kf, 3)).astype(np.float32) * 0.1
    R_p[0] = np.asarray(kf_gt.R_wb[0])
    t_p[0] = np.asarray(kf_gt.t_wb[0])
    kf0 = _make_states(list(R_p), list(t_p), v=v_p)  # biases start at zero

    dof = np.ones((n_kf, 15), np.float32)
    dof[0, :6] = 0.0  # anchor first pose

    walk_sigma = np.concatenate([
        np.full(3, 2e-5 * np.sqrt(200 * 0.4)), np.full(3, 3e-3 * np.sqrt(200 * 0.4))
    ])
    problem = BAProblem(
        kf=kf0,
        kf_dof=jnp.asarray(dof),
        points=jnp.asarray(pts + RNG.normal(size=pts.shape).astype(np.float32) * 0.05),
        pt_active=jnp.ones(300, bool),
        obs_kf=jnp.asarray(obs_kf, jnp.int32),
        obs_pt=jnp.asarray(obs_pt, jnp.int32),
        obs_uv=jnp.asarray(np.array(obs_uv), jnp.float32),
        obs_inv_sigma2=jnp.ones(O, jnp.float32),
        obs_valid=jnp.ones(O, bool),
        ie_i=jnp.arange(E, dtype=jnp.int32),
        ie_j=jnp.arange(1, E + 1, dtype=jnp.int32),
        ie_edge=edge,
        ie_valid=jnp.ones(E, bool),
        walk_inv_sigma=jnp.asarray(np.tile(1.0 / walk_sigma, (E, 1)), jnp.float32),
        walk_valid=jnp.ones(E, bool),
        prior_inv_sigma=jnp.zeros((n_kf, 15)),
        prior_ref=kf0,
    )
    kf, pts_out, info = schur_ba(problem, CAM, R_CB, T_CB, n_iters=15)
    assert float(info["cost"]) < float(info["cost0"])
    # velocities recovered
    verr = np.linalg.norm(np.asarray(kf.v) - v_arr, axis=1)
    assert verr.max() < 0.1, f"velocity errors {verr}"
    # gyro bias recovered (acc bias is weakly observable over short windows)
    bg_est = np.asarray(kf.bg).mean(axis=0)
    np.testing.assert_allclose(bg_est, bg_true, atol=2e-3)
    # poses track ground truth
    for k in range(1, n_kf):
        terr = np.linalg.norm(np.asarray(kf.t_wb[k]) - np.asarray(kf_gt.t_wb[k]))
        assert terr < 0.1, f"kf{k} translation error {terr}"


def test_analytic_vis_jacobians_match_jacfwd():
    """The hand-derived reprojection Jacobians in _vis_linearize must match
    autodiff through the retraction."""
    import jax
    from monoorbslam3_tpu.backend import solver as S

    problem, _, _ = _build_ba_problem(n_kf=4, n_pts=64, perturb=True)
    r0, Jc, Jl, w, chi2, cost = S._vis_linearize(problem, CAM, R_CB, T_CB, 5.991)

    s_o = S._gather_kf(problem.kf, problem.obs_kf)
    p_o = problem.points[problem.obs_pt]

    def r_fn(dxc, dxl, s, p, uv):
        return res.reprojection_residual(
            res.retract_kf(s, dxc), p + dxl, uv, CAM, R_CB, T_CB)

    z15 = jnp.zeros(15, jnp.float32)
    z3 = jnp.zeros(3, jnp.float32)

    def per_obs(s, p, uv):
        return jax.jacfwd(r_fn, argnums=(0, 1))(z15, z3, s, p, uv)

    Jc_ref, Jl_ref = jax.vmap(per_obs)(s_o, p_o, problem.obs_uv)
    # Jc is the compact pose block [O, 2, 6]; the remaining 9 tangent dims
    # (v, bg, ba) must have exactly zero reprojection Jacobian
    np.testing.assert_allclose(np.asarray(Jc), np.asarray(Jc_ref[:, :, :6]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(Jc_ref[:, :, 6:]), 0.0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(Jl), np.asarray(Jl_ref),
                               rtol=1e-4, atol=1e-4)


def test_analytic_inertial_jacobians_match_jacfwd():
    """The hand-derived whitened preintegration-edge Jacobians in
    _inertial_linearize must match autodiff through the retraction."""
    import jax
    from monoorbslam3_tpu.backend import solver as S

    problem, _, _ = _build_ba_problem(n_kf=5, n_pts=32, perturb=True)
    r0, J1, J2, w, cost = S._inertial_linearize(problem)

    s1 = S._gather_kf(problem.kf, problem.ie_i)
    s2 = S._gather_kf(problem.kf, problem.ie_j)

    def r_fn(dx1, dx2, a, b, e):
        return res.inertial_residual(
            res.retract_kf(a, dx1), res.retract_kf(b, dx2), e)

    z = jnp.zeros(15, jnp.float32)

    def per_edge(a, b, e):
        r = r_fn(z, z, a, b, e)
        Ja, Jb = jax.jacfwd(r_fn, argnums=(0, 1))(z, z, a, b, e)
        return r, Ja, Jb

    r_ref, J1_ref, J2_ref = jax.vmap(per_edge)(s1, s2, problem.ie_edge)
    np.testing.assert_allclose(np.asarray(r0), np.asarray(r_ref),
                               rtol=1e-4, atol=1e-4)
    scale = np.abs(np.asarray(J1_ref)).max()
    np.testing.assert_allclose(np.asarray(J1), np.asarray(J1_ref),
                               rtol=1e-3, atol=1e-4 * scale)
    np.testing.assert_allclose(np.asarray(J2), np.asarray(J2_ref),
                               rtol=1e-3, atol=1e-4 * scale)


def test_inv_spd_blocks15_matches_linalg():
    """Recursive block-Schur inverse of the reduced camera system (an
    alternative to the Cholesky solve) vs jnp.linalg.solve, on an LM-damped
    Jacobi-normalized SPD matrix with K=9 (non-power-of-two) blocks."""
    rng = np.random.default_rng(7)
    K = 9
    n = 15 * K
    A = rng.normal(size=(2, n, n)).astype(np.float32) / np.sqrt(n)
    H = A @ A.transpose(0, 2, 1) + 0.05 * np.eye(n, dtype=np.float32)
    d = np.sqrt(np.abs(np.diagonal(H, axis1=-2, axis2=-1)))
    Hn = H / d[:, :, None] / d[:, None, :]
    g = rng.normal(size=(2, n)).astype(np.float32)
    x_ref = np.linalg.solve(Hn.astype(np.float64), g.astype(np.float64)[..., None]).squeeze(-1)
    Hi = np.asarray(sol.inv_spd_blocks15(jnp.asarray(Hn), K))
    x = (Hi @ g[..., None]).squeeze(-1)
    scale = np.abs(x_ref).max()
    assert np.allclose(x, x_ref, rtol=5e-3, atol=1e-3 * scale), \
        np.abs(x - x_ref).max() / scale


def test_inv_spd15_matches_linalg():
    """Closed-form nested-Schur 15x15 SPD solve vs jnp.linalg.solve on
    LM-style damped normal matrices (incl. rank-deficient visual-only
    shape: zero rows/cols on dims 6:15 except damping)."""
    rng = np.random.default_rng(3)
    # well-conditioned SPD batch
    A = rng.normal(size=(4, 15, 15)).astype(np.float32)
    H = A @ A.transpose(0, 2, 1) + 15 * np.eye(15, dtype=np.float32)
    g = rng.normal(size=(4, 15)).astype(np.float32)
    x_ref = np.linalg.solve(H, g[..., None]).squeeze(-1)
    x = np.asarray(sol.solve_spd15_jacobi(jnp.asarray(H), jnp.asarray(g)))
    assert np.allclose(x, x_ref, rtol=2e-3, atol=2e-4), np.abs(x - x_ref).max()

    # visual-only shape: dims 6:15 only have tiny damping, g zero there
    B = rng.normal(size=(4, 6, 6)).astype(np.float32)
    H2 = np.zeros((4, 15, 15), np.float32)
    H2[:, :6, :6] = B @ B.transpose(0, 2, 1) + 6 * np.eye(6, dtype=np.float32)
    H2[:, range(6, 15), range(6, 15)] = 1e-8
    g2 = np.zeros((4, 15), np.float32)
    g2[:, :6] = rng.normal(size=(4, 6)).astype(np.float32)
    x2_ref = np.linalg.solve(H2.astype(np.float64), g2.astype(np.float64)[..., None]).squeeze(-1)
    x2 = np.asarray(sol.solve_spd15_jacobi(jnp.asarray(H2), jnp.asarray(g2)))
    assert np.allclose(x2[:, :6], x2_ref[:, :6], rtol=2e-3, atol=2e-4)
    assert np.allclose(x2[:, 6:], 0.0, atol=1e-5)


def test_batch_edges_traces_once_across_edge_counts():
    """The edge-batching path must NOT retrace per keyframe count: a new
    XLA compile mid-run stalls the stream (see problems.py _batch_edges). All edge counts within one 16-bucket must
    reuse the same traced preintegration + whitening."""
    from monoorbslam3_tpu.backend.problems import Problems
    from monoorbslam3_tpu.models.imu import ImuBuffer

    calib = ImuCalib.create(
        R_bc=np.eye(3, dtype=np.float32), t_bc=np.zeros(3, np.float32),
        noise_gyro=1.7e-4, noise_acc=2e-3, walk_gyro=1e-5, walk_acc=3e-3,
        freq=200.0)
    problems = Problems(CAM, calib, local_k=8, local_p=64, local_o=128,
                        imu_cap=64)

    class StubStore:
        def __init__(self, n):
            self.kf_imu = {}
            self.kf_bg = np.zeros((n, 3), np.float32)
            self.kf_ba = np.zeros((n, 3), np.float32)
            for k in range(n):
                buf = ImuBuffer(capacity=64)
                for _ in range(10):
                    buf.add(RNG.normal(0, 0.01, 3), [0, 0, 9.8], 0.005)
                self.kf_imu[k] = buf

    sizes = []
    for n in (4, 6, 11, 14):  # edge counts 3, 5, 10, 13 -> one 16-bucket
        edge = problems._batch_edges(StubStore(n), list(range(n)))
        assert isinstance(edge.dR, np.ndarray), "edges must be host arrays"
        assert edge.dR.shape[0] == 16, "expected the 16-bucket capacity"
        sizes.append((problems._preint_batch._cache_size(),
                      problems._whiten_batch._cache_size()))
    # No growth across edge counts. (Absolute counts are not asserted:
    # jax.jit wrappers of the same underlying function share the global
    # pjit cache, so earlier tests' System instances may pre-seed entries.)
    assert sizes[-1] == sizes[0], f"retraced: {sizes}"


def test_inertial_init_recovers_scale_under_visual_noise():
    """The host f64 inertial init must recover a large monocular scale,
    gravity direction, and the gyro bias even when the visual KF positions
    carry realistic (mm-level metric) noise. The pure-IMU whitening regime
    treats that noise as hundreds of sigma, where an f32 on-device LM
    measurably converged to a 2-3x-wrong scale (the 2026-08 wide-FOV
    fisheye e2e failure); the linear-alignment seed + empirical whitening
    floor must hold the true optimum (inertialOptimize, Optimize.cpp:93-205)."""
    from monoorbslam3_tpu.backend.problems import Problems
    from monoorbslam3_tpu.models.imu import ImuBuffer

    s_true = 4.0
    bg_true = np.array([0.004, -0.003, 0.002], np.float32)
    ba_true = np.array([0.02, -0.01, 0.03], np.float32)
    calib = ImuCalib.create(
        R_bc=np.eye(3, dtype=np.float32), t_bc=np.zeros(3, np.float32),
        noise_gyro=1.7e-4, noise_acc=2e-3, walk_gyro=2e-5, walk_acc=3e-3,
        freq=200.0)
    traj = Trajectory()
    # visual frame: a fixed rotation of the world, scaled down by s_true
    R_vw = np.asarray(lie.exp_so3(jnp.asarray([0.3, -0.2, 0.5], jnp.float32)))
    rng = np.random.default_rng(3)
    times = np.arange(0.0, 3.01, 0.25)
    K = len(times)

    class Store:
        pass

    st = Store()
    st.kf_imu = {}
    st.kf_time = times
    st.kf_bg = np.zeros((K, 3), np.float32)
    st.kf_ba = np.zeros((K, 3), np.float32)
    st.kf_v = {}
    R_list, t_list = [], []
    for i, t in enumerate(times):
        R_list.append((R_vw @ traj.R_wb(t)).astype(np.float32))
        noise = rng.normal(scale=2e-4, size=3)  # visual units ~ 0.8 mm metric
        t_list.append(((R_vw @ traj.pos(t)) / s_true + noise).astype(np.float32))
        if i < K - 1:
            g, a, d = traj.imu_samples(t, times[i + 1], 200.0, bg=bg_true,
                                       ba=ba_true, noise_gyro=1.7e-4,
                                       noise_acc=2e-3, rng=rng)
            buf = ImuBuffer(capacity=64)
            for j in range(len(g)):
                buf.add(g[j], a[j], d[j])
            st.kf_imu[i] = buf
    ids = list(range(K))
    st.keyframe_ids = lambda: ids
    st.keyframe_states = lambda ii: (
        np.stack([R_list[k] for k in ii]), np.stack([t_list[k] for k in ii]),
        np.zeros((len(ii), 3), np.float32), None, None)

    pr = Problems(CAM, calib, local_k=16, local_p=64, local_o=128, imu_cap=64)
    out = pr.inertial_optimize(st, prior_g=1e6, prior_a=1e12)
    assert out is not None
    assert abs(out["scale"] - s_true) / s_true < 0.15, out["scale"]
    g_est = out["R_wg"] @ np.array([0.0, 0.0, -1.0])
    g_want = R_vw @ np.array([0.0, 0.0, -1.0])
    ang = np.degrees(np.arccos(np.clip(g_est @ g_want, -1, 1)))
    assert ang < 3.0, f"gravity direction off by {ang:.2f} deg"
    assert np.linalg.norm(out["bg"] - bg_true) < 2e-3, out["bg"]


def test_schur_ba_grouped_obs_matches_flat():
    """The grouped per-KF block observation layout (the one the large
    full-inertial polish uses) solves the same problem as the flat one."""
    problem, kf_gt, pts_gt = _build_ba_problem()
    n_kf = problem.kf_dof.shape[0]
    obs_kf = np.asarray(problem.obs_kf)
    counts = np.bincount(obs_kf, minlength=n_kf)
    opk = int(-(-counts.max() // 8) * 8)
    O2 = n_kf * opk
    sel = np.concatenate([np.nonzero(obs_kf == k)[0] for k in range(n_kf)])
    dst = np.concatenate([k * opk + np.arange(counts[k]) for k in range(n_kf)])
    o_pt = np.zeros(O2, np.int32)
    o_uv = np.zeros((O2, 2), np.float32)
    o_is2 = np.ones(O2, np.float32)
    o_val = np.zeros(O2, bool)
    o_pt[dst] = np.asarray(problem.obs_pt)[sel]
    o_uv[dst] = np.asarray(problem.obs_uv)[sel]
    o_is2[dst] = np.asarray(problem.obs_inv_sigma2)[sel]
    o_val[dst] = np.asarray(problem.obs_valid)[sel]
    grouped = problem._replace(
        obs_kf=jnp.asarray(np.repeat(np.arange(n_kf, dtype=np.int32), opk)),
        obs_pt=jnp.asarray(o_pt), obs_uv=jnp.asarray(o_uv),
        obs_inv_sigma2=jnp.asarray(o_is2), obs_valid=jnp.asarray(o_val))

    kf_f, pts_f, info_f = schur_ba(problem, CAM, R_CB, T_CB, n_iters=10)
    kf_g, pts_g, info_g = schur_ba(grouped, CAM, R_CB, T_CB, n_iters=10)
    assert abs(float(info_f["cost"]) - float(info_g["cost"])) < 1e-2 * max(
        1.0, float(info_f["cost"]))
    np.testing.assert_allclose(np.asarray(kf_g.t_wb), np.asarray(kf_f.t_wb),
                               atol=2e-3)
    np.testing.assert_allclose(np.asarray(kf_g.R_wb), np.asarray(kf_f.R_wb),
                               atol=2e-4)
    perr = np.linalg.norm(np.asarray(pts_g) - np.asarray(pts_f), axis=1)
    assert np.median(perr) < 5e-3


def test_visual_block_sums_match_float64():
    """The BA assembly's segment sums over unordered observation indices
    (with repeats and zero-weight rows) against float64 numpy. f32
    accumulation of a few hundred exact summands: relative error ~1e-7,
    asserted at 1e-5."""
    from chip_smoke import block_sums_float64
    from monoorbslam3_tpu.backend.solver import visual_block_sums

    rng = np.random.default_rng(5)
    K, P, O = 7, 50, 900
    J = rng.normal(size=(O, 2, 10)).astype(np.float32)
    w = (rng.random(O) > 0.2).astype(np.float32)  # w = 0: invalid rows
    B = np.einsum("oik,oil->okl", J * w[:, None, None], J)
    obs_kf = rng.integers(0, K, O).astype(np.int32)
    obs_pt = rng.integers(0, P, O).astype(np.int32)
    got = jax.jit(visual_block_sums, static_argnums=(3, 4))(
        jnp.asarray(B), jnp.asarray(obs_kf), jnp.asarray(obs_pt), K, P)
    want = block_sums_float64(B, obs_kf, obs_pt, K, P)
    for g, r in zip(got, want):
        assert g.shape == r.shape
        err = np.abs(np.asarray(g, np.float64) - r).max() / np.abs(r).max()
        assert err < 1e-5, err
