"""The solver entry points — Analog of the reference `Optimize`
static API (modules/Backend/Optimize.h:24-43, Optimize.cpp).

Mapping to the reference's 10 problems:

- pose_optimize            <- Optimize::poseOptimize (Optimize.cpp:444-545)
- pose_full_optimize       <- Optimize::poseFullOptimize (.cpp:610-764) /
                              poseInertialOptimize (.cpp:547-608) via flags
- initial_optimize         <- Optimize::initialOptimize (.cpp:17-91)
- local_bundle_adjustment  <- Optimize::localBundleAdjustment (.cpp:766-951)
- local_full_bundle_adjustment <- localFullBundleAdjustment (.cpp:1064-1310)
- local_inertial_bundle_adjustment <- localInertialBundleAdjustment (.cpp:953-1062)
- inertial_optimize        <- Optimize::inertialOptimize (.cpp:93-205)
- gravity_optimize         <- Optimize::gravityOptimize (.cpp:207-237)
- full_inertial_optimize   <- Optimize::fullInertialOptimize (.cpp:239-442)

Each is a host-facing function over the MapStore + frame data; the math runs
in fixed-capacity jitted programs (schur_ba). Problem windows
that exceed a capacity are subsampled host-side, never recompiled.
"""

from __future__ import annotations

import logging
from contextlib import nullcontext
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

log = logging.getLogger("monoorbslam3_tpu.backend")

from ..models.imu import ImuCalib, preintegrate
from ..utils import lie
from ..utils.fetch import fetch
from ..utils.precision import f32_matmuls
from . import residuals as res
from . import solver
from .residuals import KfState, PreintEdge
from .solver import BAProblem, schur_ba

CHI2_MONO = 5.991
# Frame-level association gate. The reference drops frame matches at the
# same 5.991 as BA (Optimize.cpp:498-524); with noise-limited map-point
# depth uncertainty projecting into NEW viewpoints, that hard gate sheds
# correct associations faster than the mapper can repair them (see
# STATUS.md forensic notes). Huber IRLS already downweights marginal
# residuals, so a looser drop threshold is safe and keeps the association
# set alive while BA absorbs the new viewpoint.
CHI2_FRAME_DROP = 16.0


# ---------------------------------------------------------------------------
# Frame pose optimization (tracking thread hot path)
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("n_rounds", "n_iters", "use_inertial", "use_prior"))
@f32_matmuls
def _pose_optimize_impl(
    state0: KfState,
    pts, uv, inv_sigma2, valid,
    camera, R_cb, t_cb,
    edge: PreintEdge, last_state: KfState, edge_valid,
    prior_ref: KfState, prior_inv_sigma,
    n_rounds: int = 2, n_iters: int = 10,
    use_inertial: bool = False, use_prior: bool = False,
):
    """Shared frame-optimize core: visual (+ inertial-to-last-KF) LM with
    per-round chi2 inlier re-classification (the reference's 4x10 loop with
    chi2 5.991, Optimize.cpp:498-524)."""

    visual_only = not (use_inertial or use_prior)
    DIM = 6 if visual_only else 15

    def chi2_of(s):
        r = res.reprojection_residual(s, pts, uv, camera, R_cb, t_cb)
        depth_ok = res.point_depth(s, pts, R_cb, t_cb) > 0.05
        return jnp.sum(r * r, axis=-1) * inv_sigma2, depth_ok

    def vis_linearize_b(s: KfState, w_vis):
        """Batched-over-candidates visual linearize: residual, compact
        6-col pose Jacobian, IRLS weight, robust cost (same closed form as
        solver._vis_linearize, one pose per candidate row)."""
        p_b = jnp.einsum("cnj,cji->cni", pts[None] - s.t_wb[:, None], s.R_wb)
        p_c = jnp.einsum("cni,ji->cnj", p_b, R_cb) + t_cb
        r = camera.project(p_c) - uv[None]  # [C, N, 2]
        Jp = camera.proj_jacobian(p_c)  # [C, N, 2, 3]
        JpR = jnp.einsum("cnij,jk->cnik", Jp, R_cb)
        Jc = jnp.concatenate([
            jnp.einsum("cnij,cnjk->cnik", JpR, lie.hat(p_b)),
            -JpR,
        ], axis=-1)  # [C, N, 2, 6]
        chi2 = jnp.sum(r * r, axis=-1) * inv_sigma2  # [C, N]
        w = w_vis[None] * res.huber_weight(chi2, CHI2_MONO)
        cost = jnp.sum(
            jnp.where(w_vis[None] > 0, res.huber_cost(chi2, CHI2_MONO), 0.0),
            axis=-1)  # [C]
        return r, Jc, w, cost

    def tail_linearize(s: KfState):
        """Inertial-to-last-KF + prior residuals and their Jacobians wrt a
        fresh tangent at s (small: jacfwd over <= 18 rows)."""
        def tail_fn(dx):
            sd = res.retract_kf(s, dx)
            parts = []
            if use_inertial:
                parts.append(res.inertial_residual(last_state, sd, edge)
                             * edge_valid)
            if use_prior:
                x = jnp.concatenate([sd.v, sd.bg, sd.ba])
                x0 = jnp.concatenate([prior_ref.v, prior_ref.bg, prior_ref.ba])
                parts.append((x - x0) * prior_inv_sigma)
            return jnp.concatenate(parts) if parts else jnp.zeros(0, jnp.float32)

        z = jnp.zeros(15, jnp.float32)
        r = tail_fn(z)
        J = jax.jacfwd(tail_fn)(z) if (use_inertial or use_prior) else \
            jnp.zeros((0, 15), jnp.float32)
        return r, J

    # Deferred-accept parallel-lambda LM (the schur_ba pattern applied to
    # the frame chain): the carry holds C candidate states — the incumbent
    # plus the previous step's trial steps at 4 dampings. ONE batched
    # linearize pass per iteration both costs every candidate (so there is
    # no separate robust_cost pass) and yields H, g at the winner (selected
    # from the batched block products). The sequential chain's per-op
    # latency, not FLOPs, bounds the frame rate, so batching candidates
    # into the same ops costs little.
    LAMBDA_FACTORS = jnp.array([0.03, 1.0, 30.0, 900.0], jnp.float32)
    C = 1 + LAMBDA_FACTORS.shape[0]

    def run_round(state, inlier, lm_steps):
        w_vis = inlier.astype(jnp.float32) * inv_sigma2

        def lm_body(carry, _):
            cands, lam = carry
            r, Jc, w, cost_v = vis_linearize_b(cands, w_vis)
            if visual_only:
                cost = cost_v
            else:
                r_t, J_t = jax.vmap(tail_linearize)(cands)
                cost = cost_v + jnp.sum(r_t * r_t, axis=-1)
            i = jnp.argmin(cost)  # incumbent is candidate 0: monotone
            s = jax.tree_util.tree_map(lambda a: a[i], cands)
            JcW = Jc * w[:, :, None, None]
            H4 = jnp.einsum("cnik,cnil->ckl", JcW, Jc)  # [C, 6, 6]
            g4 = jnp.einsum("cnik,cni->ck", JcW, r)
            H6, g6 = H4[i], g4[i]
            if visual_only:
                H, g = H6, g6
            else:
                H = jnp.zeros((15, 15), jnp.float32).at[:6, :6].set(H6)
                g = jnp.zeros(15, jnp.float32).at[:6].set(g6)
                Jt_i = jax.tree_util.tree_map(lambda a: a[i], J_t)
                rt_i = r_t[i]
                H = H + Jt_i.T @ Jt_i
                g = g + Jt_i.T @ rt_i
            lam = jnp.where(i == 0, jnp.minimum(lam * 100.0, 1e5),
                            jnp.clip(lam * LAMBDA_FACTORS[jnp.maximum(i - 1, 0)]
                                     * 0.5, 1e-7, 1e5))
            D = jnp.diag(jnp.maximum(jnp.diag(H), 1e-8))
            lams = lam * LAMBDA_FACTORS
            Hs = H[None] + lams[:, None, None] * D[None]
            # closed-form nested-Schur SPD solve: all matmul/elementwise,
            # no serialized LU in the latency-critical frame LM chain
            if visual_only:
                d6 = jnp.sqrt(jnp.maximum(jnp.abs(jnp.diagonal(
                    Hs, axis1=-2, axis2=-1)), 1e-12))
                Hn = Hs / (d6[..., :, None] * d6[..., None, :])
                steps = -(solver.inv_spd6(Hn) @ (g / d6)[..., None]
                          ).squeeze(-1) / d6
                steps15 = jnp.pad(steps, ((0, 0), (0, 9)))
            else:
                steps15 = -solver.solve_spd15_jacobi(
                    Hs, jnp.broadcast_to(g, (lams.shape[0], 15)))
            trials = jax.vmap(lambda d: res.retract_kf(s, d))(steps15)
            cands = jax.tree_util.tree_map(
                lambda a, b: jnp.concatenate([a[None], b]),
                s, trials)
            return (cands, lam), None

        cands0 = jax.tree_util.tree_map(
            lambda a: jnp.broadcast_to(a[None], (C, *a.shape)), state)
        (cands, _), _ = jax.lax.scan(
            lm_body, (cands0, jnp.float32(1e-3)), None, length=lm_steps)
        # the incumbent (candidate 0) is the best costed state; the final
        # step's trials were never costed and are discarded
        new_state = jax.tree_util.tree_map(lambda a: a[0], cands)
        chi2, depth_ok = chi2_of(new_state)
        new_inlier = valid & (chi2 < CHI2_FRAME_DROP) & depth_ok
        return new_state, new_inlier

    chi2, depth_ok = chi2_of(state0)
    inlier = valid & depth_ok
    state = state0
    # same total refinement as the reference's 4x10 (Optimize.cpp:498-524),
    # but each parallel-lambda step explores 4 dampings at once, so 4 rounds
    # of 4 steps suffice; +1 because the first deferred-accept step only
    # seeds the candidate bank
    lm_steps = max(3, n_iters * 2 // 5) + 1
    for _ in range(n_rounds):
        state, inlier = run_round(state, inlier, lm_steps)
    return state, inlier


class Problems:
    """Solver façade bound to a camera + IMU calibration (the role of the
    reference's `Optimize` static class + its g2o solver setup)."""

    def __init__(self, camera, calib: ImuCalib,
                 local_k: int = 32, local_p: int = 2048, local_o: int = 6144,
                 imu_cap: int = 512, mesh=None,
                 full_k: int = 96, full_p: int = 4096, full_opk: int = 192,
                 full_polish_mode: str = "hybrid",
                 window_layout: str = "flat"):
        """mesh: optional jax.sharding.Mesh. When set, every window BA
        solves through the DISTRIBUTED Schur pipeline (parallel/
        sharded_ba.py): landmarks + observations sharded by point across
        the mesh, the reduced camera system psum'd across devices. The single-
        chip schur_ba stays the default (one chip is faster than one
        chip + collectives for windows this size; the mesh path is for
        multi-chip scale-out)."""
        self.camera = camera
        self.calib = calib
        self.local_k, self.local_p, self.local_o = local_k, local_p, local_o
        # capacities of the LARGE full-inertial polish problem (grouped-obs
        # layout, see solver.schur_ba grouped_obs): full_k keyframes,
        # full_p points, full_opk observation rows per keyframe
        self.full_k, self.full_p, self.full_opk = full_k, full_p, full_opk
        # over-capacity polish mode:
        # - "hybrid" (default): best long-horizon arm. Round-5 horizon
        #   lesson: "recent" (sliding newest-full_k window) won the 60 s
        #   corridor A/B (1.39 m vs hybrid's 3.03 m) but at 120 s it
        #   LOSES the whole-chain lever — the >96-KF history is never
        #   re-polished, drift shear accumulates unrepaired, and the
        #   battery corridor120 row blew up to 21.9 m / 16% (0 losses)
        #   where hybrid scores 1.81 m / 2.3%. The long-lever subsampled
        #   polish across ALL history is load-bearing on long forward
        #   drives; 60 s worlds cannot see this (the window-layout lesson
        #   of r04, one octave up);
        # - "recent": grouped all-KF up to full_k; beyond, the same
        #   surgery-validated machinery over the newest full_k keyframes
        #   only. Short-horizon best; long-horizon UNSAFE (above);
        # - "hybrid" detail: the grouped all-KF problem while the
        #   session fits full_k keyframes (surgically validated healthy —
        #   experiments/polish_surgery.py: 3 polishes at 67 KFs improve
        #   ATE 266 -> 234 cm with the last-third gauge recovering), and
        #   the round-3 capped stride-subsample beyond full_k;
        # - "grouped": the all-KF + merged-edge + correction-propagation
        #   path at EVERY size. KNOWN REGRESSED past full_k on forward
        #   motion: corridor60 27.8-30.3 m / ~100% scale err vs capped
        #   2.9 m (A/B record in STATUS.md r04); the defect is isolated
        #   to the >full_k machinery (stride+merge+propagation), not the
        #   grouped solve itself;
        # - "capped": round-3 behavior at every over-capacity size;
        # - "grouped_nomerge", "off": ablation arms.
        self.full_polish_mode = full_polish_mode
        # observation layout of the regular window BAs: "flat" (one shared
        # O axis, stratified subsample across the concatenation) or
        # "grouped" (K per-KF blocks of O/K rows — the faster assembly).
        # FLAT IS THE PRODUCTION DEFAULT for the sliding window: the
        # grouped per-KF cap truncates exactly the dense lap-closure
        # anchor observations the gauge depends on (battery A/B
        # 2026-08-20: circle60 169 cm / 12.2% grouped vs 10.8 cm / 0.7%
        # flat; corridor/lowtex unaffected) — the round-2 anchor-
        # truncation failure class in a new guise. The FULL POLISH keeps
        # the grouped layout (explicit grouped=True): at K=96 the flat
        # one-hot assembly is prohibitive, per-KF caps there are benign
        # (192 rows/KF over a 4096-point subsample), and the mode is
        # surgery-validated.
        self.window_layout = window_layout
        self.imu_cap = imu_cap
        self.mesh = mesh
        self._chi2_jit = None
        from ..models.imu import preintegrate_tree

        self._preint_batch = jax.jit(jax.vmap(
            lambda g, a, d, m, bg, ba: preintegrate_tree(g, a, d, m, bg, ba,
                                                         calib)
        ))
        self._whiten_batch = jax.jit(PreintEdge.from_preintegrated)

    # -- frame optimize -------------------------------------------------

    def pose_optimize(self, state0: KfState, pts, uv, inv_sigma2, valid):
        """Visual-only frame pose (poseOptimize). Returns (state, inliers)."""
        dummy_edge = _identity_edge()
        z = KfState.zeros()
        out = _pose_optimize_impl(
            state0, jnp.asarray(pts), jnp.asarray(uv), jnp.asarray(inv_sigma2),
            jnp.asarray(valid), self.camera, self.calib.R_cb, self.calib.t_cb,
            dummy_edge, z, jnp.float32(0.0), z, jnp.zeros(9, jnp.float32),
            use_inertial=False, use_prior=False,
        )
        state, inlier = fetch(out)  # one sync point for both outputs
        return KfState(*state), inlier

    def pose_full_optimize(self, state0: KfState, pts, uv, inv_sigma2, valid,
                           last_state: KfState, pre, prior_inv_sigma=None,
                           prior_ref: KfState | None = None):
        """Frame pose+velocity+bias tied to the last KF via the inertial edge
        (poseFullOptimize)."""
        edge = self._whiten_batch(pre)  # jitted: eager whitening recompiled
        use_prior = prior_inv_sigma is not None
        prior_ref = prior_ref if prior_ref is not None else state0
        pis = jnp.asarray(prior_inv_sigma, jnp.float32) if use_prior else jnp.zeros(9, jnp.float32)
        out = _pose_optimize_impl(
            state0, jnp.asarray(pts), jnp.asarray(uv), jnp.asarray(inv_sigma2),
            jnp.asarray(valid), self.camera, self.calib.R_cb, self.calib.t_cb,
            edge, last_state, jnp.float32(1.0), prior_ref, pis,
            use_inertial=True, use_prior=use_prior,
        )
        state, inlier = fetch(out)
        return KfState(*state), inlier

    # -- BA problems ----------------------------------------------------

    def _batch_edges(self, store, ordered_ids, cap: int | None = None,
                     bufs=None):
        """Preintegrate the KF->KF IMU windows for consecutive ids, batched.

        The edge-count axis is padded to `cap` (default: the next multiple
        of 16) so the jitted preintegration + whitening always trace at a
        bounded set of shapes — with a raw [E] axis every new keyframe
        count triggered an XLA recompile mid-run. Padded rows preintegrate zero samples
        (identity delta, dt 0) and are masked by callers' edge validity.
        Returns a PreintEdge with NUMPY leaves of leading size >= E, so
        callers slice/assemble on the host without tracing."""
        E = len(ordered_ids) - 1
        if E <= 0:
            return None
        cap = max(cap or 0, -(-E // 16) * 16)
        g = np.zeros((cap, self.imu_cap, 3), np.float32)
        a = np.zeros((cap, self.imu_cap, 3), np.float32)
        d = np.zeros((cap, self.imu_cap), np.float32)
        m = np.zeros((cap, self.imu_cap), np.float32)
        bg = np.zeros((cap, 3), np.float32)
        ba = np.zeros((cap, 3), np.float32)
        for e in range(E):
            k = ordered_ids[e]
            buf = bufs[e] if bufs is not None else store.kf_imu.get(k)
            if buf is None or buf.n == 0:
                continue
            if buf.n > self.imu_cap:
                # merged windows can exceed the preintegration capacity;
                # silent truncation would leave an edge covering less time
                # than its keyframe gap (see ImuBuffer.decimated)
                log.info("preintegration window %d samples > cap %d: "
                         "time-weighted decimation", buf.n, self.imu_cap)
                buf = buf.decimated(self.imu_cap)
            gg, aa, dd, mm = buf.padded(self.imu_cap)
            g[e], a[e], d[e], m[e] = gg, aa, dd, mm
            bg[e] = store.kf_bg[k]
            ba[e] = store.kf_ba[k]
        pre = self._preint_batch(g, a, d, m, bg, ba)
        edge = self._whiten_batch(pre)
        return fetch(edge)  # one blocking read for all edge leaves

    def build_window_problem(self, store, opt_ids, fixed_ids,
                             inertial=False, opt_points=True,
                             pose_dofs=True, vb_dofs=False,
                             priors=False, caps=None, grouped=False,
                             edge_bufs=None, fixed_vb_free=False):
        """Assemble a fixed-capacity BAProblem from a MapStore window.

        caps: optional (K, P, O) capacity override (default local_*).
        grouped: lay observations out as K contiguous per-KF blocks of
          O // K rows (solver.schur_ba grouped_obs layout) — subsampling
          then happens per KF instead of across the concatenation.
        edge_bufs: optional list of ImuBuffers for the consecutive pairs
          of the time-ordered window (len == n_ids - 1) — used by the
          full polish to keep a CONNECTED inertial chain across
          stride-skipped keyframes (preintegration composes exactly, the
          MergeNext primitive, Imu.cpp:157-172); the true-successor check
          is skipped because the bufs define the merged windows."""
        K, P, O = caps if caps is not None else (
            self.local_k, self.local_p, self.local_o)
        ids_all = list(opt_ids) + [k for k in fixed_ids if k not in opt_ids]
        ids = ids_all[:K]
        if len(ids_all) > K:
            log.warning("window BA: KF capacity %d reached, dropping %d "
                        "anchor keyframes", K, len(ids_all) - K)
        slot = {k: i for i, k in enumerate(ids)}
        nk = len(ids)

        R, t, v, bg, ba = store.keyframe_states(ids)
        kf = KfState(*(jnp.asarray(np.concatenate([x, _pad_kf(x, K - nk)]))
                       for x in (R, t, v, bg, ba)))

        dof = np.zeros((K, 15), np.float32)
        for i, k in enumerate(ids):
            if k in set(opt_ids):
                if pose_dofs:
                    dof[i, :6] = 1.0
                if vb_dofs:
                    dof[i, 6:15] = 1.0
            elif vb_dofs and fixed_vb_free:
                # anchor keyframes pin the GAUGE, which lives in the pose
                # dims alone; velocity/bias are not gauge freedoms, and
                # freezing them turns a badly-initialized anchor velocity
                # (the init interpolates skipped-KF velocities, and the
                # first sub-min_edge_dt KFs are poorly constrained) into
                # an immovable ~1e7 whitened inertial edge the polish
                # must bend the young chain around (measured on every
                # corridor run: kf[0]->kf[1] start cost 1.35e7). The
                # reference fixes KF0's velocity too (Optimize.cpp:265)
                # but ITS init estimates every KF velocity directly.
                dof[i, 6:15] = 1.0

        # points observed by the window
        feat_pt = store.kf_feat_pt[np.asarray(ids)]
        pids = np.unique(feat_pt[feat_pt >= 0])
        pids = pids[store.pt_valid[pids]]
        if len(pids) > P:
            # keep the best-observed points ("no silent caps": the drop is
            # logged; the reference optimizes every window point,
            # Optimize.cpp:1064-1310 — measure real-scene densities before
            # raising local_p)
            log.warning("window BA: point capacity %d reached, subsampling "
                        "%d of %d window points by observation count",
                        P, P, len(pids))
            order = np.argsort(-store.pt_n_obs[pids])
            pids = pids[order[:P]]
        np_pts = len(pids)
        pt_slot = np.full(store.max_pt, -1, np.int64)
        pt_slot[pids] = np.arange(np_pts)

        points = np.zeros((P, 3), np.float32)
        points[:np_pts] = store.pt_xyz[pids]
        pt_active = np.zeros(P, bool)
        pt_active[:np_pts] = bool(opt_points)

        # observations: all (window KF, point) pairs
        o_kf = np.zeros(O, np.int32)
        o_pt = np.zeros(O, np.int32)
        o_uv = np.zeros((O, 2), np.float32)
        o_is2 = np.ones(O, np.float32)
        o_val = np.zeros(O, bool)
        if grouped:
            # per-KF contiguous blocks of opk rows (schur_ba grouped_obs):
            # obs_kf is the implied o // opk pattern, padding rows masked
            opk = O // K
            o_kf[:] = np.repeat(np.arange(K, dtype=np.int32), opk)
            n_drop = n_tot = 0
            for i, k in enumerate(ids):
                fsel = np.nonzero(feat_pt[i] >= 0)[0]
                psel = feat_pt[i][fsel]
                keep = pt_slot[psel] >= 0
                fsel, psel = fsel[keep], psel[keep]
                n_tot += len(fsel)
                if len(fsel) > opk:
                    # stratified stride subsample WITHIN the keyframe
                    n_drop += len(fsel) - opk
                    sub = np.unique(np.round(
                        np.linspace(0, len(fsel) - 1, opk)).astype(np.int64))
                    fsel, psel = fsel[sub], psel[sub]
                sl = slice(i * opk, i * opk + len(fsel))
                o_pt[sl] = pt_slot[psel]
                o_uv[sl] = store.kf_feat_xy[k, fsel]
                o_is2[sl] = 1.0 / store.kf_feat_sigma2[k, fsel]
                o_val[sl] = True
            if n_drop:
                log.warning("window BA (grouped): per-KF obs capacity %d "
                            "reached, subsampled %d of %d observations",
                            opk, n_drop, n_tot)
            slot_idx = np.nonzero(o_val)[0]
            obs_meta = (o_kf[slot_idx].copy(), o_pt[slot_idx].copy(),
                        slot_idx)
        else:
            obs_kf, obs_pt, obs_uv, obs_is2 = [], [], [], []
            for i, k in enumerate(ids):
                fsel = np.nonzero(feat_pt[i] >= 0)[0]
                psel = feat_pt[i][fsel]
                keep = pt_slot[psel] >= 0
                fsel, psel = fsel[keep], psel[keep]
                obs_kf.append(np.full(len(fsel), i, np.int32))
                obs_pt.append(pt_slot[psel].astype(np.int32))
                obs_uv.append(store.kf_feat_xy[k, fsel])
                obs_is2.append(1.0 / store.kf_feat_sigma2[k, fsel])
            obs_kf = np.concatenate(obs_kf) if obs_kf else np.zeros(0, np.int32)
            obs_pt = np.concatenate(obs_pt) if obs_pt else np.zeros(0, np.int32)
            obs_uv = np.concatenate(obs_uv) if obs_uv else np.zeros((0, 2), np.float32)
            obs_is2 = np.concatenate(obs_is2) if obs_is2 else np.zeros(0, np.float32)
            if len(obs_kf) > O:
                # stratified stride subsample across the concatenated per-KF
                # blocks — a tail truncation would drop the FIXED ANCHORS'
                # observations first (they are assembled last), cutting the
                # window loose from the old map and letting the gauge drift
                # (measured on the 60 s circle world: 2k of 5k obs dropped,
                # all from the anchors, resets at lap closure)
                log.warning("window BA: observation capacity %d reached, "
                            "stride-subsampling %d of %d observations",
                            O, len(obs_kf) - O, len(obs_kf))
                keep = np.unique(np.round(
                    np.linspace(0, len(obs_kf) - 1, O)).astype(np.int64))
                obs_kf = obs_kf[keep]
                obs_pt = obs_pt[keep]
                obs_uv = obs_uv[keep]
                obs_is2 = obs_is2[keep]
            no = min(len(obs_kf), O)
            obs_meta = (obs_kf[:no].copy(), obs_pt[:no].copy(),
                        np.arange(no, dtype=np.int64))
            o_kf[:no] = obs_kf[:no]
            o_pt[:no] = obs_pt[:no]
            o_uv[:no] = obs_uv[:no]
            o_is2[:no] = obs_is2[:no]
            o_val[:no] = True

        # inertial edges between consecutive *optimized+fixed* ids in time order
        E = K - 1
        ie_i = np.zeros(E, np.int32)
        ie_j = np.zeros(E, np.int32)
        ie_valid = np.zeros(E, bool)
        walk_inv = np.zeros((E, 6), np.float32)
        walk_valid = np.zeros(E, bool)
        edge = fetch(_identity_edge_batch(E))
        if inertial and nk >= 2:
            ordered = sorted(ids, key=lambda k: store.kf_time[k])
            real = self._batch_edges(store, ordered, cap=E, bufs=edge_bufs)
            ne = min(len(ordered) - 1, E)
            # an inertial edge is only meaningful between a KF and its TRUE
            # successor: kf_imu[k] integrates k -> next-KF-at-creation (with
            # culling merges preserving that invariant). Covisibility-chosen
            # anchors can leave time gaps in `ordered`; those pairs get no
            # inertial edge (the reference's fixed KFs are visual-only
            # anchors too, Optimize.cpp:1095).
            order_all = store.keyframe_ids()
            succ = {order_all[i]: order_all[i + 1]
                    for i in range(len(order_all) - 1)}
            opt_set_ie = set(opt_ids)
            for e in range(ne):
                ie_i[e] = slot[ordered[e]]
                ie_j[e] = slot[ordered[e + 1]]
                if edge_bufs is not None:
                    # merged-window edges: valid whenever samples exist
                    # (the bufs already compose across skipped KFs)
                    has_imu = e < len(edge_bufs) and edge_bufs[e].n > 0
                    is_succ = True
                else:
                    has_imu = (store.kf_imu.get(ordered[e]) is not None
                               and store.kf_imu[ordered[e]].n > 0)
                    is_succ = succ.get(ordered[e]) == ordered[e + 1]
                ie_valid[e] = (has_imu and is_succ
                               # an edge between two FIXED anchors has no
                               # degrees of freedom: it adds a constant
                               # (often huge — stale anchors straddling a
                               # gauge drift measured at 1e7 whitened) to
                               # every cost and nothing to the solution;
                               # g2o likewise ignores fixed-fixed edges
                               and (ordered[e] in opt_set_ie
                                    or ordered[e + 1] in opt_set_ie))
                dtw = max(store.kf_time[ordered[e + 1]] - store.kf_time[ordered[e]], 1e-3)
                freq = self.calib.freq
                wg = np.sqrt(np.asarray(self.calib.cov_walk)[0] * freq * dtw)
                wa = np.sqrt(np.asarray(self.calib.cov_walk)[3] * freq * dtw)
                walk_inv[e, :3] = 1.0 / max(wg, 1e-9)
                walk_inv[e, 3:] = 1.0 / max(wa, 1e-9)
                walk_valid[e] = ie_valid[e]
            if ne > 0:
                # host-side splice (numpy) — an eager `.at[:ne].set` here
                # recompiled per distinct ne (profiled: 32 XLA compiles
                # mid-run on the synthetic drive)
                edge = jax.tree_util.tree_map(
                    lambda full, realv: np.concatenate(
                        [realv[:ne], full[ne:]], axis=0),
                    edge, real,
                )

        prior_inv_sigma = np.zeros((K, 15), np.float32)
        if priors:
            # the velocity/bias priori pins ONLY the OLDEST optimized KF —
            # the sliding window's border, whose preceding inertial edge
            # was cut (Optimize.cpp:1176-1191 `if (i == 0)`). Applying it
            # to every KF (the round-1 behavior) freezes all velocities at
            # their build-time values: each frame fit then propagates the
            # stale velocity forward and the estimate's direction lags the
            # true motion by a growing angle (measured on the 25 s circle
            # world: 47 -> 64 deg yaw lag, ~25 cm/s position drift).
            opt_set = set(opt_ids)
            opt_sorted = sorted((k for k in ids if k in opt_set),
                                key=lambda k: store.kf_time[k])
            if opt_sorted:
                i0 = ids.index(opt_sorted[0])
                prior_inv_sigma[i0, 6:15] = store.kf_prior_inv_sigma[opt_sorted[0]]

        problem = BAProblem(
            kf=kf,
            kf_dof=jnp.asarray(dof),
            points=jnp.asarray(points),
            pt_active=jnp.asarray(pt_active),
            obs_kf=jnp.asarray(o_kf), obs_pt=jnp.asarray(o_pt),
            obs_uv=jnp.asarray(o_uv), obs_inv_sigma2=jnp.asarray(o_is2),
            obs_valid=jnp.asarray(o_val),
            ie_i=jnp.asarray(ie_i), ie_j=jnp.asarray(ie_j),
            ie_edge=jax.tree_util.tree_map(jnp.asarray, edge),
            ie_valid=jnp.asarray(ie_valid),
            walk_inv_sigma=jnp.asarray(walk_inv), walk_valid=jnp.asarray(walk_valid),
            prior_inv_sigma=jnp.asarray(prior_inv_sigma), prior_ref=kf,
        )
        return problem, ids, pids, obs_meta

    def run_window_ba(self, store, opt_ids, fixed_ids, n_iters=8,
                      inertial=False, vb_dofs=False, priors=False,
                      opt_points=True, pose_dofs=True,
                      remove_outliers=True, lock=None,
                      caps=None, grouped=None, edge_bufs=None,
                      fixed_vb_free=False):
        """Build, solve, and write back a window BA. Returns info dict.

        `lock` (the map_update_mutex analog) is held while READING the
        store into the fixed-capacity problem and while WRITING results
        back; the device LM solve between them runs unlocked, like the
        reference's g2o solve with recovery under the mutex
        (Optimize.cpp:925,1264). Everything the solve consumes is copied
        into the problem at build time, so concurrent tracker reads see
        either the pre- or post-BA map, never a torn one."""
        lock = lock if lock is not None else nullcontext()
        if grouped is None:
            # layout default: the grouped per-KF observation blocks cap
            # each keyframe at O // K rows (requires O divisible by K);
            # the solver assembles both layouts the same way
            K_, _, O_ = caps if caps is not None else (
                self.local_k, self.local_p, self.local_o)
            grouped = (self.window_layout == "grouped" and O_ % K_ == 0)
        with lock:
            problem, ids, pids, (obs_kf_l, obs_pt_l, obs_slot) = \
                self.build_window_problem(
                    store, opt_ids, fixed_ids, inertial=inertial,
                    opt_points=opt_points, pose_dofs=pose_dofs,
                    vb_dofs=vb_dofs, priors=priors, caps=caps,
                    grouped=grouped, edge_bufs=edge_bufs,
                    fixed_vb_free=fixed_vb_free,
                )
        if self.mesh is not None:
            kf, pts, info = self._solve_sharded(problem, n_iters)
        else:
            kf, pts, info = schur_ba(problem, self.camera, self.calib.R_cb,
                                     self.calib.t_cb, n_iters=n_iters)
        # ONE blocking read for the whole solve (states + points + every
        # diagnostic): each further np.asarray below is then free.
        kf, pts, info = fetch((kf, pts, info))
        kf = KfState(*kf)
        n_ie = int(np.asarray(problem.ie_valid).sum())
        if float(info["cost0"]) > 1e6:
            # a window should never START this inconsistent — split the
            # cost so the offending residual family is visible in the log
            from .solver import (_inertial_linearize, _vis_residuals,
                                 _walk_linearize)

            _, c_vis = _vis_residuals(problem, self.camera, self.calib.R_cb,
                                      self.calib.t_cb, CHI2_MONO)
            r_ie, *_, c_ie = _inertial_linearize(problem)
            r_w, *_, c_walk = _walk_linearize(problem)
            per_edge = (np.asarray(jnp.sum(r_ie * r_ie, -1))
                        * np.asarray(problem.ie_valid, np.float32))
            per_walk = (np.asarray(jnp.sum(r_w * r_w, -1))
                        * np.asarray(problem.walk_valid, np.float32))
            e_bad = int(per_edge.argmax())
            i_s, j_s = int(problem.ie_i[e_bad]), int(problem.ie_j[e_bad])
            dof = np.asarray(problem.kf_dof)
            log.warning(
                "window BA: pathological start cost %.3g (vis %.3g, "
                "inertial %.3g, walk %.3g; %d ie edges; worst edge kf[%d]->"
                "kf[%d] ie %.3g walk %.3g dt %.2f opt=%d,%d)",
                float(info["cost0"]), float(c_vis), float(c_ie),
                float(c_walk), n_ie, ids[i_s], ids[j_s],
                float(per_edge[e_bad]), float(per_walk[e_bad]),
                float(problem.ie_edge.dt[e_bad]),
                int(dof[i_s, 0] > 0), int(dof[j_s, 0] > 0))
        with lock:
            out = self._write_back_ba(
                store, kf, pts, info, ids, pids, obs_kf_l, obs_pt_l,
                opt_ids, opt_points, vb_dofs, remove_outliers,
                obs_slot=obs_slot)
        out["n_ie"] = n_ie
        out["pids"] = pids  # solved point ids (callers propagate the rest)
        return out

    def _solve_sharded(self, problem, n_iters):
        """Window BA on the device mesh: shard by point, run the
        distributed LM, then price per-observation chi2 (for outlier
        removal) on the ORIGINAL observation order with a replicated
        residual pass."""
        from ..parallel.sharded_ba import (
            shard_problem_by_point, sharded_schur_ba,
        )

        n = int(self.mesh.devices.size)
        sharded, _ = shard_problem_by_point(problem, n)
        kf, pts, info = sharded_schur_ba(
            sharded, self.camera, self.calib.R_cb, self.calib.t_cb,
            self.mesh, n_iters=n_iters)
        if self._chi2_jit is None:
            from .solver import _vis_residuals

            self._chi2_jit = jax.jit(
                lambda pb: _vis_residuals(pb, self.camera, self.calib.R_cb,
                                          self.calib.t_cb, CHI2_MONO)[0])
        # point sharding preserves point order, so (kf, pts) drop into the
        # original problem for the chi2 pass and the caller's write-back
        chi2 = self._chi2_jit(problem._replace(kf=kf, points=pts))
        info = dict(info)
        info["obs_chi2"] = chi2
        return kf, pts, info

    def _write_back_ba(self, store, kf, pts, info, ids, pids, obs_kf_l,
                       obs_pt_l, opt_ids, opt_points, vb_dofs,
                       remove_outliers, obs_slot=None):
        # write back keyframe states
        R = np.asarray(kf.R_wb)
        t = np.asarray(kf.t_wb)
        v = np.asarray(kf.v)
        bg = np.asarray(kf.bg)
        ba = np.asarray(kf.ba)
        opt_set = set(opt_ids)
        for i, k in enumerate(ids):
            if k in opt_set:
                store.kf_R[k] = _renormalize(R[i])
                store.kf_t[k] = t[i]
                if vb_dofs:
                    store.kf_v[k] = v[i]
                    store.kf_bg[k] = bg[i]
                    store.kf_ba[k] = ba[i]
        if opt_points:
            store.pt_xyz[pids] = np.asarray(pts)[: len(pids)]
        # outlier observation removal (chi2 > 5.991; Optimize.cpp:912-927)
        n_out = 0
        if remove_outliers:
            chi2_all = np.asarray(info["obs_chi2"])
            if obs_slot is None:
                obs_slot = np.arange(len(obs_kf_l))
            chi2 = chi2_all[obs_slot]
            bad = np.nonzero(chi2 > CHI2_MONO)[0]
            for o in bad:
                k = ids[obs_kf_l[o]]
                p = int(pids[obs_pt_l[o]])
                store.remove_observation(p, k)
                n_out += 1
        store.version += 1
        return {"cost0": float(info["cost0"]), "cost": float(info["cost"]),
                "n_outliers": n_out, "ids": ids, "n_points": len(pids)}

    # -- named problems --------------------------------------------------

    def initial_optimize(self, store, kf_ids, n_iters=20):
        """2-KF + points BA after two-view init (initialOptimize)."""
        return self.run_window_ba(store, opt_ids=[kf_ids[1]], fixed_ids=[kf_ids[0]],
                                  n_iters=n_iters, remove_outliers=False)

    def local_bundle_adjustment(self, store, center_kf, window=10, n_iters=8,
                                lock=None):
        """Covisibility-window visual BA with fixed anchors
        (localBundleAdjustment, Optimize.cpp:766-951).

        The window is the covisibility NEIGHBORHOOD of the current KF, and
        the anchors are every other KF observing the window's points
        (capped). Anchors must stay strongly covisible with the window:
        pinning the gauge on old, barely-covisible KFs lets BA wobble the
        young end of the map and destabilizes tracking."""
        opt_ids = [center_kf] + store.covisible_keyframes(center_kf, top=window - 1)
        opt_set = set(opt_ids)
        # anchors: covisible neighbors of the window that are not in it
        fixed = []
        for k in opt_ids:
            for j in store.covisible_keyframes(k, top=10):
                if j not in opt_set and j not in fixed:
                    fixed.append(j)
        if not fixed:
            # young map: anchor the oldest window KFs to pin the gauge
            by_time = sorted(opt_ids, key=lambda k: store.kf_time[k])
            if len(by_time) > 2:
                fixed = by_time[:2]
                opt_ids = [k for k in opt_ids if k not in fixed]
            else:
                fixed = by_time[:1]
                opt_ids = [k for k in opt_ids if k not in fixed]
        return self.run_window_ba(store, opt_ids, fixed[: self.local_k // 2],
                                  n_iters=n_iters, lock=lock)

    def _covisible_anchors(self, store, opt_ids, cap: int):
        """Fixed anchors for a sliding window: the out-of-window KFs that
        OBSERVE the window's points, ranked by shared observations (the
        reference fixes every observer, <=150, Optimize.cpp:1095).
        Temporal anchors can be weakly covisible with the window on
        revisits, which lets BA wobble the gauge (VERDICT weak #5)."""
        window = set(opt_ids)
        feat_pt = store.kf_feat_pt[np.asarray(list(opt_ids), np.int32)]
        pids = np.unique(feat_pt[feat_pt >= 0])
        pids = pids[store.pt_valid[pids]]
        if len(pids) == 0:
            older = [k for k in store.keyframe_ids() if k not in window]
            return older[-cap:]
        obs = store.pt_obs_kf[pids].reshape(-1)
        obs = obs[obs >= 0]
        counts = np.bincount(obs, minlength=store.max_kf)
        for k in window:
            counts[k] = 0
        anchors = np.argsort(-counts)[:cap]
        return [int(k) for k in anchors if counts[k] > 0]

    def local_full_bundle_adjustment(self, store, window=10, n_iters=8,
                                     lock=None):
        """Sliding-window visual-inertial BA (localFullBundleAdjustment).

        Anchor capacity fills the rest of the KF slots: the reference fixes
        EVERY out-of-window observer up to 150 (Optimize.cpp:1095). With
        only ~5 anchors a lap revisit pins the window on a sliver of the
        old map and the gauge wobbles (round-2: 71 anchors dropped on the
        60 s circle, 1.43 m ATE)."""
        opt_ids = store.recent_keyframes(window)
        fixed = self._covisible_anchors(
            store, opt_ids, cap=max(5, self.local_k - len(opt_ids)))
        return self.run_window_ba(store, opt_ids, fixed, n_iters=n_iters,
                                  inertial=True, vb_dofs=True, priors=True,
                                  lock=lock)

    def local_inertial_bundle_adjustment(self, store, window=10, n_iters=8,
                                         lock=None):
        """Velocity/bias-only sliding window (localInertialBundleAdjustment)."""
        opt_ids = store.recent_keyframes(window)
        fixed = [k for k in store.keyframe_ids() if k not in opt_ids][-3:]
        return self.run_window_ba(store, opt_ids, fixed, n_iters=n_iters,
                                  inertial=True, vb_dofs=True, priors=True,
                                  pose_dofs=False, opt_points=False,
                                  lock=lock)

    def _dummy_problem(self, K, P, O, grouped=False):
        """Shape-only BAProblem for solver warming (values are dummies)."""
        E = K - 1
        eyeK = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
        kf = KfState(jnp.asarray(eyeK), jnp.zeros((K, 3)), jnp.zeros((K, 3)),
                     jnp.zeros((K, 3)), jnp.zeros((K, 3)))
        pts = np.zeros((P, 3), np.float32)
        pts[:, 2] = 5.0
        obs_kf = (np.repeat(np.arange(K, dtype=np.int32), O // K) if grouped
                  else np.zeros(O, np.int32))
        return BAProblem(
            kf=kf, kf_dof=jnp.ones((K, 15)),
            points=jnp.asarray(pts), pt_active=jnp.ones(P, bool),
            obs_kf=jnp.asarray(obs_kf), obs_pt=jnp.zeros(O, jnp.int32),
            obs_uv=jnp.zeros((O, 2)), obs_inv_sigma2=jnp.ones(O),
            obs_valid=jnp.zeros(O, bool),
            ie_i=jnp.arange(E, dtype=jnp.int32),
            ie_j=jnp.arange(1, E + 1, dtype=jnp.int32),
            ie_edge=_identity_edge_batch(E), ie_valid=jnp.zeros(E, bool),
            walk_inv_sigma=jnp.ones((E, 6)), walk_valid=jnp.zeros(E, bool),
            prior_inv_sigma=jnp.zeros((K, 15)), prior_ref=kf,
        )

    def warm_solvers(self, n_feat: int, ba_iters=(8, 4, 12), warm_full=True):
        """Pre-compile the expensive jitted solvers at their runtime shapes.

        The C++ reference pays no JIT cost; here a cold XLA compile of the
        window BA takes seconds to minutes, which would stall a real-time stream at the exact moment the mapper first
        needs it. Values are dummies — only the traced shapes matter.
        `ba_iters` must match the mapper's dispatch (LocalMapping.process:
        8 then 4-iteration polish, plus the 12-iteration full polish).
        `warm_full` additionally compiles the large grouped-obs
        full-polish shape. The IMU init solve needs no warming — it runs
        on host in f64 (see inertial_optimize)."""
        import jax

        K, P, O = self.local_k, self.local_p, self.local_o
        wg = self.window_layout == "grouped" and O % K == 0
        problem = self._dummy_problem(K, P, O, grouped=wg)
        outs = []
        for n in ba_iters:
            outs.append(schur_ba(problem, self.camera, self.calib.R_cb,
                                 self.calib.t_cb, n_iters=n)[1])
        if warm_full and self.mesh is None:
            big = self._dummy_problem(self.full_k, self.full_p,
                                      self.full_k * self.full_opk,
                                      grouped=True)
            outs.append(schur_ba(big, self.camera, self.calib.R_cb,
                                 self.calib.t_cb, n_iters=12)[1])

        # frame pose optimizers at the feature capacity
        state0 = KfState(jnp.eye(3), jnp.zeros(3), jnp.zeros(3),
                         jnp.zeros(3), jnp.zeros(3))
        fpts = np.zeros((n_feat, 3), np.float32)
        fpts[:, 2] = 5.0
        zs = np.zeros((n_feat, 2), np.float32)
        ones = np.ones(n_feat, np.float32)
        nov = np.zeros(n_feat, bool)
        outs.append(self.pose_optimize(state0, fpts, zs, ones, nov)[0].t_wb)
        from ..models.imu import ImuBuffer
        pre = ImuBuffer().integrate(np.zeros(3), np.zeros(3), self.calib)
        outs.append(self.pose_full_optimize(
            state0, fpts, zs, ones, nov, state0, pre)[0].t_wb)

        jax.block_until_ready(outs)

    def full_inertial_optimize(self, store, n_iters=12):
        """Full VI-BA over all KFs + points (fullInertialOptimize,
        Optimize.cpp:239-442 — the reference optimizes EVERY keyframe and
        point).

        Sessions within `local_k` KFs solve the regular window shape.
        Larger sessions route through the LARGE grouped-obs problem
        (full_k/full_p/full_opk, solver.schur_ba grouped_obs — the flat
        one-hot assembly's FLOPs grow as O*K^2 and are prohibitive at
        K ~ 100):
        - up to full_k KFs, every keyframe enters the problem directly
          (all-KF coverage, closing VERDICT r03 weak #6);
        - beyond full_k, the newest half stays intact and the older
          history is stride-subsampled WITH inertial edges merged across
          the skipped keyframes (preintegration composes exactly — the
          MergeNext primitive), so the whole-chain velocity/bias tether
          stays connected, unlike the round-3 subsample whose skipped
          pairs simply lost their edges;
        - skipped keyframes then receive their nearest selected
          neighbor's left-multiplied SE(3) correction (+ rotated
          velocity, copied biases), keeping the un-polished poses
          consistent with the polished chain."""
        ids = store.keyframe_ids()
        if len(ids) <= self.local_k:
            opt_ids = ids[1:]  # anchor the first KF
            snap = {k: (store.kf_R[k].copy(), store.kf_t[k].copy())
                    for k in ids}
            out = self.run_window_ba(store, opt_ids, [ids[0]],
                                     n_iters=n_iters, inertial=True,
                                     vb_dofs=True, priors=True,
                                     fixed_vb_free=True)
            if out is not None:
                self._propagate_point_correction(store, snap,
                                                 out.get("pids"))
            return out
        if self.full_polish_mode == "off":
            return None
        if self.full_polish_mode == "recent" and len(ids) > self.full_k:
            # Sliding full window: the surgery-validated grouped machinery
            # (polish_surgery.py: monotone ATE improvement at <= full_k)
            # applied to the NEWEST full_k keyframes, anchored on the
            # window's oldest member — none of the three bisected >full_k
            # suspects (stride subsample, merged inertial edges, neighbor
            # correction propagation) is engaged. Old chain untouched:
            # every KF still gets polished many times while it rides
            # inside the newest-96 window.
            sel = ids[-self.full_k:]
            snap = {k: (store.kf_R[k].copy(), store.kf_t[k].copy())
                    for k in ids}
            out = self.run_window_ba(
                store, sel[1:], [sel[0]], n_iters=n_iters, inertial=True,
                vb_dofs=True, priors=True, fixed_vb_free=True,
                caps=(self.full_k, self.full_p,
                      self.full_k * self.full_opk), grouped=True)
            if out is not None:
                self._propagate_point_correction(store, snap,
                                                 out.get("pids"))
            return out
        if self.full_polish_mode == "capped" or (
                self.full_polish_mode == "hybrid" and len(ids) > self.full_k):
            # round-3 behavior (ablation arm): local_k-capped stride
            # subsample, skipped pairs simply lose their inertial edge
            K = self.local_k
            n_recent = max(K // 2, 4)
            old, recent = ids[:-n_recent], ids[-n_recent:]
            keep = np.unique(np.round(
                np.linspace(0, len(old) - 1, K - n_recent)).astype(np.int64))
            sub = [old[i] for i in keep] + recent
            return self.run_window_ba(store, sub[1:], [sub[0]],
                                      n_iters=n_iters, inertial=True,
                                      vb_dofs=True, priors=True,
                                      fixed_vb_free=True)
        K = self.full_k
        sel = ids
        if len(ids) > K:
            n_recent = K // 2
            old, recent = ids[:-n_recent], ids[-n_recent:]
            keep = np.unique(np.round(
                np.linspace(0, len(old) - 1, K - n_recent)).astype(np.int64))
            sel = [old[i] for i in keep] + recent
            log.info("full inertial BA: %d KFs exceed capacity %d, "
                     "stride-subsampling the %d oldest (merged IMU edges)",
                     len(ids), K, len(old))
        # ablation arm grouped_nomerge: the big grouped problem WITHOUT
        # merged edges (non-successor subsampled pairs lose their inertial
        # edge, like the capped round-3 polish)
        bufs = (None if self.full_polish_mode == "grouped_nomerge"
                else self._merged_windows(store, sel))
        # snapshot EVERY keyframe pose: corrections for skipped KFs AND
        # for the points the capacity-bounded problem could not include
        # are derived from old-vs-new poses after the solve
        snap = {k: (store.kf_R[k].copy(), store.kf_t[k].copy())
                for k in ids}
        out = self.run_window_ba(
            store, sel[1:], [sel[0]], n_iters=n_iters, inertial=True,
            vb_dofs=True, priors=True, fixed_vb_free=True,
            caps=(K, self.full_p, K * self.full_opk), grouped=True,
            edge_bufs=bufs)
        if len(sel) < len(ids):
            self._propagate_polish_correction(store, ids, sel, snap)
        self._propagate_point_correction(store, snap, out.get("pids"))
        return out

    def _propagate_polish_correction(self, store, ids, sel, snap):
        """Apply each skipped KF's nearest selected neighbor's pose
        correction (T_new ∘ T_old^-1 left-multiplied) so the subsampled
        polish leaves a consistent whole chain."""
        sel_set = set(sel)
        sel_times = np.asarray([store.kf_time[k] for k in sel])
        for k in ids:
            if k in sel_set:
                continue
            tk = store.kf_time[k]
            j = int(np.searchsorted(sel_times, tk))
            cand = [c for c in (j - 1, j) if 0 <= c < len(sel)]
            j = min(cand, key=lambda c: abs(sel_times[c] - tk))
            nb = sel[j]
            R_old, t_old = snap[nb]
            R_new, t_new = store.kf_R[nb], store.kf_t[nb]
            R_c = R_new @ R_old.T
            store.kf_R[k] = _renormalize(R_c @ store.kf_R[k])
            store.kf_t[k] = R_c @ (store.kf_t[k] - t_old) + t_new
            store.kf_v[k] = R_c @ store.kf_v[k]
            store.kf_bg[k] = store.kf_bg[nb].copy()
            store.kf_ba[k] = store.kf_ba[nb].copy()

    def _propagate_point_correction(self, store, snap, solved_pids):
        """Transform every valid map point the capacity-bounded polish
        could NOT include by its reference (first-observer) keyframe's
        SE(3) correction — the fixed-capacity analog of the reference's
        all-points fullInertialOptimize (Optimize.cpp:239-442 includes
        EVERY MapPoint; leaving the excluded half stale after a whole-map
        pose rewrite makes the live matching set fight the polished
        poses, measured on corridor60 as progressive gauge contraction
        to 1/2.9 — the round-4 grouped-polish regression)."""
        pids_all = np.nonzero(store.pt_valid)[0]
        if solved_pids is not None and len(solved_pids):
            stale = pids_all[~np.isin(pids_all, solved_pids)]
        else:
            stale = pids_all
        if len(stale) == 0:
            return
        refk = store.pt_obs_kf[stale, 0]
        ok = refk >= 0
        stale, refk = stale[ok], refk[ok]
        # per-KF corrections new ∘ old^-1 in one batched pass
        kf_ids = np.unique(refk)
        R_c = np.zeros((store.max_kf, 3, 3), np.float32)
        t_o = np.zeros((store.max_kf, 3), np.float32)
        t_n = np.zeros((store.max_kf, 3), np.float32)
        has = np.zeros(store.max_kf, bool)
        for k in kf_ids:
            if k not in snap:
                continue
            R_old, t_old = snap[k]
            R_c[k] = store.kf_R[k] @ R_old.T
            t_o[k], t_n[k] = t_old, store.kf_t[k]
            has[k] = True
        use = has[refk]
        stale, refk = stale[use], refk[use]
        x = store.pt_xyz[stale]
        store.pt_xyz[stale] = (
            np.einsum("pij,pj->pi", R_c[refk], x - t_o[refk]) + t_n[refk])

    # -- inertial initialization ----------------------------------------

    # Scale-acceptance gate for the inertial init. The linear alignment's
    # posterior sigma UNDERSTATES the true error (visual pose noise is
    # correlated across edges, the whitening is empirical): measured on the
    # corridor world, sigma_rel 0.211 admitted a scale of 10.86 where the
    # pre-init gauge demanded 18.3 — a 1.67x error at "2.5 sigma". A wrong
    # accepted scale is PERMANENT: the full-inertial polish immediately
    # reshapes the oscillating motion components to metric while the visual
    # far points hold the old mean gauge, so the map SHEARS, old points
    # stop projecting anywhere near their features (measured: best-feature
    # offset 3.5 px pre-init -> 130-260 px after), the long-baseline tether
    # dies, and the mean gauge random-walks (corridor: local scale 0.6 ->
    # 0.065 over 40 s, then starvation collapse). No later estimator can
    # see the error (the refine measured 1.008 +/- 0.003 against truth
    # 1.67): the only good init is a sharp one — defer until then.
    INIT_MAX_REL_SIGMA = 0.08

    def inertial_optimize(self, store, prior_g=1e6, prior_a=1e12, n_iters=60,
                          with_scale=True, min_edge_dt=0.2,
                          defer_above=None):
        """Vision-fixed inertial-only init (inertialOptimize): solves per-KF
        velocities, shared bg/ba, gravity direction R_wg, optional log-scale,
        with bias priors. Returns (R_wg, scale, bg, ba) and writes
        velocities/biases into the store.

        Runs ON HOST IN f64 (deliberate host/device cut): the reference
        solves this with f64 g2o on CPU (Optimize.cpp:93-205). The whitened
        preintegration information reaches ~2e5 (sigma_dP is micrometers
        over a 0.25 s window), so the normal equations condition at ~1e10 —
        far beyond f32, and an on-device f32 LM measurably converges to a
        wrong flat spot (scale off by 2-3x) whenever the visual KF
        positions carry more than ~0.1 mm of noise. A <=100-dim solve that
        fires once per session is control-plane work; the device keeps the
        per-frame and BA hot paths.

        The KF chain is SUBSAMPLED to edges of >= `min_edge_dt` (merging
        the raw IMU windows across skipped KFs — preintegration composes):
        per-edge visual position noise is constant while the scale/gravity
        signal in dP grows ~dt^2, so with a dense keyframe cadence (the
        idle-mapper policy inserts every 2-3 frames) raw consecutive edges
        put the linear alignment below its noise floor — measured on the
        circle-image world: 0.12 s edges estimate scale 2.64 where 0.2 s
        edges recover the true 6.47."""
        ids_all = store.keyframe_ids()
        if len(ids_all) < 3:
            return None
        # subsample to >= min_edge_dt edges, always keeping the newest KF;
        # cap the edge count so the host solve stays control-plane-cheap on
        # long sessions (the maintenance refinement re-runs this for the
        # whole KF set)
        span = store.kf_time[ids_all[-1]] - store.kf_time[ids_all[0]]
        min_edge_dt = max(min_edge_dt, span / 64.0)
        ids = [ids_all[0]]
        for k in ids_all[1:]:
            if store.kf_time[k] - store.kf_time[ids[-1]] >= min_edge_dt:
                ids.append(k)
        if ids[-1] != ids_all[-1]:
            tail_dt = store.kf_time[ids_all[-1]] - store.kf_time[ids[-1]]
            if tail_dt < 0.5 * min_edge_dt and len(ids) > 1:
                ids[-1] = ids_all[-1]
            else:
                ids.append(ids_all[-1])
        K = len(ids)
        if K < 3:
            ids = ids_all
            K = len(ids)
        bufs = self._merged_windows(store, ids)
        R, t, v, _, _ = store.keyframe_states(ids)
        edge = jax.tree_util.tree_map(
            lambda a: np.asarray(a[: K - 1], np.float64),
            self._batch_edges(store, ids, cap=K - 1, bufs=bufs))
        gate = (self.INIT_MAX_REL_SIGMA if defer_above is None
                else defer_above)
        out = _inertial_init_host(
            np.asarray(R, np.float64), np.asarray(t, np.float64),
            edge, prior_g, prior_a, with_scale=with_scale, n_iters=n_iters,
            t_bc=np.asarray(self.calib.t_bc, np.float64),
            skip_lm_above=(gate if with_scale else None))
        if with_scale and out["scale_sigma_rel"] > gate:
            # scale not yet sharply observable: DEFER — more trajectory
            # brings a turn or speed change; an accepted marginal scale
            # permanently shears the map gauge (see INIT_MAX_REL_SIGMA)
            log.warning("inertial alignment deferred: scale not observable "
                        "enough (relative sigma %.3f > %.2f, estimate %.3f,"
                        " span %.1f s)", out["scale_sigma_rel"], gate,
                        out["scale"],
                        store.kf_time[ids[-1]] - store.kf_time[ids[0]])
            return None
        R_wg = out["R_wg"].astype(np.float32)
        scale = float(out["scale"])
        bg = out["bg"].astype(np.float32)
        ba = out["ba"].astype(np.float32)
        vels = out["v"].astype(np.float32)
        # velocities: solved KFs directly, skipped KFs by time interpolation
        t_sel = np.asarray([store.kf_time[k] for k in ids])
        for k in ids_all:
            store.kf_bg[k] = bg
            store.kf_ba[k] = ba
        for i, k in enumerate(ids):
            store.kf_v[k] = vels[i]
        skipped = [k for k in ids_all if k not in set(ids)]
        for k in skipped:
            tk = store.kf_time[k]
            j = int(np.searchsorted(t_sel, tk))
            j = min(max(j, 1), K - 1)
            w = (tk - t_sel[j - 1]) / max(t_sel[j] - t_sel[j - 1], 1e-9)
            store.kf_v[k] = (1.0 - w) * vels[j - 1] + w * vels[j]
        return {"R_wg": R_wg, "scale": scale, "bg": bg, "ba": ba,
                "cost0": float(out["cost0"]), "cost": float(out["cost"]),
                "scale_sigma_rel": float(out.get("scale_sigma_rel", 0.0))}

    def _merged_windows(self, store, sel_ids):
        """Concatenated raw IMU windows between consecutive SELECTED KFs
        (composing across the skipped ones — the MergeNext primitive,
        Imu.cpp:157-172, applied to a subsampled chain)."""
        from ..models.imu import ImuBuffer

        order = store.keyframe_ids()
        pos = {k: i for i, k in enumerate(order)}
        bufs = []
        for a, b in zip(sel_ids[:-1], sel_ids[1:]):
            buf = ImuBuffer()
            for k in order[pos[a]:pos[b]]:
                src = store.kf_imu.get(k)
                if src is not None:
                    buf.extend(src)
            bufs.append(buf)
        return bufs

    def gravity_optimize(self, store, n_iters=30):
        """Gravity-direction-only refinement (gravityOptimize)."""
        out = self.inertial_optimize(store, prior_g=1e8, prior_a=1e12,
                                     n_iters=n_iters, with_scale=False)
        return out


# ---------------------------------------------------------------------------
# inertial init host core (f64)
# ---------------------------------------------------------------------------


def _np_exp_so3(w: np.ndarray) -> np.ndarray:
    th = float(np.linalg.norm(w))
    W = np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]])
    if th < 1e-10:
        return np.eye(3) + W
    return (np.eye(3) + np.sin(th) / th * W
            + (1.0 - np.cos(th)) / th**2 * (W @ W))


def _np_log_so3(R: np.ndarray) -> np.ndarray:
    w = 0.5 * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    c = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    s = np.linalg.norm(w)
    if s < 1e-10:
        return w
    th = np.arctan2(s, c)
    return w * (th / s)


def _gravity_r_wg0(g_dir: np.ndarray) -> np.ndarray:
    """Rotation taking (0,0,-1) onto the given gravity direction."""
    g_i = np.array([0.0, 0.0, -1.0])
    axis = np.cross(g_i, g_dir)
    s_norm = np.linalg.norm(axis)
    if s_norm < 1e-9:
        return np.eye(3) if g_dir[2] < 0 else _np_exp_so3(np.array([np.pi, 0, 0]))
    return _np_exp_so3(axis / s_norm * np.arctan2(s_norm, float(g_i @ g_dir)))


def _inertial_init_host(R_wb, t_wb, edge: PreintEdge, prior_g, prior_a,
                        with_scale: bool, n_iters: int = 60, t_bc=None,
                        skip_lm_above=None):
    """f64 host LM for the vision-fixed inertial init (EdgeInertialGS
    residuals, G2oTypes.cpp:71-163), seeded by the CLOSED-FORM linear
    visual-inertial alignment: with rotations fixed, the preintegration
    equations are exactly linear in {metric velocities, gravity vector,
    scale}, so one least-squares solve lands next to the optimum and the
    LM only refines biases + renormalizes |g| to 9.8. All math is numpy
    f64 — see inertial_optimize for why this cannot run in f32.

    THE LEVER ARM IS MODELED EXPLICITLY: the stored body positions carry
    the METRIC camera-IMU lever (t_wb = c_visual + R_wb t_bc — the same
    convention MapStore.apply_scale_rotation preserves), so only the
    camera-center part may be multiplied by the scale. Scaling t_wb
    directly injects (s-1)(R_{i+1}-R_i) t_bc per edge — an error that is
    ~|Delta yaw| * |t_bc| * s while the gravity signal is ~0.5 g dt^2, so
    its RELATIVE size grows as 1/dt: with the idle-mapper KF cadence
    (0.1-0.15 s edges) it reached ~10% per edge and the whitened optimum
    moved to scale 2.6 where the data demand 7.0 (circle-image world).

    Velocities are returned in the VISUAL (map) scale, matching the
    EdgeInertialGS parametrization and MapStore.apply_scale_rotation's
    `v *= scale` gauge rewrite."""
    K = R_wb.shape[0]
    E = K - 1
    if t_bc is None:
        t_bc = np.zeros(3)
    Rs = R_wb
    # visual-scale camera centers + per-edge metric lever displacement
    ps = t_wb - np.einsum("kij,j->ki", R_wb, t_bc)
    lever = np.einsum("kij,j->ki", R_wb[1:] - R_wb[:-1], t_bc)  # [E, 3] metric
    dR_m, dV_m, dP_m = edge.dR, edge.dV, edge.dP
    dts = edge.dt
    L_inv = edge.L_inv

    # --- gyro-bias seed from rotation residuals ----------------------
    # er(bg) ~= log(dR^T R1^T R2) - JRg (bg - bg0); rotation-only, so it
    # decouples from v/g/s and keeps the bias signal out of the empirical
    # whitening floor below.
    Ag_rows = [edge.JRg[i] for i in range(E)]
    bg_rows = [_np_log_so3(dR_m[i].T @ Rs[i].T @ Rs[i + 1])
               + edge.JRg[i] @ edge.bg0[i] for i in range(E)]
    bg_seed, *_ = np.linalg.lstsq(np.concatenate(Ag_rows),
                                  np.concatenate(bg_rows), rcond=None)
    if not np.isfinite(bg_seed).all() or np.linalg.norm(bg_seed) > 0.5:
        bg_seed = np.zeros(3)

    # --- linear alignment seed (bias-corrected edges) -----------------
    # Two passes: a FREE-gravity solve for the direction, then fixed-point
    # iterations with |g| CONSTRAINED to 9.8 on the gravity-sphere tangent.
    # The constraint is load-bearing for the scale: on low-excitation data
    # the p-rows are dominated by 0.5 g dt^2, so a free |g| absorbs a wrong
    # scale almost perfectly (measured on the circle-image world: free
    # solve s=2.61 with |g|=9.66 vs constrained s=5.56, true 7.0 — the
    # VINS-Mono-style alignment refinement).
    G_NORM = 9.8

    def _align_rows(g_base=None, tangent=None):
        gcols = 3 if tangent is None else 2
        ncols = 3 * K + gcols + (1 if with_scale else 0)
        A_rows, b_rows = [], []
        for i in range(E):
            Rt = Rs[i].T
            dt = float(dts[i])
            db_g = bg_seed - edge.bg0[i]
            dV_c = dV_m[i] + edge.JVg[i] @ db_g
            dP_c = dP_m[i] + edge.JPg[i] @ db_g
            dp_vis = Rt @ (ps[i + 1] - ps[i])
            dp_lever = Rt @ lever[i]  # metric, scale-independent
            rowP = np.zeros((3, ncols))
            rhsP = dP_c - dp_lever
            rowP[:, 3 * i : 3 * i + 3] = -Rt * dt
            if tangent is None:
                rowP[:, 3 * K : 3 * K + 3] = -0.5 * dt * dt * Rt
            else:
                rowP[:, 3 * K : 3 * K + 2] = -0.5 * dt * dt * (Rt @ tangent)
                rhsP = rhsP + 0.5 * dt * dt * (Rt @ g_base)
            if with_scale:
                rowP[:, -1] = dp_vis
            else:
                rhsP = rhsP - dp_vis
            A_rows.append(rowP)
            b_rows.append(rhsP)
            rowV = np.zeros((3, ncols))
            rhsV = dV_c.copy()
            rowV[:, 3 * i : 3 * i + 3] = -Rt
            rowV[:, 3 * (i + 1) : 3 * (i + 1) + 3] = Rt
            if tangent is None:
                rowV[:, 3 * K : 3 * K + 3] = -dt * Rt
            else:
                rowV[:, 3 * K : 3 * K + 2] = -dt * (Rt @ tangent)
                rhsV = rhsV + dt * (Rt @ g_base)
            A_rows.append(rowV)
            b_rows.append(rhsV)
        return np.concatenate(A_rows), np.concatenate(b_rows)

    def _align_rows_inv(g_base=None, tangent=None, inv_s_prev=1.0):
        """INVERSE-regression alignment (errors-in-variables fix): the
        noisy measured quantity — the visual displacement dp_vis — sits on
        the RESPONSE side, and the clean IMU/gravity terms regress 1/s.
        With dp_vis as a regressor column (the textbook VINS form used by
        _align_rows) its noise attenuates the scale estimate toward zero:
        measured on the corridor world the estimate plateaued ~20% low
        (14-16 against a true 19.8) no matter how much data accrued, and
        the accepted under-scale permanently sheared the map. Unknowns:
        [v_visual(3K), w(3) | theta(2), inv_s]; with gravity free, w =
        inv_s * g is solved as one combined column block (still linear);
        constrained passes substitute w = G_NORM*(inv_s*ghat +
        inv_s_prev*Tn theta) (Gauss-Seidel on the bilinear term)."""
        gcols = 3 if tangent is None else 2
        ncols = 3 * K + gcols + (0 if tangent is None else 1)
        A_rows, b_rows = [], []
        for i in range(E):
            Rt = Rs[i].T
            dt = float(dts[i])
            db_g = bg_seed - edge.bg0[i]
            dV_c = dV_m[i] + edge.JVg[i] @ db_g
            dP_c = dP_m[i] + edge.JPg[i] @ db_g
            dp_vis = Rt @ (ps[i + 1] - ps[i])
            dp_lever = Rt @ lever[i]  # metric, scale-independent
            rowP = np.zeros((3, ncols))
            rowP[:, 3 * i : 3 * i + 3] = Rt * dt
            if tangent is None:
                # free pass: w = inv_s * g is its own column block, and
                # inv_s rides implicitly inside it; the inv_s-scaled IMU
                # term is approximated with inv_s_prev (refined by the
                # constrained passes)
                rowP[:, 3 * K : 3 * K + 3] = 0.5 * dt * dt * Rt
                rhsP = dp_vis - inv_s_prev * (dP_c - dp_lever)
            else:
                rowP[:, 3 * K : 3 * K + 2] = (
                    0.5 * dt * dt * G_NORM * inv_s_prev * (Rt @ tangent))
                rowP[:, -1] = (0.5 * dt * dt * G_NORM * (Rt @ g_base)
                               + dP_c - dp_lever)
                rhsP = dp_vis
            A_rows.append(rowP)
            b_rows.append(rhsP)
            rowV = np.zeros((3, ncols))
            rowV[:, 3 * i : 3 * i + 3] = -Rt
            rowV[:, 3 * (i + 1) : 3 * (i + 1) + 3] = Rt
            if tangent is None:
                rowV[:, 3 * K : 3 * K + 3] = -dt * Rt
                rhsV = inv_s_prev * dV_c
            else:
                rowV[:, 3 * K : 3 * K + 2] = (
                    -dt * G_NORM * inv_s_prev * (Rt @ tangent))
                rowV[:, -1] = -(dt * G_NORM * (Rt @ g_base) + dV_c)
                rhsV = np.zeros(3)
            A_rows.append(rowV)
            b_rows.append(rhsV)
        return np.concatenate(A_rows), np.concatenate(b_rows)

    scale_sigma_rel = 0.0
    if with_scale:
        # free-gravity inverse pass for the direction (iterate once on the
        # implicit inv_s), then constrained passes for {v, theta, inv_s}
        inv_s = 1.0
        g_lin = np.zeros(3)
        x_lin = np.zeros(3 * K + 3)
        for _ in range(2):
            A, b = _align_rows_inv(inv_s_prev=inv_s)
            x_f, *_ = np.linalg.lstsq(A, b, rcond=None)
            if not np.isfinite(x_f).all():
                break
            w = x_f[3 * K : 3 * K + 3]
            if np.linalg.norm(w) < 1e-9:
                break
            inv_s_new = float(np.linalg.norm(w)) / G_NORM
            g_lin = w / max(inv_s_new, 1e-12)
            inv_s = inv_s_new
            x_lin = x_f
        if np.isfinite(g_lin).all() and np.linalg.norm(g_lin) > 1.0:
            for _ in range(3):
                ghat = g_lin / np.linalg.norm(g_lin)
                a0 = (np.array([1.0, 0.0, 0.0]) if abs(ghat[0]) < 0.9
                      else np.array([0.0, 1.0, 0.0]))
                b1 = np.cross(ghat, a0)
                b1 /= np.linalg.norm(b1)
                b2 = np.cross(ghat, b1)
                Tn = np.stack([b1, b2], axis=1)
                A, b = _align_rows_inv(g_base=ghat, tangent=Tn,
                                       inv_s_prev=inv_s)
                x_c, *_ = np.linalg.lstsq(A, b, rcond=None)
                if not np.isfinite(x_c).all() or x_c[-1] <= 1e-9:
                    break
                inv_s = float(x_c[-1])
                g_new = G_NORM * (ghat + Tn @ x_c[3 * K : 3 * K + 2])
                g_lin = G_NORM * g_new / np.linalg.norm(g_new)
                x_lin = x_c
            # scale observability: posterior std of inv_s from the final
            # constrained system. Under constant-velocity motion (the
            # vehicle/KITTI regime) the accelerometer sees only gravity,
            # the inv_s column is near-null, and lstsq extrapolates
            # garbage — callers defer the init on a large relative sigma.
            resid = A @ x_lin - b
            dof_n = max(len(b) - A.shape[1], 1)
            resid_var = float(resid @ resid) / dof_n
            try:
                cov_ss = float(np.linalg.inv(A.T @ A)[-1, -1]) * resid_var
                scale_sigma_rel = float(
                    np.sqrt(max(cov_ss, 0.0)) / max(abs(inv_s), 1e-12))
            except np.linalg.LinAlgError:
                scale_sigma_rel = np.inf
        s_seed = 1.0 / inv_s if inv_s > 1e-9 else np.inf
        v_metric = x_lin[: 3 * K].reshape(K, 3) * (
            s_seed if np.isfinite(s_seed) else 0.0)
    else:
        A, b = _align_rows()
        x_lin, *_ = np.linalg.lstsq(A, b, rcond=None)
        g_lin = x_lin[3 * K : 3 * K + 3]
        if np.isfinite(g_lin).all() and np.linalg.norm(g_lin) > 1.0:
            for _ in range(3):
                ghat = g_lin / np.linalg.norm(g_lin)
                a0 = (np.array([1.0, 0.0, 0.0]) if abs(ghat[0]) < 0.9
                      else np.array([0.0, 1.0, 0.0]))
                b1 = np.cross(ghat, a0)
                b1 /= np.linalg.norm(b1)
                b2 = np.cross(ghat, b1)
                Tn = np.stack([b1, b2], axis=1)
                A, b = _align_rows(g_base=G_NORM * ghat, tangent=Tn)
                x_c, *_ = np.linalg.lstsq(A, b, rcond=None)
                if not np.isfinite(x_c).all():
                    break
                g_new = G_NORM * ghat + Tn @ x_c[3 * K : 3 * K + 2]
                g_lin = G_NORM * g_new / np.linalg.norm(g_new)
                x_lin = x_c
        s_seed = 1.0
        v_metric = x_lin[: 3 * K].reshape(K, 3)
    if (not np.isfinite(s_seed) or s_seed < 1e-3
            or not np.isfinite(g_lin).all()
            or np.linalg.norm(g_lin) < 1.0):
        # degenerate geometry: fall back to the reference's dV-sum gravity
        # heuristic (LocalMapping.cpp:391-407) and a unit scale
        s_seed = 1.0
        dV_sum = dV_m.sum(axis=0)
        g_lin = -dV_sum / max(np.linalg.norm(dV_sum), 1e-9) * 9.8
        v_metric = np.zeros((K, 3))
    R_wg0 = _gravity_r_wg0(g_lin / np.linalg.norm(g_lin))
    if (with_scale and skip_lm_above is not None
            and scale_sigma_rel > skip_lm_above):
        # the caller will defer on this sigma anyway: skip the (host-LM)
        # refinement — the init is retried at EVERY new keyframe, and the
        # 60-iteration forward-difference LM is the expensive part
        return {"v": v_metric / max(s_seed, 1e-9), "bg": bg_seed,
                "ba": np.zeros(3), "R_wg": R_wg0, "scale": s_seed,
                "cost0": float("nan"), "cost": float("nan"),
                "scale_sigma_rel": scale_sigma_rel}
    ls0 = np.log(s_seed)

    # --- f64 LM refine over [v_vis(3K), bg(3), ba(3), theta(2)] --------
    # The LOG-SCALE IS FROZEN at the linear seed: the LM objective has s
    # multiplying the noisy visual displacements, i.e. the same errors-in-
    # variables structure the inverse-regression seed was built to avoid —
    # letting the LM move ls drags the unbiased seed back toward the
    # attenuated optimum (measured on the corridor: seed 17.9 -> LM 16.3
    # against a true 19.8). Biases, velocities and the gravity tangent
    # stay free; they are what the LM is for.
    G_vec = np.array([0.0, 0.0, -9.8])
    sp_g, sp_a = np.sqrt(prior_g), np.sqrt(prior_a)
    dim = 3 * K + 8
    bg0_e, ba0_e = edge.bg0, edge.ba0
    JRg, JVg, JVa = edge.JRg, edge.JVg, edge.JVa
    JPg, JPa = edge.JPg, edge.JPa

    def unpack(x):
        v = x[: 3 * K].reshape(K, 3)
        bg = x[3 * K : 3 * K + 3]
        ba = x[3 * K + 3 : 3 * K + 6]
        theta = x[3 * K + 6 : 3 * K + 8]
        return v, bg, ba, theta, 0.0  # ls frozen at the seed (see above)

    def residual(x, L_w, ls_base=0.0):
        v, bg, ba, theta, ls = unpack(x)
        s = np.exp(ls + ls_base)
        R_wg = R_wg0 @ _np_exp_so3(np.array([theta[0], theta[1], 0.0]))
        g = R_wg @ G_vec
        out = np.empty(9 * E + 6)
        for i in range(E):
            db_g = bg - bg0_e[i]
            db_a = ba - ba0_e[i]
            dR_c = dR_m[i] @ _np_exp_so3(JRg[i] @ db_g)
            dV_c = dV_m[i] + JVg[i] @ db_g + JVa[i] @ db_a
            dP_c = dP_m[i] + JPg[i] @ db_g + JPa[i] @ db_a
            Rt = Rs[i].T
            dt = float(dts[i])
            er = _np_log_so3(dR_c.T @ Rt @ Rs[i + 1])
            ev = Rt @ (s * (v[i + 1] - v[i]) - g * dt) - dV_c
            ep = Rt @ (s * (ps[i + 1] - ps[i] - v[i] * dt)
                       + lever[i] - 0.5 * g * dt * dt) - dP_c
            out[9 * i : 9 * i + 9] = L_w[i] @ np.concatenate([er, ev, ep])
        out[9 * E : 9 * E + 3] = sp_g * bg
        out[9 * E + 3 :] = sp_a * ba
        return out

    x = np.zeros(dim)
    x[: 3 * K] = (v_metric / s_seed).reshape(-1)
    x[3 * K : 3 * K + 3] = bg_seed

    # s = exp(ls0) fixed: rebase by adding ls0 inside the residual's scale
    def residual_rebased(x, L_w):
        return residual(x, L_w, ls_base=ls0 if with_scale else 0.0)

    # Empirical whitening floor: the IMU-only information treats visual KF
    # pose noise (mm-level in metric once scaled) as hundreds of sigma —
    # the whitened MAP optimum then trades true scale against a gravity
    # tilt (measured: scale off 2.5x with a perfect-shape visual map).
    # The linear-alignment residual IS the actual per-block error level,
    # so scale each 3-row block of L_inv down to put the seed at ~1 sigma;
    # clean data (whitened seed already <= 1 sigma) keeps the reference's
    # pure-IMU weighting (alpha = 1).
    w_seed = residual_rebased(x, L_inv)[: 9 * E].reshape(E, 9)
    L_eff = L_inv.copy()
    for b in range(3):
        rms = float(np.sqrt((w_seed[:, 3 * b : 3 * b + 3] ** 2).mean()))
        L_eff[:, 3 * b : 3 * b + 3, :] /= max(1.0, rms)

    r = residual_rebased(x, L_eff)
    cost0 = cost = float(r @ r)
    lam = 1e-4
    for _ in range(n_iters):
        # forward-difference Jacobian (dim <= ~100, E <= ~60: microseconds)
        J = np.empty((r.size, dim))
        h = 1e-7
        for j in range(dim):
            xj = x.copy()
            xj[j] += h
            J[:, j] = (residual_rebased(xj, L_eff) - r) / h
        H = J.T @ J
        grad = J.T @ r
        ok_step = False
        for _try in range(8):
            D = np.diag(np.maximum(np.diag(H), 1e-12))
            try:
                step = -np.linalg.solve(H + lam * D, grad)
            except np.linalg.LinAlgError:
                lam *= 10.0
                continue
            x_new = x + step
            r_new = residual_rebased(x_new, L_eff)
            c_new = float(r_new @ r_new)
            if c_new < cost:
                x, r, cost = x_new, r_new, c_new
                lam = max(lam * 0.3, 1e-12)
                ok_step = True
                break
            lam *= 10.0
        if not ok_step or (np.linalg.norm(step) < 1e-12):
            break

    v, bg, ba, theta, ls = unpack(x)
    s = float(np.exp(ls + (ls0 if with_scale else 0.0)))
    R_wg = R_wg0 @ _np_exp_so3(np.array([theta[0], theta[1], 0.0]))
    return {"v": v, "bg": bg, "ba": ba, "R_wg": R_wg, "scale": s,
            "cost0": cost0, "cost": cost,
            "scale_sigma_rel": scale_sigma_rel}


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _identity_edge() -> PreintEdge:
    return PreintEdge(
        dR=jnp.eye(3), dV=jnp.zeros(3), dP=jnp.zeros(3),
        JRg=jnp.zeros((3, 3)), JVg=jnp.zeros((3, 3)), JVa=jnp.zeros((3, 3)),
        JPg=jnp.zeros((3, 3)), JPa=jnp.zeros((3, 3)),
        bg0=jnp.zeros(3), ba0=jnp.zeros(3), dt=jnp.float32(1.0),
        L_inv=jnp.eye(9),
    )


def _identity_edge_batch(E: int) -> PreintEdge:
    one = _identity_edge()
    return jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a, (E, *a.shape)), one
    )


def _pad_kf(x: np.ndarray, n: int) -> np.ndarray:
    if n <= 0:
        return np.zeros((0, *x.shape[1:]), x.dtype)
    if x.ndim == 3:  # rotations: pad with identity
        return np.tile(np.eye(3, dtype=x.dtype), (n, 1, 1))
    return np.zeros((n, *x.shape[1:]), x.dtype)


def _renormalize(R: np.ndarray) -> np.ndarray:
    U, _, Vt = np.linalg.svd(R)
    out = U @ Vt
    if np.linalg.det(out) < 0:
        U[:, -1] *= -1
        out = U @ Vt
    return out.astype(np.float32)
