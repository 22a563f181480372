"""Distributed Schur-complement bundle adjustment over a device mesh.

Replacement for the reference's single-machine shared-memory
concurrency (SURVEY.md §2.3): the mutex-guarded map becomes explicitly
sharded state, and the local/full BA's landmark reduction is distributed
with `shard_map` + `psum` across devices (BASELINE.json north star).

Sharding layout (one mesh axis, "dp"):
- landmarks and their observations are partitioned BY POINT across devices
  (the host groups each point's observations onto its shard);
- per-shard: visual linearization, landmark Hessian blocks Hll, their
  inverses, and the dense W/Y tensors are fully local;
- the reduced camera system S = Hcc - sum_p Y_p W_p^T and its RHS are
  formed by `psum` over the mesh — one [K,K,15,15] + [K,15] all-reduce
  per iteration;
- the small dense solve (<= K*15 dims) is replicated on every device;
- landmark back-substitution is again fully local per shard.

This mirrors the single-chip `schur_ba` exactly (same BAProblem pytree),
so results match up to floating-point reduction order.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..backend import residuals as res
from ..utils.precision import f32_matmuls
from ..backend.solver import (
    BAProblem, CHI2_MONO, _gather_kf, _inertial_linearize,
    _prior_linearize, _scatter_edge_blocks, _vis_linearize, _vis_residuals,
    _walk_linearize, inv3x3, visual_block_sums,
)


def shard_problem_by_point(problem: BAProblem, n_shards: int) -> BAProblem:
    """Host-side regrouping: order observations so each point's obs land on
    its point-shard. Returns a BAProblem whose points/obs arrays can be
    sharded on their leading axis into `n_shards` equal blocks."""
    import numpy as np

    P_ = problem.points.shape[0]
    assert P_ % n_shards == 0, "pad point capacity to a multiple of n_shards"
    per_pt = P_ // n_shards

    obs_pt = np.asarray(problem.obs_pt)
    obs_valid = np.asarray(problem.obs_valid)
    shard_of_pt = obs_pt // per_pt

    # per-shard capacity sized to the worst shard (no silent drops)
    counts = np.bincount(shard_of_pt[obs_valid], minlength=n_shards)
    per_obs = max(8, int(-(-counts.max() // 8) * 8))
    O_new = per_obs * n_shards

    order = np.zeros(O_new, np.int64)  # default: slot 0 (disabled via mask)
    keep = np.zeros(O_new, bool)
    fill = [0] * n_shards
    for o in np.nonzero(obs_valid)[0]:
        s = int(shard_of_pt[o])
        slot = s * per_obs + fill[s]
        order[slot] = o
        keep[slot] = True
        fill[s] += 1

    idx = jnp.asarray(order)
    return problem._replace(
        obs_kf=problem.obs_kf[idx],
        obs_pt=problem.obs_pt[idx],
        obs_uv=problem.obs_uv[idx],
        obs_inv_sigma2=problem.obs_inv_sigma2[idx],
        obs_valid=problem.obs_valid[idx] & jnp.asarray(keep),
    ), 0


@partial(jax.jit, static_argnames=("mesh", "n_iters", "huber_delta2"))
@f32_matmuls
def sharded_schur_ba(problem: BAProblem, camera, R_cb, t_cb, mesh: Mesh,
                     n_iters: int = 8, huber_delta2: float = CHI2_MONO,
                     lambda0: float = 1e-4):
    """Distributed LM bundle adjustment. `problem` must be pre-grouped with
    `shard_problem_by_point`. Returns (kf, points, info) like schur_ba."""
    K = problem.kf_dof.shape[0]
    axis = mesh.axis_names[0]

    pt_spec = P(axis)
    rep = P()
    in_specs = BAProblem(
        kf=res.KfState(rep, rep, rep, rep, rep),
        kf_dof=rep,
        points=pt_spec, pt_active=pt_spec,
        obs_kf=pt_spec, obs_pt=pt_spec, obs_uv=pt_spec,
        obs_inv_sigma2=pt_spec, obs_valid=pt_spec,
        ie_i=rep, ie_j=rep,
        ie_edge=jax.tree_util.tree_map(lambda _: rep, problem.ie_edge),
        ie_valid=rep, walk_inv_sigma=rep, walk_valid=rep,
        prior_inv_sigma=rep,
        prior_ref=res.KfState(rep, rep, rep, rep, rep),
    )

    P_total = problem.points.shape[0]
    n_shards = mesh.devices.size
    per_pt = P_total // n_shards

    def run_local(pb_local: BAProblem):
        """The FULL parallel-lambda LM loop, per-device on the local
        obs/point shard; camera states are replicated, reductions ride one
        psum per stage. Local obs_pt indices are global — rebase them."""
        shard_id = jax.lax.axis_index(axis)
        pb0 = pb_local._replace(obs_pt=pb_local.obs_pt - shard_id * per_pt)
        Pl = pb0.points.shape[0]
        on0 = (shard_id == 0).astype(jnp.float32)
        dof = pb0.kf_dof.reshape(-1)
        diag_idx = jnp.arange(K)

        def total_cost_partial(kf, pts, valid_override=None):
            """Per-shard cost partial: local visual part + camera-only
            terms on shard 0; caller psums."""
            pb = pb0._replace(kf=kf, points=pts)
            _, c_vis = _vis_residuals(pb, camera, R_cb, t_cb, huber_delta2,
                                      valid_override)
            s1 = _gather_kf(kf, pb.ie_i)
            s2 = _gather_kf(kf, pb.ie_j)
            r_e = res.inertial_residual(s1, s2, pb.ie_edge)
            c_ie = jnp.sum(pb.ie_valid.astype(jnp.float32) * jnp.sum(r_e * r_e, -1))
            r_w = res.bias_walk_residual(s1, s2, pb.walk_inv_sigma)
            c_walk = jnp.sum(pb.walk_valid.astype(jnp.float32) * jnp.sum(r_w * r_w, -1))
            _, _, c_prior = _prior_linearize(pb)
            return c_vis + (c_ie + c_walk + c_prior) * on0

        def linearize_assemble(kf, pts):
            pb = pb0._replace(kf=kf, points=pts)
            r_v, Jc, Jl, w_v, chi2_v, c_vis = _vis_linearize(
                pb, camera, R_cb, t_cb, huber_delta2)

            # assembly (mirrors solver.schur_ba): one augmented-Jacobian
            # block product, then the local segment sums
            Ja = jnp.concatenate([Jc, Jl, -r_v[:, :, None]], -1)  # [O, 2, 10]
            B = jnp.einsum("oik,oil->okl", Ja * w_v[:, None, None], Ja)
            camk, ptk, W_p = visual_block_sums(B, pb.obs_kf, pb.obs_pt, K, Pl)
            Hcc = jnp.zeros((K, K, 15, 15), jnp.float32)
            Hcc = Hcc.at[diag_idx, diag_idx, :6, :6].add(
                camk[:, :36].reshape(K, 6, 6))
            b_c = jnp.zeros((K, 15), jnp.float32).at[:, :6].set(camk[:, 36:])

            Hll = ptk[:, :9].reshape(Pl, 3, 3)
            b_l = ptk[:, 9:12]

            # inertial + walk + priors touch only camera blocks; weight by
            # on0 so the psum does not double count
            r_e, J1, J2, w_e, c_ie = _inertial_linearize(pb)
            r_w, Jw1, Jw2, w_w, c_walk = _walk_linearize(pb)
            r_p, pr_inv_sigma, c_prior = _prior_linearize(pb)
            Hcc, b_c = _scatter_edge_blocks(
                Hcc, b_c, pb.ie_i, pb.ie_j,
                ((r_e, J1, J2, w_e * on0), (r_w, Jw1, Jw2, w_w * on0)))
            pr_w2 = (pr_inv_sigma * pr_inv_sigma) * on0
            pr_full = jnp.zeros((K, 15), jnp.float32).at[:, 6:15].set(pr_w2)
            Hcc = Hcc.at[diag_idx, diag_idx].add(jax.vmap(jnp.diag)(pr_full))
            b_c = b_c.at[:, 6:15].add(-pr_inv_sigma * r_p * on0)

            # local landmark elimination; damping is lambda-independent
            # (small fixed relative term, see solver.schur_ba) so the Schur
            # pipeline runs once per linearization
            Hll_d = Hll + 1e-6 * jnp.eye(3, dtype=jnp.float32)[None] \
                + 1e-3 * jax.vmap(jnp.diag)(
                    jnp.maximum(jax.vmap(jnp.diagonal)(Hll), 1e-8))
            Hll_inv = inv3x3(Hll_d)
            Y_p = jnp.einsum("pkv,pvw->pkw", W_p, Hll_inv)  # [Pl, K*6, 3]
            # full f32 (not TF32): the reduced system feeds the Cholesky
            S6 = jax.lax.dot_general(
                Y_p, W_p, (((0, 2), (0, 2)), ((), ())),
                precision=jax.lax.Precision.HIGHEST)  # [K*6, K*6]
            b6 = jnp.einsum("pkv,pv->k", Y_p, b_l)

            S_local = Hcc.at[:, :, :6, :6].add(
                -S6.reshape(K, 6, K, 6).transpose(0, 2, 1, 3))
            b_local = b_c.at[:, :6].add(-b6.reshape(K, 6))

            # --- the distributed reduction: one psum ---
            S = jax.lax.psum(S_local, axis)
            b = jax.lax.psum(b_local, axis)
            c_lin = jax.lax.psum(
                c_vis + (c_ie + c_walk + c_prior) * on0, axis)

            Sm = S.transpose(0, 2, 1, 3).reshape(K * 15, K * 15)
            Sm = Sm * dof[:, None] * dof[None, :] + jnp.diag(1.0 - dof)
            bm = b.reshape(-1) * dof
            return Sm, bm, W_p, Hll_inv, b_l, c_lin, w_v > 0

        def solve_reduced(Sm, bm, lam):
            Sd = Sm + jnp.diag(lam * jnp.maximum(jnp.diagonal(Sm), 1e-8))
            d = jnp.sqrt(jnp.maximum(jnp.diagonal(Sd), 1e-12))
            Sd_n = Sd / d[:, None] / d[None, :]
            L = jnp.linalg.cholesky(Sd_n)
            return (jax.scipy.linalg.cho_solve((L, True), bm / d)
                    / d).reshape(K, 15)

        # deferred-accept single-lambda LM (mirrors solver.schur_ba
        # deferred=True): accept/reject rides the NEXT iteration's psum'd
        # linearization cost, so the per-iteration candidate-cost psum and
        # the second damped Cholesky disappear — one collective per
        # iteration (the S/b reduction) instead of two
        def body(carry, _):
            kf, pts, kf_b, pts_b, cost_b, lam = carry
            Sm, bm, W_p, Hll_inv, b_l, cost_lin, _ = linearize_assemble(kf, pts)
            # NaN-robust reject (see solver.schur_ba); psum'd -> identical
            # on all shards
            worse = jnp.logical_not(cost_lin <= cost_b)
            lam = jnp.where(worse, jnp.minimum(lam * 16.0, 1e6),
                            jnp.maximum(lam * 0.33, 1e-9))
            kf_keep = jax.tree_util.tree_map(
                lambda b_, c_: jnp.where(worse, b_, c_), kf_b, kf)
            pts_keep = jnp.where(worse, pts_b, pts)
            cost_keep = jnp.where(worse, cost_b, cost_lin)

            dxc = solve_reduced(Sm, bm, lam)
            acc = jnp.einsum("pkv,k->pv", W_p, dxc[:, :6].reshape(K * 6))
            dxl = jnp.einsum("pvw,pw->pv", Hll_inv, b_l - acc)
            kf_new = res.retract_kf(kf, dxc * pb0.kf_dof)
            pts_new = pts + dxl * pb0.pt_active[:, None]
            kf_next = jax.tree_util.tree_map(
                lambda b_, n_: jnp.where(worse, b_, n_), kf_b, kf_new)
            pts_next = jnp.where(worse, pts_b, pts_new)
            return ((kf_next, pts_next, kf_keep, pts_keep, cost_keep, lam),
                    (cost_keep, cost_lin))

        # NO standalone initial-cost pass: the best-cost carry starts at
        # +inf and iteration 1's linearize prices the initial state. This is
        # load-bearing beyond latency: the accept test must compare costs
        # from the SAME code path. A cost0 computed by the (differently
        # reduced) total_cost pass can sit an epsilon BELOW every linearize
        # cost at large obs counts, which rejects iteration 1, reverts to
        # the initial state, and then rejects FOREVER (cost_lin at the
        # reverted state keeps losing to the cross-path cost0) — measured
        # at O >= 12k: the solver returned cost == cost0 untouched.
        init = (pb0.kf, pb0.points, pb0.kf, pb0.points,
                jnp.float32(jnp.inf), jnp.float32(lambda0))
        (kf_t, pts_t, kf_b, pts_b, cost_b, _), (hist, hist_lin) = \
            jax.lax.scan(body, init, None, length=n_iters)
        cost0 = hist_lin[0]
        # the last tentative step was never evaluated: cost it once and
        # keep the better state
        cost_t = jax.lax.psum(total_cost_partial(kf_t, pts_t), axis)
        worse_t = jnp.logical_not(cost_t <= cost_b)  # NaN-robust
        kf_f = jax.tree_util.tree_map(
            lambda b_, t_: jnp.where(worse_t, b_, t_), kf_b, kf_t)
        pts_f = jnp.where(worse_t, pts_b, pts_t)
        cost = jnp.minimum(cost_t, cost_b)
        return kf_f, pts_f, cost0, cost, hist

    kf, pts, cost0, cost, hist = shard_map(
        run_local, mesh=mesh,
        in_specs=(in_specs,),
        out_specs=(jax.tree_util.tree_map(lambda _: rep, problem.kf),
                   pt_spec, rep, rep, rep),
        check_vma=False,
    )(problem)
    return kf, pts, {"cost0": cost0, "cost": cost, "cost_hist": hist}
