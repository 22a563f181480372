"""Offline visualization — the reference View layer, Pangolin-free.

The reference renders live via a Pangolin GL thread (modules/View/
Viewer.cpp, MapDrawer.cpp, FrameDrawer.cpp); for a headless runtime
the equivalent is offline artifact rendering (SURVEY.md §7 stage 8):

- `draw_frame`  <- FrameDrawer::DrawFrame (keypoint boxes + status text)
- `draw_map`    <- MapDrawer (map points, keyframe frusta, covisibility)
- `draw_trajectory` -> 2D truth-vs-estimate plot (evaluation/plot_*.py)

All functions return matplotlib figures (callers save PNGs); matplotlib is
imported lazily so the runtime has no hard dependency on it.
"""

from __future__ import annotations

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def draw_frame(image: np.ndarray, xy: np.ndarray, tracked: np.ndarray,
               state_text: str = ""):
    """Keypoint overlay: green boxes for tracked features, blue for
    untracked (FrameDrawer.cpp:17-109)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(9, 6))
    ax.imshow(image, cmap="gray", vmin=0, vmax=255)
    unt = ~tracked
    ax.scatter(xy[unt, 0], xy[unt, 1], s=12, facecolors="none",
               edgecolors="tab:blue", linewidths=0.8, label="detected")
    ax.scatter(xy[tracked, 0], xy[tracked, 1], s=14, facecolors="none",
               edgecolors="tab:green", linewidths=1.0, label="tracked")
    ax.set_title(state_text)
    ax.legend(loc="upper right")
    ax.set_axis_off()
    fig.tight_layout()
    return fig


def draw_map(store, calib, show_covisibility: bool = True):
    """Top-down map view: points, keyframe frusta directions, covisibility
    edges (MapDrawer.cpp)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 8))
    pts = store.pt_xyz[store.pt_valid]
    ax.scatter(pts[:, 0], pts[:, 1], s=2, c="k", alpha=0.4, label="map points")
    ids = store.keyframe_ids()
    R_cb = np.asarray(calib.R_cb)
    t_cb = np.asarray(calib.t_cb)
    centers = []
    for k in ids:
        R_cw, t_cw = store.kf_pose_cw(k, R_cb, t_cb)
        C = -R_cw.T @ t_cw
        z = R_cw.T[:, 2]  # viewing direction
        centers.append(C)
        ax.plot([C[0], C[0] + 0.3 * z[0]], [C[1], C[1] + 0.3 * z[1]],
                c="tab:red", lw=0.8)
    centers = np.asarray(centers)
    if len(centers):
        ax.plot(centers[:, 0], centers[:, 1], c="tab:blue", lw=1.2,
                label="keyframes")
    if show_covisibility and len(ids) > 1:
        for k in ids:
            i = ids.index(k)
            for j in store.covisible_keyframes(k, top=5):
                if j in ids:
                    jj = ids.index(j)
                    ax.plot(centers[[i, jj], 0], centers[[i, jj], 1],
                            c="tab:green", lw=0.3, alpha=0.5)
    ax.set_aspect("equal")
    ax.legend(loc="best")
    fig.tight_layout()
    return fig


def draw_trajectory(t_est, p_est, t_gt=None, p_gt=None, aligned=None,
                    title="trajectory"):
    """Truth vs estimate 2D plot (evaluation/plot_results.py:26-40)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 8))
    p_est = np.asarray(p_est)
    src = aligned if aligned is not None else p_est
    ax.plot(src[:, 0], src[:, 1], c="tab:blue", lw=1.2, label="ours")
    if p_gt is not None:
        p_gt = np.asarray(p_gt)
        ax.plot(p_gt[:, 0], p_gt[:, 1], c="k", lw=1.0, ls="--", label="truth")
    ax.set_aspect("equal")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_title(title)
    ax.legend()
    fig.tight_layout()
    return fig
