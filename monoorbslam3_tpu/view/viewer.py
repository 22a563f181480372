"""Live viewer thread — the reference Viewer, headless.

Analog of the reference's Pangolin render thread
(modules/View/Viewer.cpp:13-197): a daemon thread that wakes at the
viewer fps, snapshots the latest tracked frame (FrameDrawer::Update,
FrameDrawer.cpp:111-139) and the map, renders both with the offline
drawers, and writes PNGs into an output directory (a headless runtime
has no GL window; the artifact stream is the live view). Reproduces the
reference's control protocol:

- `update_frame`                      <- FrameDrawer::Update (mutex snapshot)
- `request_stop` / `is_stopped` / `release` <- the reset handshake
  (Viewer.cpp:165-196; Tracking::reset parks the viewer while the map is
  cleared)
- `request_finish` / `is_finished`    <- System::ShutDown (Viewer.cpp:146-163)
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np

from .visualizer import draw_frame, draw_map


class Viewer:
    def __init__(self, store, calib, out_dir: str, fps: float = 2.0,
                 map_every: int = 5):
        self.store = store
        self.calib = calib
        self.out_dir = out_dir
        self.period = 1.0 / max(fps, 0.1)
        self.map_every = max(1, map_every)
        os.makedirs(out_dir, exist_ok=True)

        self._lock = threading.Lock()
        self._snapshot = None  # (image, xy, tracked, text)
        self._dirty = False
        self._stop_requested = False
        self._stopped = False
        self._finish_requested = False
        self._finished = False
        self._n_rendered = 0
        self.last_error: Exception | None = None
        self._thread = threading.Thread(target=self.run, daemon=True)
        self._thread.start()

    # -- FrameDrawer::Update analog --------------------------------------

    def update_frame(self, image, xy, tracked, state_text: str = ""):
        with self._lock:
            self._snapshot = (
                None if image is None else np.asarray(image),
                np.asarray(xy).copy(), np.asarray(tracked).copy(), state_text,
            )
            self._dirty = True

    # -- render loop (Viewer::Run) ----------------------------------------

    def run(self):
        while not self._finish_requested:
            t0 = time.time()
            if self._stop_requested:
                self._stopped = True
                time.sleep(0.005)
                continue
            self._stopped = False
            snap = None
            with self._lock:
                if self._dirty:
                    snap = self._snapshot
                    self._dirty = False
            if snap is not None:
                self._render(snap)
            dt = time.time() - t0
            time.sleep(max(self.period - dt, 0.002))
        self._finished = True

    def _render(self, snap):
        image, xy, tracked, text = snap
        i = self._n_rendered
        try:
            if image is not None:
                fig = draw_frame(image, xy, tracked, text)
                fig.savefig(os.path.join(self.out_dir, f"frame_{i:06d}.png"))
                _close(fig)
            if i % self.map_every == 0 and self.store.n_keyframes() >= 2:
                fig = draw_map(self.store, self.calib)
                fig.savefig(os.path.join(self.out_dir, f"map_{i:06d}.png"))
                _close(fig)
        except Exception as e:  # noqa: BLE001
            # rendering must never take down the pipeline (the reference's
            # GL thread can't either); drop the frame but keep the error
            # inspectable
            self.last_error = e
        # increment LAST: callers poll _n_rendered as "files are on disk"
        self._n_rendered = i + 1

    # -- stop/release handshake (reset) -----------------------------------

    def request_stop(self):
        self._stop_requested = True

    def is_stopped(self) -> bool:
        return self._stopped

    def release(self):
        self._stop_requested = False

    # -- finish handshake (shutdown) ---------------------------------------

    def request_finish(self):
        self._finish_requested = True

    def is_finished(self) -> bool:
        return self._finished

    def join(self, timeout: float = 5.0):
        self.request_finish()
        self._thread.join(timeout=timeout)


def _close(fig):
    import matplotlib.pyplot as plt

    plt.close(fig)
