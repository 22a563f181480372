"""Image-space ops: Gaussian blur + pyramid construction.

Analog of the reference's OpenCV image path
(ORBExtractor.cpp:559-570 builds the 8-level scale-1.2 pyramid with
cv::resize; descriptors are computed on a 7x7 sigma=2 GaussianBlur of each
level, ORBExtractor.cpp:495-547). Here both are XLA convs/resizes with
static shapes so the whole frontend fuses into one compiled program.
"""

from __future__ import annotations

import math
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np


@lru_cache(maxsize=None)
def _gaussian_kernel(ksize: int, sigma: float):
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    return k.astype(np.float32)  # numpy: jnp constants must not be cached across traces


def gaussian_blur(img: jnp.ndarray, ksize: int = 7, sigma: float = 2.0) -> jnp.ndarray:
    """Separable Gaussian blur of a single-channel [H, W] image (SAME padding,
    edge-replicated like cv::BORDER_REFLECT_101 approximately)."""
    k = jnp.asarray(_gaussian_kernel(ksize, sigma))
    r = ksize // 2
    x = img[None, None]  # NCHW
    x = jnp.pad(x, ((0, 0), (0, 0), (r, r), (r, r)), mode="reflect")
    kv = k.reshape(1, 1, ksize, 1)
    kh = k.reshape(1, 1, 1, ksize)
    x = jax.lax.conv_general_dilated(x, kv, (1, 1), "VALID")
    x = jax.lax.conv_general_dilated(x, kh, (1, 1), "VALID")
    return x[0, 0]


def pyramid_shapes(height: int, width: int, n_levels: int, scale: float):
    """Static per-level (h, w) list, truncating like cv::resize round()."""
    shapes = []
    for lvl in range(n_levels):
        s = 1.0 / (scale**lvl)
        shapes.append((max(16, int(round(height * s))), max(16, int(round(width * s)))))
    return shapes


def build_pyramid(img: jnp.ndarray, n_levels: int = 8, scale: float = 1.2):
    """[H, W] float32 -> list of per-level images, each resized from the
    previous level (matching the reference's iterative INTER_LINEAR resize)."""
    h, w = img.shape
    shapes = pyramid_shapes(h, w, n_levels, scale)
    levels = [img]
    for lvl in range(1, n_levels):
        prev = levels[-1]
        levels.append(jax.image.resize(prev, shapes[lvl], method="linear"))
    return levels
