"""Basic image operations: grayscale, pyramid resize, Gaussian blur.

These feed the ORB frontend (replacement for the preprocessing
``cv::ORB`` performs internally before detection - pyramid construction and
the 7x7 sigma=2 Gaussian blur applied before BRIEF sampling).  Everything is
statically shaped: pyramid level sizes are Python ints derived from the
config, so XLA compiles one fixed program.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def rgb_to_gray(rgb: jnp.ndarray) -> jnp.ndarray:
    """uint8 RGB [H, W, 3] -> float32 grayscale [H, W] (ITU-R BT.601 luma,
    the same weighting cv::cvtColor uses for the images the reference feeds
    to ORB at ``src/frontend.cpp:153``)."""
    rgb = rgb.astype(jnp.float32)
    return (
        0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
    )


def pyramid_shapes(height: int, width: int, nlevels: int, scale: float):
    """Static (h, w) per level, level0 = full res (cv::ORB layout)."""
    shapes = []
    for lvl in range(nlevels):
        s = scale**lvl
        shapes.append((max(int(round(height / s)), 8), max(int(round(width / s)), 8)))
    return shapes


def resize_bilinear(img: jnp.ndarray, out_h: int, out_w: int) -> jnp.ndarray:
    """Bilinear resize [H, W] -> [out_h, out_w] with half-pixel centers."""
    return jax.image.resize(img, (out_h, out_w), method="bilinear")


def build_pyramid(gray: jnp.ndarray, nlevels: int, scale: float):
    """List of per-level images (static shapes)."""
    h, w = gray.shape
    shapes = pyramid_shapes(h, w, nlevels, scale)
    levels = [gray]
    for lh, lw in shapes[1:]:
        # resize from the previous level (cascade) - cheaper and slightly
        # smoother than always resizing from level 0
        levels.append(resize_bilinear(levels[-1], lh, lw))
    return levels


def _gaussian_kernel1d(ksize: int, sigma: float) -> np.ndarray:
    r = (ksize - 1) / 2
    x = np.arange(ksize) - r
    k = np.exp(-(x**2) / (2 * sigma**2))
    return (k / k.sum()).astype(np.float32)


@partial(jax.jit, static_argnums=(1, 2))
def gaussian_blur(img: jnp.ndarray, ksize: int = 7, sigma: float = 2.0) -> jnp.ndarray:
    """Separable Gaussian blur with edge padding (matches the 7x7 sigma=2
    blur cv::ORB applies before sampling BRIEF tests)."""
    k = jnp.asarray(_gaussian_kernel1d(ksize, sigma))
    r = ksize // 2
    p = jnp.pad(img, ((r, r), (0, 0)), mode="edge")
    rows = sum(k[i] * p[i : i + img.shape[0], :] for i in range(ksize))
    p = jnp.pad(rows, ((0, 0), (r, r)), mode="edge")
    return sum(k[i] * p[:, i : i + img.shape[1]] for i in range(ksize))


def sobel_gradients(img: jnp.ndarray):
    """3x3 Sobel dI/dx, dI/dy with edge padding (for the Harris score)."""
    p = jnp.pad(img, 1, mode="edge")

    def sh(dy, dx):
        return p[1 + dy : 1 + dy + img.shape[0], 1 + dx : 1 + dx + img.shape[1]]

    ix = (
        (sh(-1, 1) + 2 * sh(0, 1) + sh(1, 1))
        - (sh(-1, -1) + 2 * sh(0, -1) + sh(1, -1))
    )
    iy = (
        (sh(1, -1) + 2 * sh(1, 0) + sh(1, 1))
        - (sh(-1, -1) + 2 * sh(-1, 0) + sh(-1, 1))
    )
    return ix, iy


def box_sum(img: jnp.ndarray, ksize: int) -> jnp.ndarray:
    """ksize x ksize box-filter sum via separable shifted adds."""
    r = ksize // 2
    p = jnp.pad(img, ((r, r), (0, 0)))
    rows = sum(p[i : i + img.shape[0], :] for i in range(ksize))
    p = jnp.pad(rows, ((0, 0), (r, r)))
    return sum(p[:, i : i + img.shape[1]] for i in range(ksize))


def maxpool3x3(img: jnp.ndarray) -> jnp.ndarray:
    """3x3 max filter (for non-maximum suppression), -inf padded."""
    neg = jnp.asarray(-jnp.inf, img.dtype)
    p = jnp.pad(img, 1, constant_values=neg)
    out = img
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            out = jnp.maximum(
                out, p[1 + dy : 1 + dy + img.shape[0], 1 + dx : 1 + dx + img.shape[1]]
            )
    return out


def level_scales(nlevels: int, scale: float):
    return [scale**lvl for lvl in range(nlevels)]


def features_per_level(nfeatures: int, nlevels: int, scale: float):
    """Geometric distribution of the feature budget over pyramid levels,
    proportional to 1/scale^level and summing exactly to ``nfeatures``
    (the allocation cv::ORB uses for nfeatures=500 over 8 levels)."""
    f = 1.0 / scale
    ndesired = nfeatures * (1 - f) / (1 - f**nlevels)
    counts = []
    total = 0
    for lvl in range(nlevels - 1):
        c = int(round(ndesired * f**lvl))
        counts.append(c)
        total += c
    counts.append(max(nfeatures - total, 0))
    return counts
