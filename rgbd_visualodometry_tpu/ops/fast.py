"""FAST-9/16 corner detection + Harris response, fully vectorized.

Data-parallel replacement for the detector inside ``cv::ORB`` (reference
``src/frontend.cpp:35-37,153``).  Instead of the per-pixel branchy C scan
OpenCV uses, the whole image is tested at once: the 16 circle pixels become
16 statically-shifted views of the padded image, and the segment test
("9 contiguous of 16 all brighter/darker than center +- t") becomes a max
over 16 windowed minima - pure elementwise work with no data-dependent
control flow, which XLA fuses into one loop kernel.

The returned score is the classic FAST score: the largest threshold at which
the pixel would still be a corner, ``max over arcs of (min over the 9-arc of
|I_ring - I_p|)``.  Harris responses (used by cv::ORB for ranking, via
``HARRIS_SCORE``) are computed with Sobel gradients and a 7x7 block sum.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from rgbd_visualodometry_tpu.ops import image as im

# Bresenham circle of radius 3 in circular order, (dy, dx)
_CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3),
    (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3),
    (0, -3), (-1, -3), (-2, -2), (-3, -1),
)
ARC_LENGTH = 9  # the "9" in FAST-9/16


def fast_score(gray: jnp.ndarray) -> jnp.ndarray:
    """Per-pixel FAST-9 corner score (0 where not a corner at t=0).

    ``gray`` is float32 [H, W].  Returns float32 [H, W]; a pixel is a FAST
    corner at threshold t iff ``score > t``.
    """
    h, w = gray.shape
    p = jnp.pad(gray, 3, mode="edge")
    # ring differences as a PLAIN LIST of [H, W] planes.  Never jnp.stack
    # them: a stacked [16/24, H, W] tensor is materialized in device memory
    # between the window reductions, while a list of 2-D planes keeps the
    # whole computation one fused elementwise kernel (read image once,
    # write score once).
    d = [p[3 + dy : 3 + dy + h, 3 + dx : 3 + dx + w] - gray for dy, dx in _CIRCLE]
    doubled = d + d[: ARC_LENGTH - 1]  # 24 planes (list concat, not concatenate)

    # sliding-window min/max over all 16 arcs of length 9 via a log-step
    # tree (width 2 -> 4 -> 8 -> 9), same numerics as 16 x 9 pairwise
    def window9(x, op):
        m2 = [op(x[i], x[i + 1]) for i in range(len(x) - 1)]
        m4 = [op(m2[i], m2[i + 2]) for i in range(len(m2) - 2)]
        m8 = [op(m4[i], m4[i + 4]) for i in range(len(m4) - 4)]
        return [op(m8[i], x[i + 8]) for i in range(16)]

    arc_min = window9(doubled, jnp.minimum)
    arc_max = window9(doubled, jnp.maximum)
    bright = functools.reduce(jnp.maximum, arc_min)  # best all-brighter arc
    dark = functools.reduce(jnp.maximum, [-x for x in arc_max])  # all-darker
    return jnp.maximum(jnp.maximum(bright, dark), 0.0)


def harris_response(gray: jnp.ndarray, block: int = 7, k: float = 0.04) -> jnp.ndarray:
    """Harris corner response (cv::ORB HarrisResponses uses blockSize=7,
    k=0.04 for ranking keypoints)."""
    ix, iy = im.sobel_gradients(gray)
    sxx = im.box_sum(ix * ix, block)
    syy = im.box_sum(iy * iy, block)
    sxy = im.box_sum(ix * iy, block)
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    # normalization keeps magnitudes in a sane f32 range (Sobel+box sums grow
    # as 255^2 * 16 * 49); relative ranking is what matters
    return (det - k * tr * tr) * (1.0 / (255.0**4))


def detect_level(gray: jnp.ndarray, threshold: float, border: int, topk: int):
    """Detect up to ``topk`` FAST corners, Harris-ranked, on one level.

    Returns ``(xy int32 [topk, 2] in (x, y) order, response f32 [topk],
    valid bool [topk])``.  Static output shapes: missing detections are
    masked out, never dropped (the key XLA design constraint - see
    SURVEY.md section 7 hard part #1).
    """
    h, w = gray.shape
    score = fast_score(gray)
    is_corner = score > threshold
    # 3x3 non-maximum suppression on the FAST score
    nms = score >= im.maxpool3x3(score)
    mask = is_corner & nms

    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    in_border = (
        (ys >= border) & (ys < h - border) & (xs >= border) & (xs < w - border)
    )
    mask = mask & in_border

    harris = harris_response(gray)
    neg = jnp.asarray(-jnp.inf, gray.dtype)
    ranked = jnp.where(mask, harris, neg).reshape(-1)
    vals, idx = jax.lax.top_k(ranked, topk)
    valid = vals > neg
    y = idx // w
    x = idx % w
    xy = jnp.stack([x, y], axis=-1).astype(jnp.int32)
    return xy, vals, valid
