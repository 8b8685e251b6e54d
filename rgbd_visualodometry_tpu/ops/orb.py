"""ORB feature extraction: pyramid -> FAST-9 -> Harris top-K -> intensity
centroid orientation -> rotated BRIEF, all in one statically-shaped jitted
program.

Data-parallel replacement for ``cv::ORB::create(nfeatures, scaleFactor,
nlevels).detectAndCompute`` (reference ``src/frontend.cpp:35-37,150-154``).
Design differences forced (and enabled) by static-shape XLA programs:

- Fixed feature budget: every level yields exactly ``K_l`` slots (geometric
  allocation like cv::ORB) with a validity mask - variable keypoint counts
  become masked lanes, never dynamic shapes.
- The descriptor pattern is a seeded Gaussian BRIEF pattern (BRIEF paper
  distribution) rather than OpenCV's learned table; descriptors only ever
  match against descriptors produced by this module, so self-consistency is
  what matters (SURVEY.md section 7 hard part #1 discussion).
- Pattern rotation is quantized to ``angle_bins`` steps (the original ORB
  paper used 30 = 12-degree steps), which lets the BRIEF
  comparisons for every bin be precomputed as one signed-difference matmul
  (see ``_brief_diff_table``) - the descriptor path has no per-element
  gathers.  The
  default of 120 bins (3 degrees, matching ``VOConfig.orb_angle_bins``)
  puts the binning error (~0.34 px = r_max * dtheta/2) below the sampler's
  own integer-offset rounding; measured 240-frame ATE saturates there
  (90 bins 0.83 cm -> 120 bins 0.73 cm, see config.py).
- Descriptors are emitted twice: packed ``uint32[8]`` (storage, 256 bits)
  and bipolar ``int8[256]`` (so Hamming matching runs as an int8 matmul -
  see :mod:`rgbd_visualodometry_tpu.ops.matching`).

Matmul numerics: the one-hot column select and the orientation moments run
f32 at ``Precision.HIGHEST`` (exact selection, no TF32); the BRIEF
diff-table matmul runs bf16 by design on accelerators (``use_bf16``), and
so does the column select under ``patch_bf16``.  On the CPU backend both
stay f32, for two reasons: the CPU test suite's oracles (OpenCV, numpy) are
f32, and XLA:CPU's dot thunk refuses the BRIEF matmul's bf16 x bf16 -> f32
("Unsupported element type for DotThunk", JAX 0.9.0).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from rgbd_visualodometry_tpu.ops import fast
from rgbd_visualodometry_tpu.ops import image as im

PATCH = 33  # sampling patch (31 active + 1 px bilinear/rounding margin)
PATCH_R = PATCH // 2  # 16
ORIENT_R = 15  # intensity-centroid radius (cv::ORB HALF_PATCH_SIZE)
PATTERN_R = 13  # max BRIEF offset norm, so rotated samples stay in PATCH
N_BITS = 256


def _make_brief_pattern(n_bits: int = N_BITS, seed: int = 20240216) -> np.ndarray:
    """[n_bits, 2, 2] float32 (pair, point, (x, y)) sampling offsets.

    Coordinates drawn from N(0, (31/5)^2) as in the BRIEF paper, rejection-
    clipped to a disc of radius PATTERN_R so any in-plane rotation keeps the
    samples inside the patch.
    """
    rng = np.random.RandomState(seed)
    pts = np.empty((n_bits * 2, 2), np.float32)
    count = 0
    while count < n_bits * 2:
        cand = rng.normal(0.0, 31.0 / 5.0, size=(n_bits * 4, 2))
        ok = np.linalg.norm(cand, axis=1) <= PATTERN_R
        cand = cand[ok]
        take = min(len(cand), n_bits * 2 - count)
        pts[count : count + take] = cand[:take]
        count += take
    return pts.reshape(n_bits, 2, 2).astype(np.float32)


BRIEF_PATTERN = _make_brief_pattern()

# circular mask + coordinate grids for the intensity centroid, on the
# full sampling patch (only radius <= ORIENT_R participates)
_dy, _dx = np.mgrid[-PATCH_R:PATCH_R + 1, -PATCH_R:PATCH_R + 1]
_CIRC_MASK = (_dy**2 + _dx**2 <= ORIENT_R**2).astype(np.float32)
_CX = (_dx * _CIRC_MASK).astype(np.float32)
_CY = (_dy * _CIRC_MASK).astype(np.float32)


class ORBFeatures(NamedTuple):
    """One frame's fixed-size keypoint set (the ``keypointsCurr_`` /
    ``descriptorsCurr_`` pair of ``include/myslam/frontend.h``)."""

    xy: jnp.ndarray  # [N, 2] float32, level-0 pixel coords (x, y)
    response: jnp.ndarray  # [N] float32 (Harris)
    angle: jnp.ndarray  # [N] float32 radians
    octave: jnp.ndarray  # [N] int32 pyramid level
    size: jnp.ndarray  # [N] float32 patch diameter at level 0
    valid: jnp.ndarray  # [N] bool
    desc: jnp.ndarray  # [N, 8] uint32 packed 256-bit descriptors
    desc_bipolar: jnp.ndarray  # [N, 256] int8 in {-1, +1}

    @property
    def n(self) -> int:
        return self.xy.shape[0]


def _extract_patches(img: jnp.ndarray, xy: jnp.ndarray) -> jnp.ndarray:
    """Gather [K, PATCH, PATCH] patches centered at integer coords xy.

    ONE flat gather over the linearized padded image: precomputed linear
    indices ``(y + dy) * pw + (x + dx)`` feed a single ``take``.  The
    earlier two-stage form (full-row gather then ``take_along_axis`` per
    row) materialized a [K, PATCH, pw] intermediate - ~8 MB per level -
    and lowered to two serialized gathers.
    """
    padded = jnp.pad(img, PATCH_R, mode="edge")
    pw = padded.shape[1]
    dy = jnp.arange(PATCH, dtype=jnp.int32)
    lin = (
        (xy[:, 1:2, None] + dy[None, :, None]) * pw
        + xy[:, 0:1, None]
        + dy[None, None, :]
    )  # [K, PATCH, PATCH]; top-left = (y, x) in padded coords
    k = xy.shape[0]
    return jnp.take(padded.reshape(-1), lin.reshape(k, -1)).reshape(k, PATCH, PATCH)


def _orientations(patches: jnp.ndarray) -> jnp.ndarray:
    """Intensity-centroid angle per patch (cv::ORB IC_Angle)."""
    m10 = jnp.sum(patches * jnp.asarray(_CX), axis=(-2, -1))
    m01 = jnp.sum(patches * jnp.asarray(_CY), axis=(-2, -1))
    return jnp.arctan2(m01, m10)


def _brief_offsets(angles: jnp.ndarray):
    """Rotated, clipped integer BRIEF sample offsets: [K, 256, 2] each for
    (dx, dy), in [-PATCH_R, PATCH_R] (cv::ORB clips samples to the patch)."""
    pat = jnp.asarray(BRIEF_PATTERN)  # [256, 2, 2] (x, y)
    c, s = jnp.cos(angles), jnp.sin(angles)  # [K]
    px, py = pat[..., 0], pat[..., 1]  # [256, 2]
    rx = c[:, None, None] * px - s[:, None, None] * py
    ry = s[:, None, None] * px + c[:, None, None] * py
    ox = jnp.clip(jnp.round(rx).astype(jnp.int32), -PATCH_R, PATCH_R)
    oy = jnp.clip(jnp.round(ry).astype(jnp.int32), -PATCH_R, PATCH_R)
    return ox, oy


def _pack_bits(bits: jnp.ndarray):
    """[K, 256] uint32 bits -> (packed uint32 [K, 8], bipolar int8 [K, 256])."""
    shifts = jnp.left_shift(jnp.uint32(1), jnp.arange(32, dtype=jnp.uint32))
    packed = jnp.sum(bits.reshape(bits.shape[0], 8, 32) * shifts, axis=-1, dtype=jnp.uint32)
    bipolar = (bits.astype(jnp.int8) * 2 - 1).astype(jnp.int8)
    return packed, bipolar


def _descriptors(patches: jnp.ndarray, angles: jnp.ndarray):
    """Steered BRIEF over blurred patches.

    patches: [K, PATCH, PATCH] (already Gaussian-blurred),
    angles: [K]. Returns (packed uint32 [K, 8], bipolar int8 [K, 256]).
    """
    ox, oy = _brief_offsets(angles)
    ix, iy = ox + PATCH_R, oy + PATCH_R
    flat = patches.reshape(patches.shape[0], -1)  # [K, PATCH*PATCH]
    lin = iy * PATCH + ix  # [K, 256, 2]
    vals = jnp.take_along_axis(flat[:, None, :], lin.reshape(lin.shape[0], -1)[:, None, :], axis=-1)
    vals = vals.reshape(lin.shape)  # [K, 256, 2]
    bits = (vals[..., 0] < vals[..., 1]).astype(jnp.uint32)  # [K, 256]
    return _pack_bits(bits)


def _brief_diff_table(angle_bins: int) -> np.ndarray:
    """[PATCH*PATCH, angle_bins*256] int8 signed difference table.

    Column ``q*256 + s`` holds ``e_{p1} - e_{p0}`` for BRIEF test ``s``
    rotated by bin angle ``2*pi*q/angle_bins`` (offsets rounded and clipped
    exactly like the per-keypoint sampler).  ``patch_flat @ table > 0``
    then reproduces every test's comparison for every bin at once in one
    matmul - no per-element gathers.  cv::ORB itself quantizes the pattern
    rotation (12-degree steps); ``angle_bins=30`` mirrors that.
    """
    pat = BRIEF_PATTERN  # [256, 2, 2] (x, y)
    px, py = pat[..., 0], pat[..., 1]  # [256, 2]
    table = np.zeros((PATCH * PATCH, angle_bins * N_BITS), np.int8)
    for q in range(angle_bins):
        th = 2.0 * np.pi * q / angle_bins
        c, s = np.cos(th), np.sin(th)
        rx = np.clip(np.round(c * px - s * py).astype(np.int64), -PATCH_R, PATCH_R)
        ry = np.clip(np.round(s * px + c * py).astype(np.int64), -PATCH_R, PATCH_R)
        lin = (ry + PATCH_R) * PATCH + (rx + PATCH_R)  # [256, 2]
        cols = q * N_BITS + np.arange(N_BITS)
        # bit s is 1 iff patch[p0] < patch[p1]  <=>  patch @ (e_p1 - e_p0) > 0
        np.add.at(table, (lin[:, 1], cols), 1)
        np.add.at(table, (lin[:, 0], cols), -1)
    return table


_DIFF_TABLES: dict[int, np.ndarray] = {}


def _descriptors_from_image(blurred: jnp.ndarray, xy: jnp.ndarray, angles: jnp.ndarray):
    """Steered BRIEF sampled DIRECTLY from the blurred level image.

    Numerically identical to extracting a [K, PATCH, PATCH] blurred patch
    and indexing it (``patch[r + oy, r + ox] == padded[y + r + oy,
    x + r + ox]``) but skips the 1000-row patch gather: one flat [K, 512]
    gather replaces a [K, 961] gather plus per-row ``take_along_axis``.
    """
    ox, oy = _brief_offsets(angles)
    padded = jnp.pad(blurred, PATCH_R, mode="edge")
    pw = padded.shape[1]
    base_y = xy[:, 1:2, None] + PATCH_R
    base_x = xy[:, 0:1, None] + PATCH_R
    lin = (base_y + oy) * pw + base_x + ox  # [K, 256, 2]
    k = xy.shape[0]
    vals = jnp.take(padded.reshape(-1), lin.reshape(k, -1)).reshape(lin.shape)
    bits = (vals[..., 0] < vals[..., 1]).astype(jnp.uint32)
    return _pack_bits(bits)


@partial(
    jax.jit,
    static_argnames=(
        "nfeatures", "nlevels", "scale", "threshold", "border", "angle_bins",
        "use_bf16", "brief_chunk", "patch_bf16",
    ),
)
def extract(
    gray: jnp.ndarray,
    nfeatures: int = 500,
    nlevels: int = 8,
    scale: float = 1.2,
    threshold: float = 20.0,
    border: int = 31,
    angle_bins: int = 120,
    use_bf16: bool = True,
    brief_chunk: int = 6,
    patch_bf16: bool = False,
) -> ORBFeatures:
    """Full ORB extraction on a float32 grayscale image [H, W].

    One compiled program covers all pyramid levels (static Python loop);
    output arrays always have exactly ``nfeatures`` rows with a validity
    mask.  Equivalent of ``orb_->detectAndCompute`` at
    ``src/frontend.cpp:150-154``.
    """
    pyr = im.build_pyramid(gray, nlevels, scale)
    quotas = im.features_per_level(nfeatures, nlevels, scale)
    scales = im.level_scales(nlevels, scale)

    # Phase 1: per-level detection (fused elementwise + one top_k each).
    dets = []  # (lvl, sc, quota, xy, resp, valid)
    for lvl, (img, quota, sc) in enumerate(zip(pyr, quotas, scales)):
        if quota == 0:
            continue
        # shrink the border on tiny levels so they can still contribute
        h, w = img.shape
        b = min(border, max((min(h, w) - 2 * PATCH_R - 2) // 2, PATCH_R + 1))
        xy, resp, valid = fast.detect_level(img, threshold, b, quota)
        dets.append((lvl, sc, quota, xy, resp, valid))

    # Phase 2: patch sampling WITHOUT per-element gathers (the per-keypoint
    # patch + BRIEF sampling is 500 x 961 + 500 x 512 elements per frame).
    # Instead:
    #   1. every level is padded onto a common [ph0, pw0] canvas (raw and
    #      blurred stacked), so keypoint rows live in one 3-D array;
    #   2. patch ROWS are fetched with a contiguous row-take (vectorizes),
    #      and the column window is cut with a batched one-hot matmul;
    #   3. the intensity-centroid moments are a [N, PATCH^2] @ [PATCH^2, 2]
    #      matmul;
    #   4. BRIEF comparisons for ALL angle bins are one
    #      [N, PATCH^2] @ [PATCH^2, Q*256] signed-difference matmul, and
    #      the keypoint's bin is picked with a one-hot multiply - cv::ORB
    #      itself quantizes pattern rotation to 12-degree steps, so
    #      angle_bins=30 reproduces OpenCV semantics.
    if angle_bins not in _DIFF_TABLES:
        full_table = _brief_diff_table(angle_bins)
        # the BRIEF pattern lives in a disc of radius PATTERN_R (+rounding),
        # so ~45% of the 33x33 patch rows are all-zero in the table - drop
        # them from the matmul (the row subset is data-derived and exact)
        rows = np.where(np.any(full_table != 0, axis=1))[0].astype(np.int32)
        _DIFF_TABLES[angle_bins] = (full_table[rows], rows)
    _tbl, _tbl_rows = _DIFF_TABLES[angle_bins]
    diff_table = jnp.asarray(_tbl)
    diff_rows = jnp.asarray(_tbl_rows)

    ph0 = pyr[0].shape[0] + 2 * PATCH_R
    pw0 = pyr[0].shape[1] + 2 * PATCH_R
    canvases = []
    canvas_slot = {}
    for lvl, (img, quota) in enumerate(zip(pyr, quotas)):
        if quota == 0:
            continue
        padded = jnp.pad(img, PATCH_R, mode="edge")
        blurred_p = jnp.pad(im.gaussian_blur(img, 7, 2.0), PATCH_R, mode="edge")
        h, w = padded.shape
        canvas_slot[lvl] = len(canvases) // 2  # level's block pair index
        canvases.append(jnp.pad(padded, ((0, ph0 - h), (0, pw0 - w))))
        canvases.append(jnp.pad(blurred_p, ((0, ph0 - h), (0, pw0 - w))))
    # [2L * ph0, pw0]: raw canvas of level l at slot 2l, blurred at 2l+1.
    # bf16 canvas (config orb_patch_bf16) halves the row-take + column-
    # select memory traffic - the largest per-frame intermediate; pixel
    # values lose <1 gray level (same order as the sampler's 0.5 px
    # rounding), and all downstream reductions accumulate f32.  Like
    # orb_bf16 it applies off the CPU backend only (module docstring).
    pt = (
        jnp.bfloat16
        if (patch_bf16 and jax.default_backend() != "cpu")
        else jnp.float32
    )
    canvas = jnp.concatenate(canvases, axis=0).astype(pt)

    xy_all = jnp.concatenate([d[3] for d in dets], axis=0)  # [N, 2] int32
    slot_all = jnp.concatenate(
        [jnp.full(d[2], canvas_slot[d[0]], jnp.int32) for d in dets]
    )
    n_all = xy_all.shape[0]

    # rows for raw and blurred patches: [N, 2, PATCH] row indices into canvas
    dy = jnp.arange(PATCH, dtype=jnp.int32)
    row_raw = (2 * slot_all)[:, None] * ph0 + xy_all[:, 1:2] + dy[None, :]
    row_blur = row_raw + ph0
    rows_idx = jnp.concatenate([row_raw, row_blur], axis=1)  # [N, 2*PATCH]
    rows = jnp.take(canvas, rows_idx.reshape(-1), axis=0).reshape(
        n_all, 2 * PATCH, pw0
    )
    # column window via batched one-hot matmul (contract over pw0)
    col_idx = xy_all[:, 0:1] + dy[None, :]  # [N, PATCH]
    colsel = (col_idx[:, None, :] == jnp.arange(pw0)[None, :, None]).astype(
        pt
    )  # [N, pw0, PATCH]; one-hot is exact in bf16
    patches2 = jax.lax.dot_general(
        rows, colsel,
        dimension_numbers=(((2,), (1,)), ((0,), (0,))),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )  # [N, 2*PATCH, PATCH]
    raw_flat = patches2[:, :PATCH, :].reshape(n_all, PATCH * PATCH)
    blur_flat = patches2[:, PATCH:, :].reshape(n_all, PATCH * PATCH)

    # orientation: centroid moments as one matmul
    cxy = jnp.stack(
        [jnp.asarray(_CX).reshape(-1), jnp.asarray(_CY).reshape(-1)], axis=1
    )  # [PATCH^2, 2]
    m = jnp.matmul(raw_flat, cxy, precision=jax.lax.Precision.HIGHEST)  # [N, 2]
    angle = jnp.arctan2(m[:, 1], m[:, 0])

    # BRIEF: all bins at once, then one-hot bin select.  bf16 operands BY
    # DESIGN, with f32 accumulation: blurred pixel values fit bf16's 8-bit
    # significand to within half a gray level - the same magnitude as the
    # sampler's own 0.5 px offset rounding - and the matmul is the biggest
    # FLOP block of the whole frontend ([N, 33^2] @ [33^2, Q*256]).  The
    # CPU backend keeps f32 (module docstring: the CPU suite's oracles, and
    # XLA:CPU's dot thunk refuses this bf16 dot); ``use_bf16=False``
    # (config ``orb_bf16``) forces f32 on the
    # accelerator too, so the CPU-tested numerics can be reproduced there
    # and the bf16 delta bounded (``chip_smoke.py``, kernel phase).
    bt = (
        jnp.bfloat16
        if (use_bf16 and jax.default_backend() != "cpu")
        else jnp.float32
    )
    blur_disc = jnp.take(blur_flat, diff_rows, axis=1).astype(bt)
    qbin = (
        jnp.floor(angle * (angle_bins / (2.0 * jnp.pi)) + 0.5).astype(jnp.int32)
        % angle_bins
    )
    # chunk the per-bin matmul + bin select so the [N, Q, 256] comparison
    # tensor is never materialized whole (at 64 batched streams it would be
    # ~3 GB of device memory); each chunk's slab dies after its masked
    # reduction.  Single-stream runs have headroom - larger chunks mean fewer,
    # bigger matmuls (config orb_brief_chunk).
    chunk = brief_chunk
    bits_acc = jnp.zeros((n_all, N_BITS), jnp.float32)
    for q0 in range(0, angle_bins, chunk):
        qn = min(chunk, angle_bins - q0)
        d = jax.lax.dot_general(
            blur_disc, diff_table[:, q0 * N_BITS : (q0 + qn) * N_BITS].astype(bt),
            dimension_numbers=(((1,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32,
        ).reshape(n_all, qn, N_BITS)
        sel = (
            (qbin[:, None] >= q0) & (qbin[:, None] < q0 + qn)
            & (qbin[:, None] - q0 == jnp.arange(qn)[None, :])
        ).astype(jnp.float32)
        bits_acc = bits_acc + jnp.sum(
            (d > 0).astype(jnp.float32) * sel[:, :, None], axis=1
        )
    bits = (bits_acc > 0.5).astype(jnp.uint32)
    packed, bipolar = _pack_bits(bits)

    merged = ORBFeatures(
        xy=xy_all.astype(jnp.float32)
        * jnp.concatenate([jnp.full(d[2], d[1], jnp.float32) for d in dets])[:, None],
        response=jnp.concatenate([d[4] for d in dets]),
        angle=angle,
        octave=jnp.concatenate([jnp.full(d[2], d[0], jnp.int32) for d in dets]),
        size=jnp.concatenate(
            [jnp.full(d[2], 31.0 * d[1], jnp.float32) for d in dets]
        ),
        valid=jnp.concatenate([d[5] for d in dets]),
        desc=packed,
        desc_bipolar=bipolar,
    )
    # zero out invalid lanes so downstream masked math sees benign values
    v = merged.valid
    return merged._replace(
        xy=jnp.where(v[:, None], merged.xy, 0.0),
        response=jnp.where(v, merged.response, -jnp.inf),
        desc_bipolar=jnp.where(v[:, None], merged.desc_bipolar, 0).astype(jnp.int8),
    )
