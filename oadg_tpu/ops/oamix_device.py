"""OA-Mix as fused on-device XLA kernels (the device rewrite of reference
mmdet/datasets/pipelines/oa_mix.py + bbox_augmentation.py + augmix.py).

The reference runs, per sample, on CPU: random multi-level boxes with
Gaussian-blurred masks, per-GT spectral-residual saliency, a
width x depth AugMix chain where each step applies a randomly chosen op
(4 PIL LUT ops + 3 per-box geometric ops + 3 background geometric ops)
region-masked, Dirichlet mixing, then object-aware mixing with
saliency-gated coefficients (SURVEY.md §2.1 row "OAMix pipeline op").

On-device redesign (all static shapes, scanned over the batch):

1. **Closed-form blurred masks.** The reference builds a box indicator at
   1/4 resolution, GaussianBlurs it with sigma = side*sigma_ratio*2/3, and
   bilinearly resizes back (oa_mix.py:74-93). A Gaussian-blurred box is
   separable and analytic: ``0.5*(erf((x-x1)/(s*sqrt(2))) - erf((x-x2)/(s*sqrt(2))))``
   per axis with the full-res sigma ``side*sigma_ratio*2/3`` — evaluated
   directly at every pixel. No conv, no resize, no dynamic kernel sizes.

2. **One-pass per-box warps.** ``bboxes_only_*`` sequentially warps the
   whole image once per GT box and blends inside each blurred mask
   (bbox_augmentation.py:31-88). Here every pixel is assigned to its
   strongest box (argmax of the analytic masks, accumulated in a fori_loop
   — nothing of shape (G,H,W) is materialized), per-pixel inverse-affine
   parameters are gathered from the (G,6) matrix table, and a single
   bilinear gather produces all per-box warps at once. Divergence from the
   reference only where box masks overlap (sequential blend becomes
   coverage-weighted) — documented, tolerance-level.

3. **Unified op dispatch.** Each chain step computes the cheap LUT
   candidates (autocontrast/equalize/posterize/solarize[+invert/enhance*])
   and exactly one warp pass, then selects by the sampled op index — the
   all-branch cost of lax.switch under vmap never multiplies the expensive
   warp.

4. Rejection loops (random box sampling, oa_mix.py:134-154) become fixed
   ``attempts``-draw scans taking the first valid draw; uint8 wraparound in
   the reference's float->uint8 casts is replaced by clip (documented).

Everything here is jit-traceable; ``oamix_batch`` is called inside the
train step so augmentation fuses with H2D-resident data and overlaps the
optimizer on the same chip.
"""
from __future__ import annotations

import math
from functools import partial
import os as _os
from typing import Any, Dict, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from .row_warp import (warp_rotate, warp_shear_x, warp_shear_y,
                       warp_translate_x, warp_translate_y)
from .photometric import (autocontrast, enhance_brightness, enhance_color,
                          enhance_contrast, enhance_sharpness, equalize,
                          invert, posterize, solarize)
from .saliency import saliency_score

MAX_ML = 2          # multilevel random boxes: target = randint(1,3) in {1,2}
MAX_OA = 5          # oa random boxes: min(max(n_lowsal,1),5)
MAX_FG = 16         # GT boxes participating in per-box warps / oa mixing
ATTEMPTS = 8        # redraws per random-box slot (reference: up to 50)


def _lane_dtype():
    """Chain-state lane dtype crossing every lax.cond/switch boundary.

    The chain state is integer-valued 0..255 after every op (each branch
    trunc/rounds), so uint8 represents it EXACTLY and quarters the f32
    boundary materialization bytes.
    Branches upcast internally exactly as the bf16-lane form did, so all
    math — and therefore the golden/quantization pins — is bit-identical.
    OAMIX_LANES=bf16|f32 restores the wider lanes (A/B + debugging);
    OAMIX_F32_LANES=1 is kept as an alias for f32.
    """
    if _os.environ.get("OAMIX_F32_LANES"):
        return jnp.float32
    v = _os.environ.get("OAMIX_LANES", "u8")
    return {"f32": jnp.float32, "bf16": jnp.bfloat16,
            "u8": jnp.uint8}[v]


# ---------------------------------------------------------------- masks ----

def _box_blur_1d(t, a, b, sigma):
    """1D box [a, b) convolved with a Gaussian, evaluated at ``t``, with
    REFLECT_101 border terms about 0 and the domain end — matching cv2's
    GaussianBlur border mode on the reference's quarter-res mask."""
    s = sigma * math.sqrt(2)

    def base(x):
        return 0.5 * (jax.lax.erf((x - a) / s) - jax.lax.erf((x - b) / s))

    return base(t)


def _blurred_box_mask(box, h: int, w: int, sigma_ratio: float):
    """Analytic Gaussian-blurred box mask, (H, W) in [0, 1].

    Equals the reference's quarter-res blur + resize (oa_mix.py:74-93) in
    the continuous limit; REFLECT_101 reflections about both image borders
    are added so edge-adjacent boxes keep the same mass cv2 gives them.
    """
    x1, y1, x2, y2 = box[0], box[1], box[2], box[3]
    sx = jnp.maximum((x2 - x1) * sigma_ratio * 2.0 / 3.0, 1e-3)
    sy = jnp.maximum((y2 - y1) * sigma_ratio * 2.0 / 3.0, 1e-3)
    xs = jnp.arange(w, dtype=jnp.float32) + 0.5
    ys = jnp.arange(h, dtype=jnp.float32) + 0.5
    fx = (_box_blur_1d(xs, x1, x2, sx)
          + _box_blur_1d(-xs, x1, x2, sx)              # reflect about 0
          + _box_blur_1d(2.0 * w - xs, x1, x2, sx))    # reflect about w
    fy = (_box_blur_1d(ys, y1, y2, sy)
          + _box_blur_1d(-ys, y1, y2, sy)
          + _box_blur_1d(2.0 * h - ys, y1, y2, sy))
    return jnp.clip(fy[:, None] * fx[None, :], 0.0, 1.0)


def _hard_box_mask(box, h: int, w: int):
    x1, y1, x2, y2 = box[0], box[1], box[2], box[3]
    xs = jnp.arange(w, dtype=jnp.float32)
    ys = jnp.arange(h, dtype=jnp.float32)
    fx = ((xs >= x1) & (xs < x2)).astype(jnp.float32)
    fy = ((ys >= y1) & (ys < y2)).astype(jnp.float32)
    return fy[:, None] * fx[None, :]


# ------------------------------------------------------- random regions ----

def _sample_random_boxes(key, img_shape, scale_rng, ratio_rng, max_boxes: int,
                         num_lo: int, num_hi: int):
    """Static-shape version of get_random_regions (oa_mix.py:122): up to
    ``max_boxes`` slots, each taking the first of ATTEMPTS draws that fits
    inside the image; overlapping earlier valid slots invalidates a slot.

    Returns boxes (max_boxes, 4), valid (max_boxes,).
    """
    h, w = img_shape[0], img_shape[1]
    kt, key = jax.random.split(key)
    target = jax.random.randint(kt, (), num_lo, num_hi)       # [lo, hi)

    def draw_all(sub):
        u = jax.random.uniform(sub, (ATTEMPTS, 4))
        x1 = jnp.floor(u[:, 0] * w)
        y1 = jnp.floor(u[:, 1] * h)
        s = (min(scale_rng) + u[:, 2] * (max(scale_rng) - min(scale_rng))) * h * w
        r = min(ratio_rng) + u[:, 3] * (max(ratio_rng) - min(ratio_rng))
        bw = jnp.floor(jnp.sqrt(s / r))
        bh = jnp.floor(jnp.sqrt(s * r))
        ok = (x1 + bw <= w) & (y1 + bh <= h) & (bw >= 1) & (bh >= 1)
        return jnp.stack([x1, y1, x1 + bw, y1 + bh], -1), ok

    def slot(i, carry):
        boxes, valid, key = carry
        key, sub = jax.random.split(key)
        cboxes, coks = draw_all(sub)
        # overlap with earlier valid boxes kills a candidate
        def overlaps(b):
            x1 = jnp.maximum(b[0], boxes[:, 0])
            y1 = jnp.maximum(b[1], boxes[:, 1])
            x2 = jnp.minimum(b[2], boxes[:, 2])
            y2 = jnp.minimum(b[3], boxes[:, 3])
            inter = jnp.maximum(x2 - x1, 0) * jnp.maximum(y2 - y1, 0)
            return jnp.any((inter > 1e-6) & valid)
        coks = coks & ~jax.vmap(overlaps)(cboxes)
        pick = jnp.argmax(coks)                                 # first True
        box = cboxes[pick]
        ok = coks[pick] & (i < target)
        boxes = boxes.at[i].set(jnp.where(ok, box, 0.0))
        valid = valid.at[i].set(ok)
        return boxes, valid, key

    boxes = jnp.zeros((max_boxes, 4))
    valid = jnp.zeros((max_boxes,), bool)
    boxes, valid, _ = jax.lax.fori_loop(0, max_boxes, slot,
                                        (boxes, valid, key))
    return boxes, valid


# ------------------------------------------------------------- warps -------

def _op_matrices(key, family: int, boxes, box_valid, img_shape,
                 severity: float, is_bg: bool, inj=None):
    """Forward 2x3 affines for one geometric-op family, vectorized over
    boxes (all per-box quantities stay (G,) vectors and the RNG is one
    fused draw).

    ``family``: 0=rotate, 1=shear_xy, 2=translate_xy — parameter scaling per
    reference augmix.py:83-188 (per-box level draws, box-scaled translate,
    box-center rotation/shear for bboxes_only; image-center / zero-offset
    for bg_only).
    """
    h, w = img_shape[0], img_shape[1]
    g = boxes.shape[0]
    if inj is not None:          # shared-draw-table mode (parity tests)
        lvl = inj[0][:g]
        sign = inj[1][:g]
        use_x = inj[2] < 0.5
    else:
        u = jax.random.uniform(key, (g, 3))
        lvl = 0.1 + u[:, 0] * (severity - 0.1)
        sign = jnp.where(u[:, 1] > 0.5, -1.0, 1.0)
        # ONE axis coin per call (reference bbox_augmentation.py:103-104:
        # shear_xy picks shear_x or shear_y once, for every box);
        # magnitudes and signs stay per-box (sample_level runs per
        # aug_func call inside the per-box loop)
        use_x = u[0, 2] < 0.5

    if is_bg:
        cx = jnp.full((g,), w / 2.0)
        cy = jnp.full((g,), h / 2.0)
        bw = jnp.full((g,), w)
        bh = jnp.full((g,), h)
    else:
        cx = (boxes[:, 0] + boxes[:, 2]) / 2.0
        cy = (boxes[:, 1] + boxes[:, 3]) / 2.0
        bw = boxes[:, 2] - boxes[:, 0] + 1
        bh = boxes[:, 3] - boxes[:, 1] + 1
    zeros = jnp.zeros((g,))
    ones = jnp.ones((g,))

    def assemble(a, b, c, d, e, f):
        # rows [[a, b, c], [d, e, f]] -> (G, 2, 3)
        return jnp.stack([jnp.stack([a, b, c], -1),
                          jnp.stack([d, e, f], -1)], -2)

    if family == 0:                 # rotate about (cx, cy)
        deg = jnp.floor(lvl * 30.0 / 10.0) * sign
        rad = jnp.deg2rad(deg)
        ca, sa = jnp.cos(rad), jnp.sin(rad)
        return assemble(ca, sa, (1 - ca) * cx - sa * cy,
                        -sa, ca, sa * cx + (1 - ca) * cy)
    if family == 1:                 # shear x or y (cv2 M=[[1,-l,-tx],[0,1,0]])
        sh = lvl * 0.3 / 10.0 * sign
        tx = zeros if is_bg else -sh * cy
        ty = zeros if is_bg else -sh * cx
        m_shx = assemble(ones, -sh, -tx, zeros, ones, zeros)
        m_shy = assemble(ones, zeros, zeros, -sh, ones, -ty)
        return jnp.where(use_x, m_shx, m_shy)
    # translate x or y, level = int(lvl * maxval/3 / 10)
    shift_x = jnp.floor(lvl * (bw / 3.0) / 10.0) * sign
    shift_y = jnp.floor(lvl * (bh / 3.0) / 10.0) * sign
    m_trx = assemble(ones, zeros, -shift_x, zeros, ones, zeros)
    m_try = assemble(ones, zeros, zeros, zeros, ones, -shift_y)
    return jnp.where(use_x, m_trx, m_try)


def _invert_2x3(m):
    a, b, tx = m[0, 0], m[0, 1], m[0, 2]
    c, d, ty = m[1, 0], m[1, 1], m[1, 2]
    det = a * d - b * c
    det = jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
    ia, ib = d / det, -b / det
    ic, id_ = -c / det, a / det
    return jnp.stack([jnp.stack([ia, ib, -(ia * tx + ib * ty)]),
                      jnp.stack([ic, id_, -(ic * tx + id_ * ty)])])


# ----------------------------------------------------------- chain step ----

def _lerp_axis(pair, idx, frac, axis: int, limit: int):
    """2-tap linear interp along one axis from a channel-paired table.

    ``pair`` holds (x, shift(x)) in split channels so ONE axis-aligned
    take_along_axis fetches both taps (a single-axis gather, not a
    2D-indirect one)."""
    c = pair.shape[-1] // 2
    v = jnp.take_along_axis(pair, jnp.clip(idx, 0, limit - 1)[..., None],
                            axis=axis)
    ok = ((idx >= -1) & (idx <= limit - 1))[..., None]
    a = jnp.where(ok & (idx >= 0)[..., None], v[..., :c], 0.0)
    b = jnp.where(ok & (idx + 1 <= limit - 1)[..., None], v[..., c:], 0.0)
    f = frac[..., None]
    return a * (1 - f) + b * f


class _FgInfo(NamedTuple):
    boxes: jnp.ndarray       # (MAX_FG, 4)
    valid: jnp.ndarray       # (MAX_FG,)
    scores: jnp.ndarray      # (MAX_FG,)
    best_id: jnp.ndarray     # (H, W) int8: strongest-mask box per pixel,
    # or the identity sentinel G where every mask < BID_EPS (the blend
    # weight there is negligible)
    cover: jnp.ndarray       # (H, W) bf16 combined coverage 1-prod(1-m_i)
    union: jnp.ndarray       # (H, W) bf16 max_i m_i (bg_only's fg-union)
    # narrow dtypes: these maps are closed over by every lax.switch branch,
    # so they may be materialized at every conditional boundary. int8
    # indexes MAX_FG=16; bf16 blend weights cost <=0.4% of one intensity
    # level.


BID_EPS = 1e-5      # best mask below this -> identity sentinel id G: the
# blend weight there is < G*eps (~2e-4, <=0.04 intensity), while the argmax
# would otherwise spray arbitrary far-box ids Voronoi-style across the image


def fg_profiles(boxes, valid, h: int, w: int, sigma_ratio: float):
    """Separable 1-D profiles of the blurred box masks: (G, W) and (G, H),
    with invalid and degenerate boxes gated to zero."""
    xs = jnp.arange(w, dtype=jnp.float32) + 0.5
    ys = jnp.arange(h, dtype=jnp.float32) + 0.5

    def profiles(box):
        x1, y1, x2, y2 = box[0], box[1], box[2], box[3]
        sx = jnp.maximum((x2 - x1) * sigma_ratio * 2.0 / 3.0, 1e-3)
        sy = jnp.maximum((y2 - y1) * sigma_ratio * 2.0 / 3.0, 1e-3)
        fx = (_box_blur_1d(xs, x1, x2, sx)
              + _box_blur_1d(-xs, x1, x2, sx)
              + _box_blur_1d(2.0 * w - xs, x1, x2, sx))
        fy = (_box_blur_1d(ys, y1, y2, sy)
              + _box_blur_1d(-ys, y1, y2, sy)
              + _box_blur_1d(2.0 * h - ys, y1, y2, sy))
        return fx, fy

    fx, fy = jax.vmap(profiles)(boxes)                    # (G, W), (G, H)
    small = ((boxes[:, 2] - boxes[:, 0]) < 1) | \
            ((boxes[:, 3] - boxes[:, 1]) < 1)
    gate = (valid & ~small).astype(jnp.float32)           # (G,)
    return jnp.clip(fx, 0.0, 1.0), jnp.clip(fy, 0.0, 1.0) * gate[:, None]


def fg_maps(fx, fy):
    """The three per-pixel reductions over the G separable box masks
    m_i(y, x) = fy[i, y] * fx[i, x], as one broadcast-reduce over the box
    axis: best_id = argmax_i m_i (int8, or the sentinel G where every mask
    < BID_EPS), cover = 1 - prod_i (1 - m_i) and union = max_i m_i (bf16),
    each (H, W)."""
    g = fx.shape[0]
    m = fy[:, :, None] * fx[:, None, :]            # (G, H, W)
    best = jnp.max(m, axis=0)
    best_id = jnp.where(best >= BID_EPS, jnp.argmax(m, axis=0),
                        g).astype(jnp.int8)
    cover = jnp.clip(1.0 - jnp.prod(1.0 - m, axis=0), 0.0, 1.0)
    return best_id, cover.astype(jnp.bfloat16), best.astype(jnp.bfloat16)


def _precompute_fg_maps(boxes, valid, h: int, w: int, sigma_ratio: float):
    """Per-image mask maps shared by every aug call (the boxes never change
    within a view, so this runs once, not 27x). Only the 1-D profiles are
    computed per box (G x W + G x H erf evaluations)."""
    return fg_maps(*fg_profiles(boxes, valid, h, w, sigma_ratio))


def _apply_geo_bboxes_only(img, fg: _FgInfo, inv_boxes):
    """bboxes_only_*: ONE per-pixel-separable 2-pass warp. The per-box
    inverse matrices are gathered per pixel by the precomputed
    strongest-box assignment and fed into the two axis-aligned resampling
    passes — no 2D-indirect gather (which also poisons lax.switch
    compile times), no per-box loop.

    Divergence note: pass 1 rows are resampled with the matrix of the row
    being read rather than the consuming output pixel; the two differ only
    across box-mask boundaries where the blend weight is already small.
    """
    img = img.astype(jnp.float32)        # the warp computes in f32
    h, w = img.shape[0], img.shape[1]
    c = img.shape[-1]
    # row G = identity matrix for the far-from-every-box sentinel id
    # (BID_EPS)
    ident = jnp.asarray([[1.0, 0.0, 0.0, 0.0, 1.0, 0.0]], jnp.float32)
    inv_pad = jnp.concatenate([inv_boxes, ident], axis=0)     # (G+1, 6)
    m = inv_pad[fg.best_id.astype(jnp.int32)]                 # (H, W, 6)
    xo = jnp.arange(w, dtype=jnp.float32)[None, :]
    u = jnp.arange(h, dtype=jnp.float32)[:, None]
    e = jnp.where(jnp.abs(m[..., 4]) < 1e-3, 1e-3, m[..., 4])
    gx = ((m[..., 0] - m[..., 1] * m[..., 3] / e) * xo
          + (m[..., 1] / e) * u
          + (m[..., 2] - m[..., 1] * m[..., 5] / e))
    x0 = jnp.floor(gx)
    shifted = jnp.concatenate([img[:, 1:], jnp.zeros((h, 1, c), img.dtype)],
                              axis=1)
    pair_x = jnp.concatenate([img, shifted], axis=-1)
    tmp = _lerp_axis(pair_x, x0.astype(jnp.int32), gx - x0, axis=1, limit=w)

    sy = m[..., 3] * xo + m[..., 4] * u + m[..., 5]
    y0 = jnp.floor(sy)
    shifted_y = jnp.concatenate([tmp[1:], jnp.zeros((1, w, c), tmp.dtype)],
                                axis=0)
    pair_y = jnp.concatenate([tmp, shifted_y], axis=-1)
    warped = _lerp_axis(pair_y, y0.astype(jnp.int32), sy - y0, axis=0,
                        limit=h)
    cov = fg.cover.astype(jnp.float32)[..., None]
    out = img * (1.0 - cov) + warped * cov
    return jnp.clip(jnp.round(out), 0, 255)


def _aug_once(img_io, key, op_idx, fg: _FgInfo, img_shape, severity: float,
              version: str, active=None, inj=None):
    """One reference ``aug()`` call (oa_mix.py:264): the sampled op applied
    to the full image.

    ``op_idx`` is traced; dispatch is a ``lax.switch`` over the reference's
    op list (get_aug_list, oa_mix.py:15) — outside of vmap only the selected
    branch executes, so the expensive warp branches cost nothing when a LUT
    op is drawn.

    The image crosses the conditional boundary in the narrow lane dtype
    (uint8 by default, see ``_lane_dtype``): a conditional may materialize
    its operands and results, and the chain state is integer-valued
    0..255, so the narrow lanes are exact. Elementwise photometric ops
    upcast to f32 inside their fused consumers; the warps compute in f32.
    OAMIX_LANES=f32 restores the f32 path (A/B + debugging).
    """
    img = img_io.astype(_lane_dtype())
    all_ops = version != "augmix"
    n_photo = 9 if all_ops else 4

    def imgf():
        """f32 view of the chain state, upcast INSIDE the branch body.

        Photometric ops must compute in f32 (weak-typed scalar consts
        would otherwise keep bf16 math, diverging from the host oracle
        by a few /255) — but the upcast has to live inside each branch:
        hoisting it would make the f32 image a switch operand."""
        return img.astype(jnp.float32)

    def lvl_from(k):
        if inj is not None:      # shared-draw-table mode (parity tests)
            return inj[0][0]
        return 0.1 + jax.random.uniform(k) * (severity - 0.1)

    def br_auto(k):
        return autocontrast(imgf())

    def br_eq(k):
        return equalize(imgf())

    def br_post(k):
        bits = 4 - jnp.floor(lvl_from(k) * 4.0 / 10.0).astype(jnp.int32)
        return posterize(imgf(), jnp.maximum(bits, 1))

    def br_sol(k):
        thr = 256 - jnp.floor(lvl_from(k) * 256.0 / 10.0).astype(jnp.int32)
        return solarize(imgf(), thr)

    def br_inv(k):
        return invert(imgf())

    def _f(k):
        return lvl_from(k) * 1.8 / 10.0 + 0.1

    # bbox geo: one branch per family; each is the per-pixel affine
    # gather (the reference's one bilinear cv2.warpAffine per box, blended
    # through the strongest-box assignment).
    def _geo_gather(k, family):
        mats = _op_matrices(k, family, fg.boxes, fg.valid, img_shape,
                            severity, is_bg=False, inj=inj)
        inv = jax.vmap(_invert_2x3)(mats)
        return _apply_geo_bboxes_only(img, fg, inv.reshape(-1, 6))

    def br_geo_rot(k):
        return _geo_gather(k, 0)

    def br_geo_shear(k):
        return _geo_gather(k, 1)

    def br_geo_trans(k):
        return _geo_gather(k, 2)

    # bg geo: family-specific separable row-shift warps (ops/row_warp.py).
    # The rgb image and the fg-union alpha (x255) ride ONE 4-channel warp.
    h_s, w_s = img.shape[0], img.shape[1]

    def _bg_blend(warp_fn, k):
        imgw = img.astype(jnp.bfloat16) if img.dtype == jnp.uint8 else img
        un = fg.union.astype(jnp.float32)
        # alpha rides in the image dtype (a uint8 alpha would
        # trunc-quantize it, so u8 lanes upcast to bf16 first)
        x4 = jnp.concatenate(
            [imgw, (un[..., None] * 255.0).astype(imgw.dtype)], axis=-1)
        w4 = warp_fn(x4, k)
        maintained = jnp.maximum(un, w4[..., 3] / 255.0)[..., None]
        out = maintained * imgw + (1.0 - maintained) * w4[..., :3]
        return jnp.clip(jnp.round(out), 0, 255)

    def _lvl_sign(k):
        if inj is not None:
            return inj[0][0], inj[1][0], inj[2]
        u = jax.random.uniform(k, (3,))
        lvl = 0.1 + u[0] * (severity - 0.1)
        sign = jnp.where(u[1] > 0.5, -1.0, 1.0)
        return lvl, sign, u[2]

    def br_bg_rotate(k):
        def w(im4, kk):
            lvl, sign, _ = _lvl_sign(kk)
            deg = jnp.floor(lvl * 30.0 / 10.0) * sign
            msx = int(0.27 * h_s / 2) + 4
            msy = int(0.50 * w_s / 2) + 4
            return warp_rotate(im4, jnp.deg2rad(deg), w_s / 2.0, h_s / 2.0,
                               msx, msy)
        return _bg_blend(w, k)

    def br_bg_shear(k):
        def w(im4, kk):
            lvl, sign, coin = _lvl_sign(kk)
            s = lvl * 0.3 / 10.0 * sign
            # bg shear has no center offset (augmix.py: center=None -> t=0)
            # lax.cond: only the drawn axis's warp runs (the old
            # compute-both + where paid two kernel passes every call)
            return jax.lax.cond(
                coin < 0.5,
                lambda im: warp_shear_x(im, s, 0.0, 0.0,
                                        int(0.3 * h_s) + 4),
                lambda im: warp_shear_y(im, s, 0.0, 0.0,
                                        int(0.3 * w_s) + 4),
                im4)
        return _bg_blend(w, k)

    def br_bg_translate(k):
        def w(im4, kk):
            lvl, sign, coin = _lvl_sign(kk)
            tx = jnp.floor(lvl * (w_s / 3.0) / 10.0) * sign
            ty = jnp.floor(lvl * (h_s / 3.0) / 10.0) * sign
            return jax.lax.cond(
                coin < 0.5,
                lambda im: warp_translate_x(im, tx, w_s // 3 + 4),
                lambda im: warp_translate_y(im, ty, h_s // 3 + 4),
                im4)
        return _bg_blend(w, k)

    branches = [br_auto, br_eq, br_post, br_sol]
    if all_ops:
        branches += [br_inv,
                     lambda k: enhance_color(imgf(), _f(k)),
                     lambda k: enhance_contrast(imgf(), _f(k)),
                     lambda k: enhance_brightness(imgf(), _f(k)),
                     lambda k: enhance_sharpness(imgf(), _f(k))]
    branches += [br_geo_rot, br_geo_shear, br_geo_trans,
                 br_bg_rotate, br_bg_shear, br_bg_translate]
    # op order (get_aug_list): photo..., bboxes_only rotate/shear_xy/
    # translate_xy, bg rotate/shear_xy/translate_xy — 1:1 with branches.
    branch_idx = op_idx
    lane_dt = _lane_dtype()

    def to_lane(x):
        # every branch is clipped to [0, 255] already; the extra clip is
        # a fused no-op that guards the u8 cast against any future
        # unclipped branch (f32->u8 casts WRAP out-of-range values)
        return (jnp.clip(x, 0, 255).astype(lane_dt)
                if lane_dt == jnp.uint8 else x.astype(lane_dt))

    branches16 = [lambda k, b=b: to_lane(b(k)) for b in branches]
    if active is not None:
        # empty random-box slots multiply the result by an all-zero mask —
        # route them to a passthrough branch so the expensive op never
        # executes (bit-exact: the output is discarded anyway)
        branches16 = branches16 + [lambda k: img_io.astype(lane_dt)]
        branch_idx = jnp.where(active, branch_idx, len(branches16) - 1)
    return jax.lax.switch(jnp.clip(branch_idx, 0, len(branches16) - 1),
                          branches16, key)


# -------------------------------------------------------------- oamix ------

def _oamix_single(img, gt_boxes, gt_valid, img_shape, key, cfg: Dict,
                  draws: Dict = None):
    """One aug view for one image. img (H, W, 3) float32 [0,255] (pipeline
    color order, BGR like the reference). Returns (aug_img, ml_boxes,
    ml_valid, oa_boxes, oa_valid).

    ``draws`` (shared-draw-table parity mode — tests drive this kernel
    and the host oracle oa_mix_host.oamix_host from ONE pinned table):
    dict of arrays replacing every PRNG draw — ml_boxes (MAX_ML, 4) +
    ml_valid, ws (width,), depth (width,) int, op_idx (width, 3, S+1)
    int, op_level/op_sign (width, 3, S+1, max_fg) f32, op_coin
    (width, 3, S+1) f32, fg_scores (max_fg,), oa_boxes (MAX_OA, 4) +
    oa_valid, mix_us (max_fg + MAX_OA,), m_global (). None = production
    PRNG path, bit-identical to before."""
    h, w = img.shape[0], img.shape[1]
    severity = float(cfg.get("severity", 10))
    width = int(cfg.get("mixture_width", 3))
    depth_cfg = int(cfg.get("mixture_depth", -1))
    sigma_ratio = float(cfg.get("sigma_ratio", 0.3))
    spatial_ratio = int(cfg.get("spatial_ratio", 4))
    version = cfg.get("version", "augmix")

    keys = jax.random.split(key, 8)

    # multilevel random boxes + masks
    if draws is not None:
        ml_boxes = draws["ml_boxes"].astype(jnp.float32)
        ml_valid = draws["ml_valid"].astype(bool)
    else:
        ml_boxes, ml_valid = _sample_random_boxes(
            keys[0], img_shape,
            tuple(cfg.get("random_box_scale", (0.01, 0.1))),
            tuple(cfg.get("random_box_ratio", (3, 1 / 3))), MAX_ML, 1, 3)
    # HARD masks: the reference builds multilevel region masks WITHOUT
    # blur (oa_mix.py:137 get_random_regions default use_blur=False;
    # only fg masks are blurred) — confirmed by the golden parity test.
    ml_masks = jax.vmap(lambda b, v: jnp.where(
        v, _hard_box_mask(jnp.floor(b), h, w), 0.0))(ml_boxes, ml_valid)
    union_mask = jnp.max(ml_masks, axis=0)

    # fg regions: saliency scores + static slots + per-image mask maps
    # (computed ONCE, shared by all ~27 aug calls of this view)
    # Cap on object-aware boxes (reference treats every gt; the cap keeps
    # the per-box fg precompute static). Cityscapes images can exceed 16
    # instances — raise via cfg max_fg (<=127: best_id is int8). The cap's
    # distribution effect is measured in tests/test_oamix_device.py.
    max_fg = int(cfg.get("max_fg", MAX_FG))
    fg_boxes = gt_boxes[:max_fg]
    fg_valid = gt_valid[:max_fg]
    if draws is not None:
        scores = jnp.where(fg_valid,
                           draws["fg_scores"][:max_fg].astype(jnp.float32),
                           -1.0)
    else:
        scores = jax.vmap(lambda b, v: jnp.where(
            v, saliency_score(img, b, min_size=spatial_ratio), -1.0))(
            fg_boxes, fg_valid)
    best_id, cover, union = _precompute_fg_maps(fg_boxes, fg_valid, h, w,
                                                sigma_ratio)
    fg = _FgInfo(fg_boxes, fg_valid, scores, best_id, cover, union)

    # Dirichlet chain weights + all op draws up front
    n_ops = (4 if version == "augmix" else 9) + 6
    max_depth = 3
    n_slots = MAX_ML + 1
    k_ops, k_calls = jax.random.split(keys[2])
    if draws is not None:
        ws = draws["ws"].astype(jnp.float32)
        op_draw = draws["op_idx"].astype(jnp.int32)
    else:
        ws = jax.random.dirichlet(keys[1], jnp.ones((width,)))
        op_draw = jax.random.randint(k_ops, (width, max_depth, n_slots),
                                     0, n_ops)
    import os as _os
    _force = _os.environ.get("OAMIX_FORCE_OP")
    if _force is not None:                       # debug/profiling knob
        op_draw = jnp.full_like(op_draw, int(_force))
    call_keys = jax.random.split(k_calls, width * max_depth * n_slots)
    call_keys = call_keys.reshape(width, max_depth, n_slots, -1)

    # chain-and-mix. Structured as lax.scan over width and over slots so
    # the big _aug_once subgraph (a ~14-branch lax.switch whose bodies
    # include the warp kernels) is TRACED ONCE per depth body instead of
    # width x slots times — the chain dominated the step's compile time.
    # scan (unlike vmap) keeps lax.switch a real conditional: only each
    # step's sampled op executes.
    # The ml region boxes are overlap-rejected (reference get_random_regions
    # discards any box intersecting an earlier one) and the masks are HARD
    # integer-floored boxes, so {ml_1..ml_S, complement} is an exact
    # partition of the image: the reference's weighted blend
    # sum_s mask_s * out_s degenerates to a per-pixel SELECT. Selecting on
    # a bool mask with a bf16 carry is bit-identical to the f32
    # multiply-add it replaces (each pixel receives exactly one slot's
    # bf16 value; adding it to a zero f32 accumulator changed nothing)
    # and halves the accumulator traffic while deleting the bf16->f32
    # materialization at the switch boundary.
    slot_masks = jnp.concatenate(
        [ml_masks, (1.0 - union_mask)[None]], axis=0) > 0      # (S+1, H, W)
    slot_active = jnp.concatenate([ml_valid, jnp.ones((1,), bool)])

    inject = draws is not None

    def chain_body(acc, xs):
        if inject:
            kc, wgt, ck_w, od_w, lv_w, sg_w, cn_w, depth = xs
        else:
            kc, wgt, ck_w, od_w = xs
            depth = (depth_cfg if depth_cfg > 0
                     else jax.random.randint(kc, (), 1, 4))

        def depth_step(d, img_aug16):
            def slot_body(img_tmp, sx):
                if inject:
                    ck, od, mask, act, lv, sg, cn = sx
                    inj_t = (lv, sg, cn)
                else:
                    ck, od, mask, act = sx
                    inj_t = None

                def run(it):
                    out_s = _aug_once(img_aug16, ck, od, fg, img_shape,
                                      severity, version, inj=inj_t)
                    return jnp.where(mask[..., None], out_s, it)

                # inactive slots have an all-zero mask: skip BOTH the op and
                # the full-image select (bit-exact — selecting nothing)
                return jax.lax.cond(act, run, lambda it: it, img_tmp), None

            slot_xs = (ck_w[d], od_w[d], slot_masks, slot_active)
            if inject:
                slot_xs = slot_xs + (lv_w[d], sg_w[d], cn_w[d])
            img_tmp, _ = jax.lax.scan(
                slot_body, jnp.zeros(img_aug16.shape, _lane_dtype()),
                slot_xs)
            # round/clip are exact in the lane dtype on the 0..~300 range
            # the branch outputs live in (every integer 0..255 is
            # representable; u8 lanes carry already-rounded ints) —
            # bit-identical to the old f32 path
            if img_tmp.dtype == jnp.uint8:
                return img_tmp
            return jnp.clip(jnp.round(img_tmp), 0, 255)

        # traced upper bound: only `depth` iterations actually execute
        # (E[depth]=2 of max 3 — a masked static loop would waste ~1/3)
        out16 = jax.lax.fori_loop(0, depth, depth_step,
                                  img.astype(_lane_dtype()))
        return acc + wgt * out16.astype(jnp.float32), None

    chain_keys = jax.random.split(keys[5], width)
    chain_xs = (chain_keys, ws, call_keys, op_draw)
    if inject:
        chain_xs = chain_xs + (
            draws["op_level"].astype(jnp.float32),
            draws["op_sign"].astype(jnp.float32),
            draws["op_coin"].astype(jnp.float32),
            draws["depth"].astype(jnp.int32))
    if _os.environ.get("OAMIX_SKIP_CHAIN"):      # profiling knob
        img_oamix = img * 1.0000001
    else:
        img_oamix, _ = jax.lax.scan(
            chain_body, jnp.zeros_like(img), chain_xs)

    # object-aware mixing regions: low-saliency fg + oa random boxes
    low_sal = fg_valid & (scores <= float(cfg.get("score_thresh", 10)))
    if draws is not None:
        oa_boxes = draws["oa_boxes"].astype(jnp.float32)
        oa_valid = draws["oa_valid"].astype(bool)
    else:
        n_low = jnp.sum(low_sal)
        n_oa_target = jnp.clip(n_low, 1, MAX_OA)
        oa_boxes, oa_valid0 = _sample_random_boxes(
            keys[3], img_shape,
            tuple(cfg.get("oa_random_box_scale", (0.005, 0.1))),
            tuple(cfg.get("oa_random_box_ratio", (3, 1 / 3))), MAX_OA, 1,
            MAX_OA + 1)
        oa_valid = oa_valid0 & (jnp.arange(MAX_OA) < n_oa_target)
    # oa box score: min fg score among overlapping fg boxes, else +inf
    def oa_score(b):
        x1 = jnp.maximum(b[0], fg_boxes[:, 0])
        y1 = jnp.maximum(b[1], fg_boxes[:, 1])
        x2 = jnp.minimum(b[2], fg_boxes[:, 2])
        y2 = jnp.minimum(b[3], fg_boxes[:, 3])
        inter = jnp.maximum(x2 - x1, 0) * jnp.maximum(y2 - y1, 0)
        ovl = (inter > 1e-6) & fg_valid & \
              ((fg_boxes[:, 2] - fg_boxes[:, 0]) >= 1) & \
              ((fg_boxes[:, 3] - fg_boxes[:, 1]) >= 1)
        return jnp.min(jnp.where(ovl, scores, jnp.inf))
    oa_scores = jax.vmap(oa_score)(oa_boxes)

    # sequential overlap-corrected accumulation (oa_mix.py:281-308)
    region_boxes = jnp.concatenate([fg_boxes, oa_boxes], axis=0)
    region_valid = jnp.concatenate([low_sal, oa_valid], axis=0)
    region_scores = jnp.concatenate([scores, oa_scores], axis=0)
    if draws is not None:
        mix_us = draws["mix_us"].astype(jnp.float32)
    else:
        mix_us = jax.random.uniform(keys[4], (region_boxes.shape[0],))

    # Per-pixel region masks via separable 1-D profiles (R*W + R*H erf
    # evaluations once, one outer product per loop iteration) instead of a
    # full-resolution erf evaluation per region — and the carries are the
    # two scalar WEIGHT maps, not weighted images: orig/aug factor as
    # img * sum_i (1-m_oa_i) wgt_i and img_oamix * sum_i m_oa_i wgt_i, so
    # the (H, W, 3) FMAs happen once after the loop. Also uses
    # a + b - max(a, b) == min(a, b) for the overlap term.
    def reg_profiles(box):
        x1, y1, x2, y2 = box[0], box[1], box[2], box[3]
        sx = jnp.maximum((x2 - x1) * sigma_ratio * 2.0 / 3.0, 1e-3)
        sy = jnp.maximum((y2 - y1) * sigma_ratio * 2.0 / 3.0, 1e-3)
        xs = jnp.arange(w, dtype=jnp.float32) + 0.5
        ys = jnp.arange(h, dtype=jnp.float32) + 0.5
        fx = (_box_blur_1d(xs, x1, x2, sx) + _box_blur_1d(-xs, x1, x2, sx)
              + _box_blur_1d(2.0 * w - xs, x1, x2, sx))
        fy = (_box_blur_1d(ys, y1, y2, sy) + _box_blur_1d(-ys, y1, y2, sy)
              + _box_blur_1d(2.0 * h - ys, y1, y2, sy))
        return jnp.clip(fx, 0.0, 1.0), jnp.clip(fy, 0.0, 1.0)

    def hard_profiles(box):
        x1, y1, x2, y2 = (jnp.floor(box[0]), jnp.floor(box[1]),
                          jnp.floor(box[2]), jnp.floor(box[3]))
        xs = jnp.arange(w, dtype=jnp.float32)
        ys = jnp.arange(h, dtype=jnp.float32)
        return (((xs >= x1) & (xs < x2)).astype(jnp.float32),
                ((ys >= y1) & (ys < y2)).astype(jnp.float32))

    # fg regions keep blurred profiles; oa RANDOM boxes use HARD masks
    # (reference get_random_regions default — golden-test confirmed)
    n_fg_reg = fg_boxes.shape[0]
    fgx, fgy = jax.vmap(reg_profiles)(region_boxes[:n_fg_reg])
    hx, hy = jax.vmap(hard_profiles)(region_boxes[n_fg_reg:])
    rfx = jnp.concatenate([fgx, hx], axis=0)          # (R, W)
    rfy = jnp.concatenate([fgy, hy], axis=0)          # (R, H)
    score_thr = float(cfg.get("score_thresh", 10))

    def mix_body(i, carry):
        a_w, b_w, mask_sum = carry                    # (H, W) each
        m = jnp.where(region_valid[i], rfy[i][:, None] * rfx[i][None, :],
                      0.0)
        overlap = jnp.minimum(mask_sum, m)
        u = mix_us[i]
        m_oa = jnp.where(region_scores[i] <= score_thr, u * 0.5, u)
        wgt = m - overlap * 0.5
        a_w = a_w + (1.0 - m_oa) * wgt
        b_w = b_w + m_oa * wgt
        return a_w, b_w, jnp.maximum(mask_sum, m)

    zhw = jnp.zeros((h, w))
    if _os.environ.get("OAMIX_SKIP_MIX"):        # profiling knob
        a_w, b_w, mask_sum = zhw, zhw, zhw
    else:
        # UNROLLED (R = 21 static): a lax.fori_loop here became 21
        # serial while iterations of tiny elementwise bodies — unrolling
        # lets XLA fuse the whole accumulation chain into a few passes
        # (identical math, same iteration order)
        carry = (zhw, zhw, zhw)
        for _i in range(region_boxes.shape[0]):
            carry = mix_body(_i, carry)
        a_w, b_w, mask_sum = carry

    if draws is not None:
        m_global = draws["m_global"].astype(jnp.float32)
    else:
        m_global = jax.random.beta(keys[5], 1.0, 1.0)
    rest = 1.0 - mask_sum
    ow = a_w + (1.0 - m_global) * rest                # img weight
    aw = b_w + m_global * rest                        # img_oamix weight
    out = img * ow[..., None] + img_oamix * aw[..., None]
    # The reference stores the mixed view as uint8 (oa_mix.py:243
    # np.asarray(img_oamix, np.uint8) truncates after the clip at :307).
    # floor matches that truncation, and the integer-valued result is
    # EXACT in bf16 — halving the batch-scan carry bandwidth (the
    # (B, V-1, H, W, 3) dynamic-update-slice was the single biggest
    # non-conv fusion in the step profile at f32).
    out = jnp.floor(jnp.clip(out, 0, 255)).astype(jnp.bfloat16)
    return out, ml_boxes, ml_valid, oa_boxes, oa_valid


def oamix_batch(img_raw, gt_bboxes, gt_valid, img_shape, key,
                cfg: Dict, draws: Dict = None) -> Dict[str, jnp.ndarray]:
    """Batched multi-view OA-Mix.

    Args:
        img_raw: (B, H, W, 3) float32 [0,255] pre-Normalize images.
        gt_bboxes/gt_valid: (B, G, 4) / (B, G).
        img_shape: (B, 2) valid (h, w) per image.
        key: PRNG key.
        cfg: OAMix config dict (static).

    Returns dict with ``aug`` (B, V-1, H, W, 3) raw aug views,
    ``multilevel_boxes`` (B, MAX_ML, 4) + ``multilevel_valid``,
    ``oamix_boxes`` (B, MAX_OA, 4) + ``oamix_valid``.
    """
    num_views = int(cfg.get("num_views", 2))
    n_aug = max(num_views - 1, 0)
    b = img_raw.shape[0]

    def per_image(img, gt, gtv, shape, k, dr=None):
        views = []
        ml = oam = None
        kks = jax.random.split(k, max(n_aug, 1))
        for v in range(n_aug):
            dv = (None if dr is None else
                  jax.tree_util.tree_map(lambda a: a[v], dr))
            out, mlb, mlv, oab, oav = _oamix_single(img, gt, gtv, shape,
                                                    kks[v], cfg, draws=dv)
            views.append(out)
            ml, oam = (mlb, mlv), (oab, oav)    # keep last view's (ref behavior)
        if not views:
            views = [img.astype(jnp.bfloat16)]
            ml = (jnp.zeros((MAX_ML, 4)), jnp.zeros((MAX_ML,), bool))
            oam = (jnp.zeros((MAX_OA, 4)), jnp.zeros((MAX_OA,), bool))
        return (jnp.stack(views), ml[0], ml[1], oam[0], oam[1])

    # lax.scan over the batch instead of vmap: under vmap every lax.switch
    # branch would execute for every image, while scan keeps the switch a
    # real conditional (only each image's sampled ops run) AND traces the
    # per-image pipeline once regardless of batch size (a trace-time
    # unroll multiplied the step's compile time by b).
    keys = jax.random.split(key, b)

    if draws is not None:
        # shared-draw-table mode: each array in ``draws`` carries leading
        # (B, n_aug, ...) dims, scanned alongside the images
        def scan_im_inj(_, xs):
            img, gt, gtv, shape, k, dr = xs
            return None, per_image(img, gt, gtv, shape, k, dr)

        _, (aug, mlb, mlv, oab, oav) = jax.lax.scan(
            scan_im_inj, None,
            (img_raw, gt_bboxes, gt_valid, img_shape, keys, draws))
    else:
        def scan_im(_, xs):
            img, gt, gtv, shape, k = xs
            return None, per_image(img, gt, gtv, shape, k)

        _, (aug, mlb, mlv, oab, oav) = jax.lax.scan(
            scan_im, None, (img_raw, gt_bboxes, gt_valid, img_shape, keys))
    return dict(aug=aug, multilevel_boxes=mlb, multilevel_valid=mlv,
                oamix_boxes=oab, oamix_valid=oav)
