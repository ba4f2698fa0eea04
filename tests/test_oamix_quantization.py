"""Device OA-Mix vs host oracle under a SHARED DRAW TABLE.

VERDICT r3 item 3: the 0.3x-3x statistical band on the composed device
output is replaced by a real quantization-tolerance comparison — every
random draw (boxes, Dirichlet weights, depths, op indices, op levels/
signs/coins, saliency scores, mixing uniforms, Beta global mix) is pinned
to one table and injected into BOTH the device kernel
(ops/oamix_device.py oamix_batch(draws=...)) and the host oracle
(data/pipelines/oa_mix_host.py oamix_host(draws=...), itself golden-
tested against the vendored reference in tests/test_oamix_golden.py).
The composed outputs are then compared per-pixel.

Two tiers:
- strict: photometric-op chains with the DEVICE's closed-form blurred
  masks injected into the host mixing — isolates pure composed
  arithmetic (chain accumulation, Dirichlet mixture, uint8 requant,
  overlap-corrected mixing): everything must sit within +-1/255 except
  a vanishing reassociation tail.
- honest: each side computes its own fg masks (the documented closed-
  form vs quarter-res-blur divergence): >=99% of pixels within +-2/255,
  with the tail localized to mask-boundary bands.

Reference chain being modeled: oa_mix.py:207-308.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from oadg_tpu.ops.oamix_device import (MAX_FG, MAX_ML, MAX_OA,
                                       _box_blur_1d, oamix_batch)
from oadg_tpu.data.pipelines.oa_mix_host import oamix_host

H, W = 256, 384
WIDTH, MAXD, SLOTS = 3, 3, MAX_ML + 1
N_PHOTO_ALL = 9      # augmix.all photometric branch indices 0..8


def _structured_image():
    """Gradients + shapes so LUT ops (equalize/autocontrast) act on a
    non-trivial histogram."""
    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[0:H, 0:W]
    img = np.stack([(xx * 255 / W), (yy * 255 / H),
                    ((xx + yy) * 255 / (H + W))], axis=-1)
    img += rng.randint(0, 32, (H, W, 3))
    img[40:120, 60:180] = [200, 60, 30]
    img[150:220, 200:330, 1] = 220
    return np.clip(img, 0, 255).astype(np.uint8)


GT = np.array([[60.0, 40.0, 180.0, 120.0],
               [200.0, 150.0, 330.0, 220.0],
               [20.0, 180.0, 90.0, 240.0],
               [250.0, 30.0, 360.0, 110.0]], np.float32)
SCORES = np.array([5.0, 20.0, 3.0, 15.0], np.float32)   # 2 low, 2 high


def _draw_table(seed, op_choices):
    """One pinned draw table; op indices drawn from ``op_choices``."""
    rng = np.random.RandomState(seed)
    ml_boxes = np.array([[30.0, 20.0, 110.0, 90.0],
                         [180.0, 100.0, 300.0, 200.0]], np.float32)
    oa_boxes = np.zeros((MAX_OA, 4), np.float32)
    oa_boxes[:3] = [[10, 10, 60, 50], [300, 200, 370, 250],
                    [100, 120, 160, 170]]
    oa_valid = np.array([1, 1, 1, 0, 0], bool)
    ws = rng.dirichlet([1.0] * WIDTH).astype(np.float32)
    depth = np.array([2, 3, 1], np.int32)
    op_idx = rng.choice(op_choices, size=(WIDTH, MAXD, SLOTS)) \
        .astype(np.int32)
    op_level = (0.1 + rng.rand(WIDTH, MAXD, SLOTS, MAX_FG) * 9.8) \
        .astype(np.float32)
    op_sign = np.where(rng.rand(WIDTH, MAXD, SLOTS, MAX_FG) > 0.5,
                       1.0, -1.0).astype(np.float32)
    op_coin = rng.rand(WIDTH, MAXD, SLOTS).astype(np.float32)
    fg_scores = np.full((MAX_FG,), -1.0, np.float32)
    fg_scores[:len(SCORES)] = SCORES
    mix_us = rng.rand(MAX_FG + MAX_OA).astype(np.float32)
    m_global = np.float32(rng.beta(1.0, 1.0))
    return dict(ml_boxes=ml_boxes, ml_valid=np.ones((MAX_ML,), bool),
                ws=ws, depth=depth, op_idx=op_idx, op_level=op_level,
                op_sign=op_sign, op_coin=op_coin, fg_scores=fg_scores,
                oa_boxes=oa_boxes, oa_valid=oa_valid, mix_us=mix_us,
                m_global=m_global)


def _host_draws(t, gt=None, scores=None):
    """Map the slot-indexed device table to the host oracle's sequential
    consumption order."""
    if gt is None:
        gt, scores = GT, SCORES
    n_fg = len(gt)
    ops = [[[dict(op=int(t["op_idx"][i, d, s]),
                  levels=t["op_level"][i, d, s, :n_fg],
                  signs=t["op_sign"][i, d, s, :n_fg],
                  coin=float(t["op_coin"][i, d, s]))
             for s in range(SLOTS)]
            for d in range(MAXD)]
           for i in range(WIDTH)]
    # host mixing regions: low-score fg in gt order, then valid oa boxes
    mix = [t["mix_us"][i] for i in range(n_fg) if scores[i] <= 10.0]
    mix += [t["mix_us"][MAX_FG + j] for j in range(MAX_OA)
            if t["oa_valid"][j]]
    return dict(ws=t["ws"], ml_boxes=[b for b in t["ml_boxes"]],
                depth=t["depth"], op=ops, fg_scores=scores,
                oa_boxes=[b for b, v in zip(t["oa_boxes"], t["oa_valid"])
                          if v],
                mix_us=np.asarray(mix, np.float32),
                m_global=t["m_global"])


def _device_out(img, t, cfg, gt_in=None):
    if gt_in is None:
        gt_in = GT
    gt = np.zeros((MAX_FG, 4), np.float32)
    gt[:len(gt_in)] = gt_in
    gv = np.zeros((MAX_FG,), bool)
    gv[:len(gt_in)] = True
    dev_draws = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a)[None, None], t)      # (B=1, V-1=1, ...)
    out = oamix_batch(jnp.asarray(img, jnp.float32)[None],
                      jnp.asarray(gt)[None], jnp.asarray(gv)[None],
                      jnp.asarray([[H, W]], jnp.float32),
                      jax.random.PRNGKey(0), cfg, draws=dev_draws)
    return np.asarray(out["aug"][0, 0], np.float32)


def _device_mask(box):
    """The device mixing-mask closed form (reg_profiles: per-axis
    triple-reflection erf profiles, clipped per axis)."""
    x1, y1, x2, y2 = box
    sx = max((x2 - x1) * 0.3 * 2.0 / 3.0, 1e-3)
    sy = max((y2 - y1) * 0.3 * 2.0 / 3.0, 1e-3)
    xs = jnp.arange(W, dtype=jnp.float32) + 0.5
    ys = jnp.arange(H, dtype=jnp.float32) + 0.5
    fx = (_box_blur_1d(xs, x1, x2, sx) + _box_blur_1d(-xs, x1, x2, sx)
          + _box_blur_1d(2.0 * W - xs, x1, x2, sx))
    fy = (_box_blur_1d(ys, y1, y2, sy) + _box_blur_1d(-ys, y1, y2, sy)
          + _box_blur_1d(2.0 * H - ys, y1, y2, sy))
    m = (np.clip(np.asarray(fy), 0, 1)[:, None]
         * np.clip(np.asarray(fx), 0, 1)[None, :])
    return np.repeat(m[:, :, None], 3, axis=2).astype(np.float32)


CFG = dict(num_views=2, severity=10, mixture_width=WIDTH,
           mixture_depth=-1, version="augmix.all", sigma_ratio=0.3,
           spatial_ratio=4, score_thresh=10)


@pytest.mark.parametrize("seed", [1, 2])
def test_composed_strict_photometric(seed):
    """Shared draws + shared masks: the composed device output equals the
    host oracle to quantization (photometric ops are bit-matched
    per-primitive; the chain/mixing arithmetic reassociates f32 sums, so
    a vanishing tail of +-1 rounding flips is allowed)."""
    img = _structured_image()
    t = _draw_table(seed, op_choices=np.arange(N_PHOTO_ALL))
    dev = _device_out(img, t, CFG)
    history = {"fg_mask_list": [_device_mask(b) for b in GT],
               "fg_score_list": [float(s) for s in SCORES]}
    host = oamix_host(img, GT, CFG, history=history,
                      draws=_host_draws(t)).astype(np.float32)
    diff = np.abs(dev - host)
    frac_le1 = float(np.mean(diff <= 1.0))
    assert frac_le1 >= 0.999, f"within +-1/255: {frac_le1:.5f}"
    assert float(diff.max()) <= 2.0, f"max diff {diff.max()}"


@pytest.mark.parametrize("seed", [3])
def test_composed_honest_own_masks(seed):
    """Shared draws, each side's OWN fg masks (documented divergence:
    closed-form erf vs the reference's quarter-res blur+resize): >=99%
    of pixels within the +-2/255 quantization tolerance, and the tail is
    confined to mask-boundary bands (outside them everything is
    within +-2)."""
    img = _structured_image()
    t = _draw_table(seed, op_choices=np.arange(N_PHOTO_ALL))
    dev = _device_out(img, t, CFG)
    host = oamix_host(img, GT, CFG, history={},
                      draws=_host_draws(t)).astype(np.float32)
    diff = np.abs(dev - host)
    frac = float(np.mean(diff <= 2.0))
    assert frac >= 0.99, f"within +-2/255: {frac:.5f}"
    # divergence is confined to the mask-transition bands: where the two
    # mask fields agree closely, the outputs agree to quantization
    dev_masks = np.stack([_device_mask(b)[..., 0] for b in GT])
    from oadg_tpu.data.pipelines.oa_mix_host import _blurred_mask
    host_masks = np.stack([_blurred_mask(b, img.shape)[..., 0]
                           for b in GT])
    band = np.any(np.abs(dev_masks - host_masks) > 0.01, axis=0)
    outside = diff.max(axis=-1)[~band]
    frac_out = float(np.mean(outside <= 2.0))
    assert frac_out >= 0.9995, f"outside bands within 2: {frac_out:.5f}"


def test_composed_bg_geo(seed=4):
    """Composed chains drawing bg-geometry ops (whole-image row-shift warps
    vs cv2.warpAffine) under shared draws + shared masks: the bg
    translate/shear kernels were built for cv2 parity, so the composed
    output stays within a small tolerance (the host quantizes the warped
    keep-mask through uint8, the device keeps it f32 — +-1 differences in
    the blend band are expected; rotate factorizes into 3 shears and is
    excluded here)."""
    img = _structured_image()
    t = _draw_table(seed, op_choices=np.array([13, 14]))  # bg shear/trans
    dev = _device_out(img, t, CFG)
    history = {"fg_mask_list": [_device_mask(b) for b in GT],
               "fg_score_list": [float(s) for s in SCORES]}
    host = oamix_host(img, GT, CFG, history=history,
                      draws=_host_draws(t)).astype(np.float32)
    diff = np.abs(dev - host)
    frac = float(np.mean(diff <= 2.0))
    assert frac >= 0.99, f"within +-2/255: {frac:.5f}"


def _overlap_band(reach: int, gt=None):
    """Pixels whose output can differ between the device's one-pass
    argmax warp and the host's sequential per-box blend (the documented
    oamix_device redesign note 2): anywhere TWO fg masks have support
    within ``reach`` pixels of each other — the host's later boxes read
    already-blended content there, the device reads the original image.
    ``reach`` bounds the warp displacement (severity 10: translate <=
    extent/3, rotate <= 30 deg)."""
    sup = np.stack([_device_mask(b)[..., 0] > 0.01
                    for b in (GT if gt is None else gt)])
    k = reach
    dil = []
    for s in sup:
        # cheap box dilation via cumulative OR shifts
        p = np.pad(s, k)
        acc = np.zeros_like(s)
        for dy in range(-k, k + 1, max(k // 4, 1)):
            for dx in range(-k, k + 1, max(k // 4, 1)):
                acc |= p[k + dy:k + dy + H, k + dx:k + dx + W]
        dil.append(acc)
    dil = np.stack(dil)
    return dil.sum(axis=0) >= 2


@pytest.mark.parametrize("ops,tol_frac", [((10, 11), 0.995),  # shear/trans
                                          ((9,), 0.99)])      # rotate
def test_composed_bbox_geo(ops, tol_frac):
    """Per-box (bboxes_only) geometric chains pinned at quantization
    tolerance with the overlap-blend bands masked.

    The device path is the per-pixel affine gather. Shared draws + shared
    masks isolate the warp arithmetic. The GT layout is two compact,
    well-separated boxes so the blurred-mask tails don't blanket the
    whole 256x384 fixture; outside the documented overlap bands (where
    the host's sequential blend reads already-blended content) outputs
    must agree to +-2/255 on >= tol_frac of pixels.
    Ref: mmdet/datasets/pipelines/bbox_augmentation.py:31-118."""
    img = _structured_image()
    gt2 = np.array([[40.0, 30.0, 100.0, 80.0],
                    [260.0, 170.0, 340.0, 230.0]], np.float32)
    scores2 = np.array([5.0, 20.0], np.float32)
    t = _draw_table(11 + ops[0], op_choices=np.asarray(ops))
    t["fg_scores"] = np.full((MAX_FG,), -1.0, np.float32)
    t["fg_scores"][:2] = scores2
    dev = _device_out(img, t, CFG, gt_in=gt2)
    history = {"fg_mask_list": [_device_mask(b) for b in gt2],
               "fg_score_list": [float(s) for s in scores2]}
    host = oamix_host(img, gt2, CFG, history=history,
                      draws=_host_draws(t, gt=gt2, scores=scores2)
                      ).astype(np.float32)
    diff = np.abs(dev - host).max(axis=-1)
    band = _overlap_band(reach=36, gt=gt2)
    ok = diff[~band]
    assert ok.size > 0.5 * diff.size, (
        f"band masked too much: {band.mean():.3f}")
    frac = float(np.mean(ok <= 2.0))
    assert frac >= tol_frac, (
        f"ops={ops}: within +-2/255 outside bands: "
        f"{frac:.5f} (band {band.mean():.3f} of image)")


def test_draws_none_unchanged():
    """draws=None keeps the production PRNG path bit-identical (the
    golden suite and every existing statistical test depend on it)."""
    img = _structured_image()
    gt = np.zeros((MAX_FG, 4), np.float32)
    gt[:len(GT)] = GT
    gv = np.zeros((MAX_FG,), bool)
    gv[:len(GT)] = True
    args = (jnp.asarray(img, jnp.float32)[None], jnp.asarray(gt)[None],
            jnp.asarray(gv)[None], jnp.asarray([[H, W]], jnp.float32),
            jax.random.PRNGKey(7), CFG)
    a = np.asarray(oamix_batch(*args)["aug"])
    b = np.asarray(oamix_batch(*args, draws=None)["aug"])
    np.testing.assert_array_equal(a, b)
