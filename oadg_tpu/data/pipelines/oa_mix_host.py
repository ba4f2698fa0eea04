"""Host (numpy/cv2/PIL) OA-Mix oracle — a faithful CPU implementation of the
reference algorithm (mmdet/datasets/pipelines/oa_mix.py), written against
this repo's own primitives.

Primary use: the fidelity oracle for the on-device implementation
(ops/oamix_device.py) and a fallback for pipelines that want `img2` etc.
materialized on the host exactly like the reference produced them (the
device path defers augmentation into the train step instead).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


# ------------------------------------------------------------- helpers -----

def _sample_level(n):
    return np.random.uniform(low=0.1, high=n)


def _hard_mask(box, shape):
    """Unblurred box mask (reference oa_mix.py _get_mask without
    spatial/sigma ratios — what get_random_regions uses by default:
    multilevel and oa-random region masks are HARD; only fg masks blur)."""
    h, w = shape[:2]
    x1, y1, x2, y2 = np.asarray(box, np.int32)
    m = np.zeros((h, w, 3), np.float32)
    m[y1:y2, x1:x2, :] = 1.0
    return m


def _blurred_mask(box, shape, spatial_ratio=4, sigma_ratio=0.3):
    """Quarter-res blurred box mask (reference oa_mix.py:74-93)."""
    import cv2
    h, w = shape[:2]
    x1, y1, x2, y2 = (np.asarray(box) // spatial_ratio).astype(np.int32)
    m = np.zeros((h // spatial_ratio, w // spatial_ratio, 3), np.float32)
    m[y1:y2, x1:x2, :] = 1.0
    sx = (x2 - x1) * sigma_ratio / 3 * 2
    sy = (y2 - y1) * sigma_ratio / 3 * 2
    if sx > 0 and sy > 0:
        m = cv2.GaussianBlur(m, (0, 0), sigmaX=sx, sigmaY=sy)
    return cv2.resize(m, (w, h))


def _spectral_saliency_map(crop) -> np.ndarray:
    """Spectral-residual saliency map, a transcription of OpenCV-contrib's
    ``StaticSaliencySpectralResidual`` (saliencySpecializedClasses.cpp /
    staticSaliencySpectralResidual.cpp) using only core cv2 primitives, so
    no contrib build is needed. Validated against the real contrib
    implementation (cv2 4.6.0): per-pixel maps agree to <=2e-2 on
    non-degenerate crops and the uint8-mean scores the reference consumes
    (oa_mix.py:108-110) to <=0.7 — see tests/test_oamix_golden.py's
    vendored-fixture test. Order matters and differs from a naive reading
    of Hou & Zhang '07 (each detail confirmed by disassembling
    libopencv_saliency.so 4.6.0's computeSaliencyImpl): contrib takes
    ``log(magnitude + 1)`` (Scalar 1.0 added before cv::log — this also
    makes exact-zero FFT bins harmless), box-blurs 3x3 BORDER_DEFAULT,
    GaussianBlurs the |idft| magnitude FIRST (Size(5,5), sigmaX=8,
    sigmaY=0) and squares AFTER, normalizes by dividing by the max (not
    min-max), and resizes the map back to the crop size
    (INTER_LINEAR_EXACT both directions) before the caller's mean.
    """
    import cv2
    img = np.asarray(crop, np.uint8)
    g = img if img.ndim == 2 else cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    g = cv2.resize(g, (64, 64), interpolation=cv2.INTER_LINEAR_EXACT)
    real = g.astype(np.float64)
    dft = cv2.dft(cv2.merge([real, np.zeros_like(real)]))
    re, im = cv2.split(dft)
    mag, ang = cv2.cartToPolar(re, im)
    log_amp = cv2.log(mag + 1.0)
    blur = cv2.blur(log_amp, (3, 3))
    mag2 = cv2.exp(log_amp - blur)
    re2, im2 = cv2.polarToCart(mag2, ang)
    inv = cv2.dft(cv2.merge([re2, im2]), flags=cv2.DFT_INVERSE)
    re3, im3 = cv2.split(inv)
    m, _ = cv2.cartToPolar(re3, im3)
    m = cv2.GaussianBlur(m, (5, 5), 8, borderType=cv2.BORDER_DEFAULT)
    m = m * m
    m = (m / max(float(m.max()), 1e-300)).astype(np.float32)
    h, w = img.shape[:2]
    try:
        return cv2.resize(m, (w, h), interpolation=cv2.INTER_LINEAR_EXACT)
    except cv2.error:                                # pragma: no cover
        # some builds reject LINEAR_EXACT on float input; 4.6 accepts it
        return cv2.resize(m, (w, h), interpolation=cv2.INTER_LINEAR)


def _spectral_saliency_score(crop) -> float:
    """Spectral-residual mean score exactly as the reference computes it:
    ``np.mean((saliency_map * 255).astype("uint8"))`` (oa_mix.py:110)."""
    sal = _spectral_saliency_map(crop)
    return float(np.mean((sal * 255).astype(np.uint8)))


def _iou_any(box, boxes) -> float:
    if len(boxes) == 0:
        return 0.0
    boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
    x1 = np.maximum(box[0], boxes[:, 0])
    y1 = np.maximum(box[1], boxes[:, 1])
    x2 = np.minimum(box[2], boxes[:, 2])
    y2 = np.minimum(box[3], boxes[:, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    return float(inter.sum())


def _random_regions(shape, scale, ratio, num_bboxes, existing=None,
                    max_iters=50):
    h, w = shape[:2]
    target = (np.random.randint(*num_bboxes) if isinstance(num_bboxes, tuple)
              else num_bboxes)
    boxes: List[np.ndarray] = []
    for _ in range(max_iters):
        if len(boxes) >= target:
            break
        x1, y1 = np.random.randint(0, w), np.random.randint(0, h)
        s = np.random.uniform(*scale) * h * w
        r = np.random.uniform(*ratio)
        bw, bh = int(np.sqrt(s / r)), int(np.sqrt(s * r))
        if x1 + bw > w or y1 + bh > h:
            continue
        box = np.array([x1, y1, min(x1 + bw, w), min(y1 + bh, h)], np.float32)
        if _iou_any(box, boxes) > 1e-6:
            continue
        boxes.append(box)
    return boxes


# ----------------------------------------------------------------- ops -----

def _pil(img):
    from PIL import Image
    return Image.fromarray(np.asarray(img, np.uint8), "RGB")


def _photo(img, name, severity, level=None):
    from PIL import ImageEnhance, ImageOps
    p = _pil(img)
    if name == "autocontrast":
        return np.asarray(ImageOps.autocontrast(p))
    if name == "equalize":
        return np.asarray(ImageOps.equalize(p))
    if name == "posterize":
        lvl = _sample_level(severity) if level is None else level
        bits = 4 - int(lvl * 4 / 10)
        return np.asarray(ImageOps.posterize(p, max(bits, 1)))
    if name == "solarize":
        lvl = _sample_level(severity) if level is None else level
        thr = 256 - int(lvl * 256 / 10)
        return np.asarray(ImageOps.solarize(p, thr))
    if name == "invert":
        return np.asarray(ImageOps.invert(p))
    enh = {"color": ImageEnhance.Color, "contrast": ImageEnhance.Contrast,
           "brightness": ImageEnhance.Brightness,
           "sharpness": ImageEnhance.Sharpness}[name]
    lvl = _sample_level(severity) if level is None else level
    f = float(lvl) * 1.8 / 10 + 0.1
    return np.asarray(enh(p).enhance(f))


def _geo_matrix(name, severity, center, size_for_level, img_size,
                level=None, sign=None):
    """Forward cv2 matrix for one geometric family draw. ``level``/
    ``sign`` inject the two np.random draws (shared-draw-table parity
    tests); None keeps the reference RNG stream untouched."""
    import cv2
    if name == "rotate":
        lvl = _sample_level(severity) if level is None else level
        deg = int(lvl * 30 / 10)
        neg = (np.random.uniform() > 0.5) if sign is None else (sign < 0)
        if neg:
            deg = -deg
        return cv2.getRotationMatrix2D(center, deg, 1.0)
    if name.startswith("shear"):
        lvl = _sample_level(severity) if level is None else level
        s = float(lvl) * 0.3 / 10
        neg = (np.random.uniform() > 0.5) if sign is None else (sign < 0)
        if neg:
            s = -s
        if name == "shear_x":
            tx = 0.0 if center is None else -s * center[1]
            return np.float32([[1, -s, -tx], [0, 1, 0]])
        ty = 0.0 if center is None else -s * center[0]
        return np.float32([[1, 0, 0], [-s, 1, -ty]])
    # translate
    maxval = size_for_level[0] if name == "translate_x" else size_for_level[1]
    lvl = _sample_level(severity) if level is None else level
    t = int(lvl * (maxval / 3) / 10)
    neg = (np.random.random() > 0.5) if sign is None else (sign < 0)
    if neg:
        t = -t
    if name == "translate_x":
        return np.float32([[1, 0, -t], [0, 1, 0]])
    return np.float32([[1, 0, 0], [0, 1, -t]])


def _pick_family(name, coin=None):
    """Draw the x/y coin ONLY for the xy families — an eager dict literal
    here consumed np.random draws for the unselected families too,
    desynchronizing the RNG stream from the reference (caught by the
    golden parity test). ``coin`` injects the draw (< 0.5 -> x)."""
    if name == "rotate":
        return "rotate"
    if name == "shear_xy":
        c = np.random.rand() if coin is None else coin
        return "shear_x" if c < 0.5 else "shear_y"
    c = np.random.rand() if coin is None else coin
    return "translate_x" if c < 0.5 else "translate_y"


def _bboxes_only(img, name, severity, fg_boxes, fg_masks, levels=None,
                 signs=None, coin=None):
    """Per-box warp blended by blurred masks (bbox_augmentation.py:31-88).
    The blend requantizes to uint8 after EVERY box like the reference
    (each _apply_bbox_only_augmentation call returns uint8) — float
    accumulation here drifted the composed golden test by +-1 per box.
    ``levels``/``signs`` are per-box injected draws."""
    import cv2
    out = np.asarray(img, np.uint8)
    h, w = out.shape[:2]
    fam = _pick_family(name, coin)
    for bi, (box, mask) in enumerate(zip(fg_boxes, fg_masks)):
        x1, y1, x2, y2 = [int(v) for v in box]
        if x2 - x1 < 1 or y2 - y1 < 1:
            continue
        center = ((x1 + x2) / 2.0, (y1 + y2) / 2.0)
        m = _geo_matrix(fam, severity, center, (x2 - x1 + 1, y2 - y1 + 1),
                        (w, h),
                        level=None if levels is None else levels[bi],
                        sign=None if signs is None else signs[bi])
        warped = cv2.warpAffine(out, m, (w, h))
        out = np.asarray(out * (1.0 - mask) + warped * mask, np.uint8)
    return out


def _bg_only(img, name, severity, fg_masks, level=None, sign=None,
             coin=None):
    """Global warp with fg regions preserved (bbox_augmentation.py:240-272)."""
    import cv2
    arr = np.asarray(img, np.uint8)
    h, w = arr.shape[:2]
    fam = _pick_family(name, coin)
    center = (w / 2.0, h / 2.0) if fam == "rotate" else None
    m = _geo_matrix(fam, severity, center, (w, h), (w, h),
                    level=level, sign=sign)
    mask = (np.max(fg_masks, axis=0) if len(fg_masks)
            else np.zeros_like(arr, np.float32))
    warped = cv2.warpAffine(arr, m, (w, h)).astype(np.float32)
    wmask = cv2.warpAffine((mask * 255).astype(np.uint8), m, (w, h)) / 255.0
    keep = np.maximum(mask, wmask)
    out = keep * arr.astype(np.float32) + (1.0 - keep) * warped
    return np.asarray(np.clip(out, 0, 255), np.uint8)


_AUG_OPS = ["autocontrast", "equalize", "posterize", "solarize",
            "bboxes:rotate", "bboxes:shear_xy", "bboxes:translate_xy",
            "bg:rotate", "bg:shear_xy", "bg:translate_xy"]
_AUG_OPS_ALL = (["autocontrast", "equalize", "posterize", "solarize",
                 "invert", "color", "contrast", "brightness", "sharpness"]
                + _AUG_OPS[4:])


def _aug(img, severity, version, fg_boxes, fg_masks, draw=None):
    """One reference aug() call. ``draw`` (shared-draw-table mode) is a
    dict {op: int, level/levels, sign/signs, coin} replacing every
    np.random draw this call would make; None keeps the reference RNG
    stream."""
    ops = _AUG_OPS_ALL if version == "augmix.all" else _AUG_OPS
    if draw is None:
        op = ops[np.random.randint(len(ops))]
        lv = sg = cn = None
        lvs = sgs = None
    else:
        op = ops[int(draw["op"])]
        lvs = draw.get("levels")
        sgs = draw.get("signs")
        lv = draw.get("level", None if lvs is None else float(lvs[0]))
        sg = draw.get("sign", None if sgs is None else float(sgs[0]))
        cn = draw.get("coin")
    if op.startswith("bboxes:"):
        return _bboxes_only(img, op.split(":")[1], severity, fg_boxes,
                            fg_masks, levels=lvs, signs=sgs, coin=cn)
    if op.startswith("bg:"):
        return _bg_only(img, op.split(":")[1], severity, fg_masks,
                        level=lv, sign=sg, coin=cn)
    return _photo(img, op, severity, level=lv)


# ---------------------------------------------------------------- oamix ----

def oamix_host(img: np.ndarray, gt_bboxes: np.ndarray, cfg: Dict,
               history: Optional[Dict] = None,
               draws: Optional[Dict] = None) -> np.ndarray:
    """One augmented view (reference OAMix.oamix, oa_mix.py:207-243).

    ``draws`` (shared-draw-table mode, tests/test_oamix_quantization.py):
    a dict replacing EVERY np.random draw with pinned values so the
    device kernel (ops/oamix_device.py oamix_batch draws=...) and this
    oracle compose the identical augmentation — keys: ws, ml_boxes,
    depth (width,), op (width, depth, slots) dicts, fg_scores, oa_boxes,
    mix_us, m_global. None keeps the reference RNG stream untouched
    (the golden parity suite depends on that)."""
    img = np.asarray(img, np.uint8)
    h, w = img.shape[:2]
    severity = float(cfg.get("severity", 10))
    width = int(cfg.get("mixture_width", 3))
    depth_cfg = int(cfg.get("mixture_depth", -1))
    version = cfg.get("version", "augmix")
    spatial_ratio = int(cfg.get("spatial_ratio", 4))
    sigma_ratio = float(cfg.get("sigma_ratio", 0.3))
    score_thresh = float(cfg.get("score_thresh", 10))
    history = history if history is not None else {}

    if draws is not None:
        ws = np.float32(draws["ws"])
        rand_boxes = [np.asarray(b, np.float32)
                      for b in draws["ml_boxes"]]
    else:
        ws = np.float32(np.random.dirichlet([1.0] * width))
        rand_boxes = _random_regions(
            img.shape, cfg.get("random_box_scale", (0.01, 0.1)),
            cfg.get("random_box_ratio", (3, 1 / 3)), num_bboxes=(1, 3))
    # multilevel region masks are HARD (reference oamix() calls
    # get_random_regions without use_blur)
    rand_masks = [_hard_mask(b, img.shape) for b in rand_boxes]
    history["random_box_list"] = (np.stack(rand_boxes)
                                  if rand_boxes else np.zeros((0, 4)))

    if "fg_mask_list" in history:
        fg_masks = history["fg_mask_list"]
        fg_scores = history["fg_score_list"]
    else:
        fg_masks, fg_scores = [], []
        for bi, box in enumerate(gt_bboxes):
            x1, y1, x2, y2 = np.asarray(box, np.int32)
            if draws is not None:
                fg_scores.append(float(draws["fg_scores"][bi]))
            elif x2 - x1 < spatial_ratio or y2 - y1 < spatial_ratio:
                fg_scores.append(-1.0)
            else:
                fg_scores.append(_spectral_saliency_score(img[y1:y2, x1:x2]))
            fg_masks.append(_blurred_mask(box, img.shape, spatial_ratio,
                                          sigma_ratio))
        history["fg_mask_list"] = fg_masks
        history["fg_score_list"] = fg_scores

    # chain-and-mix
    img_oamix = np.zeros_like(img, np.float32)
    for i in range(width):
        if draws is not None:
            depth = int(draws["depth"][i])
        else:
            depth = depth_cfg if depth_cfg > 0 else np.random.randint(1, 4)
        img_aug = img.copy()
        for d in range(depth):
            tmp = np.zeros_like(img, np.float32)
            for si, mask in enumerate(rand_masks):
                dr = draws["op"][i][d][si] if draws is not None else None
                tmp += mask * _aug(img_aug, severity, version,
                                   gt_bboxes, fg_masks, draw=dr)
            union = (np.max(rand_masks, axis=0) if rand_masks
                     else np.zeros_like(img, np.float32))
            dr = (draws["op"][i][d][len(rand_masks)]
                  if draws is not None else None)
            img_aug = np.asarray(np.clip(
                tmp + (1.0 - union) * _aug(img_aug, severity, version,
                                           gt_bboxes, fg_masks, draw=dr),
                0, 255), np.uint8)
        img_oamix += ws[i] * img_aug.astype(np.float32)

    # object-aware mixing regions
    oa_targets = [(b, m, s) for b, m, s in zip(gt_bboxes, fg_masks, fg_scores)
                  if s <= score_thresh]
    if draws is not None:
        oa_boxes = [np.asarray(b, np.float32) for b in draws["oa_boxes"]]
    else:
        n_oa = min(max(len(oa_targets), 1), 5)
        oa_boxes = _random_regions(
            img.shape, cfg.get("oa_random_box_scale", (0.005, 0.1)),
            cfg.get("oa_random_box_ratio", (3, 1 / 3)), num_bboxes=n_oa)
    history["oa_random_box_list"] = (np.stack(oa_boxes)
                                     if oa_boxes else np.zeros((0, 4)))
    for b in oa_boxes:
        score = float("inf")
        for gb, gs in zip(gt_bboxes, fg_scores):
            if _iou_any(b, [gb]) > 1e-6 and gs < score:
                score = gs
        # oa random-box masks are HARD too (get_random_regions default)
        oa_targets.append((b, _hard_mask(b, img.shape), score))

    return np.asarray(object_aware_mixing(
        img.astype(np.float32), img_oamix,
        [m for _, m, _ in oa_targets], [s for _, _, s in oa_targets],
        score_thresh,
        mix_us=None if draws is None else draws["mix_us"],
        m_global=None if draws is None else draws["m_global"]), np.uint8)


def object_aware_mixing(img, img_aug, mask_list, score_list,
                        score_thresh: float = 10.0, mix_us=None,
                        m_global=None):
    """Sequential overlap-corrected accumulation (reference
    oa_mix.py:281-308 object_aware_mixing) — standalone so the golden
    parity test can drive it with pinned masks/scores. ``mix_us`` /
    ``m_global`` inject the per-region U(0,1) and Beta(1,1) draws
    (shared-draw-table mode): m_oa = u*0.5 for low-score regions else u,
    the same transform the device kernel applies."""
    if m_global is None:
        m_global = np.float32(np.random.beta(1.0, 1.0))
    m_global = np.float32(m_global)
    orig = np.zeros_like(img, np.float32)
    aug = np.zeros_like(img, np.float32)
    mask_sum = np.zeros_like(img, np.float32)
    mask_stack: List[np.ndarray] = []
    for ri, (mask, score) in enumerate(zip(mask_list, score_list)):
        mask_sum = mask_sum + mask
        mask_stack.append(mask)
        mask_max = np.max(mask_stack, axis=0)
        overlap = mask_sum - mask_max
        if mix_us is not None:
            u = np.float32(mix_us[ri])
            m_oa = u * np.float32(0.5) if score <= score_thresh else u
        else:
            m_oa = np.float32(
                np.random.uniform(0.0, 0.5) if score <= score_thresh
                else np.random.uniform(0.0, 1.0))
        orig += (1.0 - m_oa) * img * (mask - overlap * 0.5)
        aug += m_oa * img_aug * (mask - overlap * 0.5)
        mask_sum = mask_max
    out = orig + aug
    out += (1.0 - m_global) * img * (1.0 - mask_sum)
    out += m_global * img_aug * (1.0 - mask_sum)
    return np.clip(out, 0, 255)
