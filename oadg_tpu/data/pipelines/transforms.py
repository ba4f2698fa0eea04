"""Geometric/normalization pipeline transforms (host-side numpy).

Semantic parity with the load-bearing subset of reference
mmdet/datasets/pipelines/transforms.py (SURVEY.md §2.2): ``Resize``
(keep_ratio rescale, 'range'/'value' multiscale, :31), ``RandomFlip``
(:326), ``Pad`` size_divisor (:573), ``Normalize`` (:672), plus
``Corrupt`` (:1277) wired to the in-repo corruption suite,
``PhotoMetricDistortion``, ``RandomCrop``, ``Expand``, ``MinIoURandomCrop``.
All ops loop over ``results['img_fields']`` so multi-view images (OA-Mix)
flow through Normalize/Pad like the reference (:212, :618, :699).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from ...utils.registry import PIPELINES

try:
    import cv2
except ImportError:                                  # pragma: no cover
    cv2 = None


def imrescale(img, scale: Tuple[int, int]):
    """mmcv.imrescale: resize keeping aspect so the image fits (max, min)."""
    h, w = img.shape[:2]
    max_long, max_short = max(scale), min(scale)
    scale_factor = min(max_long / max(h, w), max_short / min(h, w))
    new_w = int(w * scale_factor + 0.5)
    new_h = int(h * scale_factor + 0.5)
    out = cv2.resize(img, (new_w, new_h), interpolation=cv2.INTER_LINEAR)
    return out, scale_factor


@PIPELINES.register_module()
class Resize:
    def __init__(self, img_scale=None, multiscale_mode: str = "range",
                 ratio_range=None, keep_ratio: bool = True,
                 bbox_clip_border: bool = True, override: bool = False,
                 interpolation="bilinear"):
        if img_scale is None:
            self.img_scale = None
        elif isinstance(img_scale, list):
            self.img_scale = [tuple(s) for s in img_scale]
        else:
            self.img_scale = [tuple(img_scale)]
        self.multiscale_mode = multiscale_mode
        self.ratio_range = ratio_range
        self.keep_ratio = keep_ratio
        self.bbox_clip_border = bbox_clip_border
        self.override = override

    def _random_scale(self, results):
        if self.ratio_range is not None:
            scale = self.img_scale[0]
            ratio = np.random.uniform(*self.ratio_range)
            results["scale"] = (int(scale[0] * ratio), int(scale[1] * ratio))
        elif len(self.img_scale) == 1:
            results["scale"] = self.img_scale[0]
        elif self.multiscale_mode == "range":
            longs = [max(s) for s in self.img_scale]
            shorts = [min(s) for s in self.img_scale]
            long_edge = np.random.randint(min(longs), max(longs) + 1)
            short_edge = np.random.randint(min(shorts), max(shorts) + 1)
            results["scale"] = (long_edge, short_edge)
        else:                                          # 'value'
            idx = np.random.randint(len(self.img_scale))
            results["scale"] = self.img_scale[idx]

    def __call__(self, results: Dict[str, Any]):
        if "scale" not in results:
            self._random_scale(results)
        for key in results.get("img_fields", ["img"]):
            img = results[key]
            if self.keep_ratio:
                img, sf = imrescale(img, results["scale"])
                scale_factor = np.array([sf, sf, sf, sf], np.float32)
            else:
                h, w = img.shape[:2]
                tw, th = max(results["scale"]), min(results["scale"])
                img = cv2.resize(img, (tw, th), interpolation=cv2.INTER_LINEAR)
                scale_factor = np.array([tw / w, th / h, tw / w, th / h],
                                        np.float32)
            results[key] = img
        results["img_shape"] = img.shape
        results["pad_shape"] = img.shape
        results["scale_factor"] = scale_factor
        results["keep_ratio"] = self.keep_ratio
        h, w = img.shape[:2]
        for key in results.get("bbox_fields", []):
            bboxes = results[key] * scale_factor
            if self.bbox_clip_border:
                bboxes[:, 0::2] = np.clip(bboxes[:, 0::2], 0, w)
                bboxes[:, 1::2] = np.clip(bboxes[:, 1::2], 0, h)
            results[key] = bboxes
        return results


@PIPELINES.register_module()
class RandomFlip:
    def __init__(self, flip_ratio: Optional[float] = None,
                 direction: str = "horizontal"):
        self.flip_ratio = flip_ratio
        self.direction = direction

    def __call__(self, results: Dict[str, Any]):
        if "flip" not in results:
            flip = (self.flip_ratio is not None
                    and np.random.rand() < self.flip_ratio)
            results["flip"] = flip
            results["flip_direction"] = self.direction
        if results["flip"]:
            for key in results.get("img_fields", ["img"]):
                results[key] = np.ascontiguousarray(
                    results[key][:, ::-1] if results["flip_direction"] ==
                    "horizontal" else results[key][::-1])
            h, w = results["img_shape"][:2]
            for key in results.get("bbox_fields", []):
                b = results[key].copy()
                if results["flip_direction"] == "horizontal":
                    b[..., 0], b[..., 2] = w - results[key][..., 2], \
                        w - results[key][..., 0]
                else:
                    b[..., 1], b[..., 3] = h - results[key][..., 3], \
                        h - results[key][..., 1]
                results[key] = b
            for key in results.get("mask_fields", []):
                # box-cropped (N, M0, M0) masks flip within their crop
                axis = 2 if results["flip_direction"] == "horizontal" else 1
                results[key] = np.ascontiguousarray(
                    np.flip(results[key], axis=axis))
        return results


@PIPELINES.register_module()
class Normalize:
    def __init__(self, mean, std, to_rgb: bool = True):
        self.mean = np.array(mean, np.float32)
        self.std = np.array(std, np.float32)
        self.to_rgb = to_rgb

    def __call__(self, results: Dict[str, Any]):
        results["img_norm_cfg"] = dict(mean=self.mean, std=self.std,
                                       to_rgb=self.to_rgb)
        if results.get("norm_on_device"):
            # on-device OA-Mix path: the device preprocess normalizes the
            # clean view AND the aug views on-chip from the raw uint8
            # batch (engine/preprocess.py) — the host math here (the
            # largest host pipeline cost) is skipped and pixels stay uint8 through collate.
            return results
        inv_std = (1.0 / self.std).astype(np.float32)
        for key in results.get("img_fields", ["img"]):
            img = results[key].astype(np.float32)
            if self.to_rgb:
                img = img[..., ::-1]
            img -= self.mean
            img *= inv_std
            results[key] = img
        return results


@PIPELINES.register_module()
class Pad:
    def __init__(self, size=None, size_divisor: Optional[int] = None,
                 pad_to_square: bool = False, pad_val=0):
        self.size = size
        self.size_divisor = size_divisor
        self.pad_val = pad_val if not isinstance(pad_val, dict) else \
            pad_val.get("img", 0)

    def __call__(self, results: Dict[str, Any]):
        for key in results.get("img_fields", ["img"]):
            img = results[key]
            h, w = img.shape[:2]
            if self.size is not None:
                th, tw = self.size
            else:
                d = self.size_divisor
                th, tw = ((h + d - 1) // d) * d, ((w + d - 1) // d) * d
            padded = np.full((th, tw) + img.shape[2:], self.pad_val,
                             img.dtype)
            padded[:h, :w] = img
            results[key] = padded
        results["pad_shape"] = results[key].shape
        results["pad_fixed_size"] = self.size
        results["pad_size_divisor"] = self.size_divisor
        return results


@PIPELINES.register_module()
class Corrupt:
    """On-the-fly corruption (reference transforms.py:1277) backed by the
    in-repo corruption suite (ops/corruptions.py) instead of the
    ``imagecorruptions`` package."""

    def __init__(self, corruption: str, severity: int = 1):
        self.corruption = corruption
        self.severity = severity

    def __call__(self, results: Dict[str, Any]):
        if self.severity == 0:
            return results
        from ...ops.corruptions import corrupt_numpy
        results["img"] = corrupt_numpy(results["img"],
                                       corruption_name=self.corruption,
                                       severity=self.severity)
        return results


@PIPELINES.register_module()
class PhotoMetricDistortion:
    """SSD-style photometric distortion (reference transforms.py:941)."""

    def __init__(self, brightness_delta=32, contrast_range=(0.5, 1.5),
                 saturation_range=(0.5, 1.5), hue_delta=18):
        self.brightness_delta = brightness_delta
        self.contrast_lower, self.contrast_upper = contrast_range
        self.saturation_lower, self.saturation_upper = saturation_range
        self.hue_delta = hue_delta

    def __call__(self, results):
        img = results["img"].astype(np.float32)
        if np.random.randint(2):
            img += np.random.uniform(-self.brightness_delta,
                                     self.brightness_delta)
        mode = np.random.randint(2)
        if mode == 1 and np.random.randint(2):
            img *= np.random.uniform(self.contrast_lower, self.contrast_upper)
        hsv = cv2.cvtColor(np.clip(img, 0, 255).astype(np.uint8),
                           cv2.COLOR_BGR2HSV).astype(np.float32)
        if np.random.randint(2):
            hsv[..., 1] *= np.random.uniform(self.saturation_lower,
                                             self.saturation_upper)
        if np.random.randint(2):
            hsv[..., 0] = (hsv[..., 0] + np.random.uniform(
                -self.hue_delta, self.hue_delta)) % 180
        img = cv2.cvtColor(np.clip(hsv, 0, 255).astype(np.uint8),
                           cv2.COLOR_HSV2BGR).astype(np.float32)
        if mode == 0 and np.random.randint(2):
            img *= np.random.uniform(self.contrast_lower, self.contrast_upper)
        results["img"] = np.clip(img, 0, 255)
        return results


@PIPELINES.register_module()
class RandomCrop:
    def __init__(self, crop_size, crop_type="absolute",
                 allow_negative_crop=False, bbox_clip_border=True):
        self.crop_size = crop_size
        self.allow_negative_crop = allow_negative_crop
        self.bbox_clip_border = bbox_clip_border

    def __call__(self, results):
        img = results["img"]
        h, w = img.shape[:2]
        ch = min(self.crop_size[0], h)
        cw = min(self.crop_size[1], w)
        y0 = np.random.randint(0, h - ch + 1)
        x0 = np.random.randint(0, w - cw + 1)
        for key in results.get("img_fields", ["img"]):
            results[key] = results[key][y0:y0 + ch, x0:x0 + cw]
        results["img_shape"] = results["img"].shape
        for key in results.get("bbox_fields", []):
            b = results[key] - np.array([x0, y0, x0, y0], np.float32)
            if self.bbox_clip_border:
                b[:, 0::2] = np.clip(b[:, 0::2], 0, cw)
                b[:, 1::2] = np.clip(b[:, 1::2], 0, ch)
            keep = (b[:, 2] > b[:, 0]) & (b[:, 3] > b[:, 1])
            results[key] = b[keep]
            if key == "gt_bboxes" and "gt_labels" in results:
                results["gt_labels"] = results["gt_labels"][keep]
        return results


@PIPELINES.register_module()
class Expand:
    """Random canvas expansion (reference transforms.py:1045)."""

    def __init__(self, mean=(0, 0, 0), to_rgb=True, ratio_range=(1, 4),
                 prob=0.5):
        self.mean = mean
        self.to_rgb = to_rgb
        self.min_ratio, self.max_ratio = ratio_range
        self.prob = prob

    def __call__(self, results):
        if np.random.uniform(0, 1) > self.prob:
            return results
        img = results["img"]
        h, w, c = img.shape
        ratio = np.random.uniform(self.min_ratio, self.max_ratio)
        eh, ew = int(h * ratio), int(w * ratio)
        top = int(np.random.uniform(0, eh - h))
        left = int(np.random.uniform(0, ew - w))
        mean = self.mean[::-1] if self.to_rgb else self.mean
        canvas = np.full((eh, ew, c), mean, dtype=img.dtype)
        canvas[top:top + h, left:left + w] = img
        results["img"] = canvas
        results["img_shape"] = canvas.shape
        for key in results.get("bbox_fields", []):
            results[key] = results[key] + np.array(
                [left, top, left, top], np.float32)
        return results


@PIPELINES.register_module()
class MinIoURandomCrop:
    """IoU-constrained random crop (reference transforms.py:1137)."""

    def __init__(self, min_ious=(0.1, 0.3, 0.5, 0.7, 0.9), min_crop_size=0.3,
                 bbox_clip_border=True):
        self.min_ious = (1, *min_ious, 0)
        self.min_crop_size = min_crop_size
        self.bbox_clip_border = bbox_clip_border

    def __call__(self, results):
        from ...core.bbox.geometry import bbox_overlaps_np
        img = results["img"]
        h, w = img.shape[:2]
        boxes = results.get("gt_bboxes", np.zeros((0, 4), np.float32))
        while True:
            mode = self.min_ious[np.random.randint(len(self.min_ious))]
            if mode == 1:
                return results
            for _ in range(50):
                new_w = np.random.uniform(self.min_crop_size * w, w)
                new_h = np.random.uniform(self.min_crop_size * h, h)
                if new_h / new_w < 0.5 or new_h / new_w > 2:
                    continue
                left = np.random.uniform(w - new_w)
                top = np.random.uniform(h - new_h)
                patch = np.array([int(left), int(top), int(left + new_w),
                                  int(top + new_h)])
                if len(boxes):
                    ious = bbox_overlaps_np(
                        boxes, patch[None].astype(np.float32)).reshape(-1)
                    if len(ious) and ious.min() < mode:
                        continue
                    centers = (boxes[:, :2] + boxes[:, 2:]) / 2
                    mask = ((centers[:, 0] > patch[0])
                            & (centers[:, 1] > patch[1])
                            & (centers[:, 0] < patch[2])
                            & (centers[:, 1] < patch[3]))
                    if not mask.any():
                        continue
                else:
                    mask = np.zeros(0, bool)
                for key in results.get("img_fields", ["img"]):
                    results[key] = results[key][patch[1]:patch[3],
                                                patch[0]:patch[2]]
                results["img_shape"] = results["img"].shape
                if len(boxes):
                    kept = boxes[mask] - np.tile(patch[:2], 2)
                    if self.bbox_clip_border:
                        kept[:, 0::2] = kept[:, 0::2].clip(0, patch[2] - patch[0])
                        kept[:, 1::2] = kept[:, 1::2].clip(0, patch[3] - patch[1])
                    results["gt_bboxes"] = kept.astype(np.float32)
                    if "gt_labels" in results:
                        results["gt_labels"] = results["gt_labels"][mask]
                return results


@PIPELINES.register_module()
class CutOut:
    """Random square dropout (reference transforms.py CutOut)."""

    def __init__(self, n_holes, cutout_shape=None, cutout_ratio=None,
                 fill_in=(0, 0, 0)):
        self.n_holes = n_holes if isinstance(n_holes, tuple) else (n_holes,
                                                                   n_holes)
        self.shape = cutout_shape
        self.ratio = cutout_ratio
        self.fill_in = fill_in

    def __call__(self, results):
        img = results["img"]
        h, w = img.shape[:2]
        n = np.random.randint(self.n_holes[0], self.n_holes[1] + 1)
        for _ in range(n):
            x = np.random.randint(0, w)
            y = np.random.randint(0, h)
            if self.ratio is not None:
                cand = self.ratio
                cw, ch_ = cand[np.random.randint(len(cand))] if \
                    isinstance(cand[0], (tuple, list)) else cand
                cw, ch_ = int(cw * w), int(ch_ * h)
            else:
                cand = self.shape
                cw, ch_ = cand[np.random.randint(len(cand))] if \
                    isinstance(cand[0], (tuple, list)) else cand
            x2 = np.clip(x + cw, 0, w)
            y2 = np.clip(y + ch_, 0, h)
            img[y:y2, x:x2] = self.fill_in
        results["img"] = img
        return results


@PIPELINES.register_module()
class RandomShift:
    """Integer-pixel image+bbox shift (reference transforms.py RandomShift).

    With probability ``shift_ratio`` draws integer shifts in
    [-max_shift_px, max_shift_px] per axis, translates all bbox_fields
    (clipped to the image), drops boxes whose w/h fall to
    ``filter_thr_px`` or less, and pastes the image onto a zero canvas at
    the shifted position. If the shift would leave no valid gt box the
    sample is returned unchanged (reference semantics).
    """

    def __init__(self, shift_ratio=0.5, max_shift_px=32, filter_thr_px=1):
        assert 0 <= shift_ratio <= 1 and max_shift_px >= 0
        self.shift_ratio = shift_ratio
        self.max_shift_px = max_shift_px
        self.filter_thr_px = int(filter_thr_px)

    def __call__(self, results):
        if np.random.rand() >= self.shift_ratio:
            return results
        h, w = results["img"].shape[:2]
        sx = np.random.randint(-self.max_shift_px, self.max_shift_px + 1)
        sy = np.random.randint(-self.max_shift_px, self.max_shift_px + 1)

        shifted = {}
        for key in results.get("bbox_fields", []):
            b = results[key].copy()
            b[..., 0::2] = np.clip(b[..., 0::2] + sx, 0, w)
            b[..., 1::2] = np.clip(b[..., 1::2] + sy, 0, h)
            keep = ((b[..., 2] - b[..., 0] > self.filter_thr_px)
                    & (b[..., 3] - b[..., 1] > self.filter_thr_px))
            if key == "gt_bboxes" and not keep.any():
                return results
            shifted[key] = (b[keep], keep)
        for key, (b, keep) in shifted.items():
            results[key] = b
            if key == "gt_bboxes" and "gt_labels" in results:
                results["gt_labels"] = results["gt_labels"][keep]
        for key in results.get("img_fields", ["img"]):
            img = results[key]
            canvas = np.zeros_like(img)
            nh, nw = h - abs(sy), w - abs(sx)
            dy, oy = max(0, sy), max(0, -sy)
            dx, ox = max(0, sx), max(0, -sx)
            canvas[dy:dy + nh, dx:dx + nw] = img[oy:oy + nh, ox:ox + nw]
            results[key] = canvas
        return results


@PIPELINES.register_module()
class SegRescale:
    """Rescale seg_fields by a fixed factor, nearest-neighbour (reference
    transforms.py SegRescale)."""

    def __init__(self, scale_factor=1, backend="cv2"):
        self.scale_factor = scale_factor

    def __call__(self, results):
        if self.scale_factor == 1:
            return results
        for key in results.get("seg_fields", []):
            seg = results[key]
            h, w = seg.shape[:2]
            nw = int(w * self.scale_factor + 0.5)
            nh = int(h * self.scale_factor + 0.5)
            results[key] = cv2.resize(seg, (nw, nh),
                                      interpolation=cv2.INTER_NEAREST)
        return results


@PIPELINES.register_module()
class YOLOXHSVRandomAug:
    """YOLOX-style random HSV jitter (reference transforms.py
    YOLOXHSVRandomAug): per-channel integer gains, hue wraps mod 180,
    saturation/value clip to [0, 255]."""

    def __init__(self, hue_delta=5, saturation_delta=30, value_delta=30):
        self.hue_delta = hue_delta
        self.saturation_delta = saturation_delta
        self.value_delta = value_delta

    def __call__(self, results):
        img = results["img"]
        deltas = (self.hue_delta, self.saturation_delta, self.value_delta)
        gains = (np.random.uniform(-1, 1, 3) * deltas
                 * np.random.randint(0, 2, 3)).astype(np.int16)
        hsv = cv2.cvtColor(img.astype(np.uint8),
                           cv2.COLOR_BGR2HSV).astype(np.int16)
        hsv[..., 0] = (hsv[..., 0] + gains[0]) % 180
        hsv[..., 1] = np.clip(hsv[..., 1] + gains[1], 0, 255)
        hsv[..., 2] = np.clip(hsv[..., 2] + gains[2], 0, 255)
        results["img"] = cv2.cvtColor(hsv.astype(np.uint8),
                                      cv2.COLOR_HSV2BGR).astype(img.dtype)
        return results


@PIPELINES.register_module()
class UniformNoise:
    """Additive uniform noise in normalized [0,1] space (reference
    transforms.py UniformNoise)."""

    def __init__(self, low=0.0, high=0.01):
        self.low = low
        self.high = high

    def __call__(self, results):
        img = results["img"]
        noise = np.random.uniform(self.low, self.high, img.shape)
        results["img"] = np.clip(img / 255.0 + noise, 0, 1) * 255
        return results


@PIPELINES.register_module()
class GaussianNoise:
    """Additive Gaussian noise in normalized [0,1] space, applied with
    probability ``prob`` (reference transforms.py GaussianNoise)."""

    def __init__(self, mean=0.0, scale=0.08, prob=0.5):
        self.mean = mean
        self.scale = scale
        self.prob = prob

    def __call__(self, results):
        if np.random.rand() >= self.prob:
            return results
        img = results["img"]
        noise = np.random.normal(self.mean, self.scale, img.shape)
        results["img"] = np.clip(img / 255.0 + noise, 0, 1) * 255
        return results


@PIPELINES.register_module()
class RandomCenterCropPad:
    """CornerNet-style random center crop with around-padding (reference
    transforms.py RandomCenterCropPad).

    Train: output shape = random ratio x crop_size; a random center is
    drawn inside a border-restricted range; the overlap with the original
    image is pasted centered onto a mean-filled canvas; boxes whose center
    falls outside the cropped patch are dropped. Test: pads the whole image
    around its center to ``logical_or``/``size_divisor`` shape and records
    the paste ``border``.
    """

    def __init__(self, crop_size=None, ratios=(0.9, 1.0, 1.1), border=128,
                 mean=None, std=None, to_rgb=None, test_mode=False,
                 test_pad_mode=("logical_or", 127), test_pad_add_pix=0,
                 bbox_clip_border=True):
        assert mean is not None and std is not None and to_rgb is not None
        self.crop_size = crop_size
        self.ratios = ratios
        self.border = border
        self.mean = list(mean[::-1]) if to_rgb else list(mean)
        self.test_mode = test_mode
        self.test_pad_mode = test_pad_mode
        self.test_pad_add_pix = test_pad_add_pix
        self.bbox_clip_border = bbox_clip_border

    @staticmethod
    def _center_border(border, size):
        # shrink the border by powers of 2 until a non-empty center range
        # remains (reference _get_border)
        k = 2 * border / size
        i = 2 ** (np.ceil(np.log2(np.ceil(k))) + (k == int(k)))
        return int(border // i)

    def _paste(self, img, cy, cx, th, tw):
        h, w, c = img.shape
        x0, x1 = max(0, cx - tw // 2), min(cx + tw // 2, w)
        y0, y1 = max(0, cy - th // 2), min(cy + th // 2, h)
        canvas = np.empty((th, tw, c), img.dtype)
        canvas[...] = self.mean
        ccy, ccx = th // 2, tw // 2
        top, bottom = cy - y0, y1 - cy
        left, right = cx - x0, x1 - cx
        canvas[ccy - top:ccy + bottom, ccx - left:ccx + right] = \
            img[y0:y1, x0:x1]
        border = np.array([ccy - top, ccy + bottom, ccx - left, ccx + right],
                          np.float32)
        return canvas, border, np.array([x0, y0, x1, y1])

    @staticmethod
    def _center_in(patch, boxes):
        c = (boxes[:, :2] + boxes[:, 2:4]) / 2
        return ((c[:, 0] > patch[0]) & (c[:, 1] > patch[1])
                & (c[:, 0] < patch[2]) & (c[:, 1] < patch[3]))

    def __call__(self, results):
        img = results["img"]
        assert img.dtype == np.float32, (
            "RandomCenterCropPad needs float32 input (set to_float32=True "
            "in LoadImageFromFile)")
        h, w, _ = img.shape
        if self.test_mode:
            mode, val = self.test_pad_mode[0], self.test_pad_mode[1]
            if mode == "logical_or":
                th = (h | val) + self.test_pad_add_pix
                tw = (w | val) + self.test_pad_add_pix
            else:                                       # 'size_divisor'
                th = int(np.ceil(h / val)) * val
                tw = int(np.ceil(w / val)) * val
            canvas, border, _ = self._paste(img, h // 2, w // 2, th, tw)
            results["img"] = canvas
            results["img_shape"] = (h, w, img.shape[2])
            results["pad_shape"] = canvas.shape
            results["border"] = border
            return results

        boxes = results.get("gt_bboxes", np.zeros((0, 4), np.float32))
        while True:
            ratio = self.ratios[np.random.randint(len(self.ratios))]
            th = int(self.crop_size[0] * ratio)
            tw = int(self.crop_size[1] * ratio)
            hb = self._center_border(self.border, h)
            wb = self._center_border(self.border, w)
            for _ in range(50):
                cx = np.random.randint(wb, w - wb)
                cy = np.random.randint(hb, h - hb)
                canvas, _, patch = self._paste(img, cy, cx, th, tw)
                if len(boxes) and not self._center_in(patch, boxes).any():
                    continue
                results["img"] = canvas
                results["img_shape"] = canvas.shape
                results["pad_shape"] = canvas.shape
                x0, y0 = patch[0], patch[1]
                off_x = tw // 2 - (cx - x0) - x0
                off_y = th // 2 - (cy - y0) - y0
                for key in results.get("bbox_fields", []):
                    mask = self._center_in(patch, results[key])
                    b = results[key][mask].copy()
                    b[:, 0:4:2] += off_x
                    b[:, 1:4:2] += off_y
                    if self.bbox_clip_border:
                        b[:, 0:4:2] = np.clip(b[:, 0:4:2], 0, tw)
                        b[:, 1:4:2] = np.clip(b[:, 1:4:2], 0, th)
                    keep = (b[:, 2] > b[:, 0]) & (b[:, 3] > b[:, 1])
                    results[key] = b[keep]
                    if key == "gt_bboxes" and "gt_labels" in results:
                        results["gt_labels"] = \
                            results["gt_labels"][mask][keep]
                return results


@PIPELINES.register_module()
class InstaBoost:
    """Instance crop-jitter-paste augmentation (reference
    pipelines/instaboost.py:8, which wraps the ``instaboostfast``
    package — not available here). This is a self-contained cv2
    reimplementation of the core InstaBoost move: with probability
    ``aug_ratio``, each masked instance is cut out, its hole inpainted,
    and the instance re-pasted at a jittered position/scale/flip drawn
    from the same parameter ranges the reference configures. The
    package's appearance-consistency heatmap guidance (paper §3.2) is
    implemented in ``_heatmap_offsets`` and enabled by ``hflag=True``
    (the package's flag, default False in every reference config):
    candidate (dx, dy) jitters are drawn from a softmax over background-
    appearance similarity between the shifted and original box contours
    instead of uniformly.
    """

    def __init__(self, action_candidate=("normal", "horizontal", "skip"),
                 action_prob=(1, 0, 0), scale=(0.8, 1.2), dx=15, dy=15,
                 theta=(-1, 1), color_prob=0.5, hflag=False,
                 aug_ratio=0.5):
        self.action_candidate = action_candidate
        self.action_prob = action_prob
        self.scale = scale
        self.dx = dx
        self.dy = dy
        self.theta = theta
        self.color_prob = color_prob
        self.hflag = hflag
        self.aug_ratio = aug_ratio

    @staticmethod
    def _box_sums(ii, cnt, y1, x1, y2, x2):
        """Inclusive-exclusive box sums from integral images; coords may be
        arrays (broadcast) and are clipped to the image."""
        h = ii.shape[0] - 1
        w = ii.shape[1] - 1
        y1 = np.clip(y1, 0, h)
        y2 = np.clip(y2, 0, h)
        x1 = np.clip(x1, 0, w)
        x2 = np.clip(x2, 0, w)
        s = (ii[y2, x2] - ii[y1, x2] - ii[y2, x1] + ii[y1, x1])
        n = (cnt[y2, x2] - cnt[y1, x2] - cnt[y2, x1] + cnt[y1, x1])
        return s, np.maximum(n, 1.0)

    def _heatmap_offsets(self, img, x1, y1, x2, y2):
        """InstaBoost appearance-consistency heatmap (paper 'InstaBoost',
        Fang et al. 2019, §3.2 — the guidance behind the package's
        ``hflag`` used by reference
        mmdet/datasets/pipelines/instaboost.py:8): each candidate jitter
        (tx, ty) in the configured window is scored by the similarity of
        the background appearance in three nested contour rings around
        the shifted box vs the original box (ring RGB means, decaying
        weights), and the jitter is sampled from the normalized heatmap.
        High-contrast boundaries therefore repel paste positions. Rings
        are evaluated with integral images: the full (2dy+1, 2dx+1)
        heatmap costs a handful of O(1) lookups per offset."""
        h, w = img.shape[:2]
        f = img.astype(np.float64)
        ii = np.zeros((h + 1, w + 1, 3))
        ii[1:, 1:] = f.cumsum(0).cumsum(1)
        cnt = np.zeros((h + 1, w + 1))
        cnt[1:, 1:] = 1.0
        cnt = cnt.cumsum(0).cumsum(1)
        side = max(x2 - x1, y2 - y1)
        radii = [max(int(side * r), 2) for r in (0.1, 0.25, 0.45)]
        weights = (0.5, 0.3, 0.2)

        tys = np.arange(-self.dy, self.dy + 1)[:, None]
        txs = np.arange(-self.dx, self.dx + 1)[None, :]

        def ring_mean(oy, ox):
            """(offsets..., 3) mean color of each ring around the shifted
            box; ring k = dilate(r_k) minus dilate(r_{k-1})."""
            means = []
            prev_s = prev_n = None
            inner_s, inner_n = self._box_sums(ii, cnt, y1 + oy, x1 + ox,
                                              y2 + oy, x2 + ox)
            prev_s, prev_n = inner_s, inner_n
            for r in radii:
                s, n = self._box_sums(ii, cnt, y1 - r + oy, x1 - r + ox,
                                      y2 + r + oy, x2 + r + ox)
                ring_n = np.maximum(n - prev_n, 1.0)
                means.append((s - prev_s) / ring_n[..., None])
                prev_s, prev_n = s, n
            return means

        orig = ring_mean(0, 0)
        cand = ring_mean(tys, txs)
        dist = np.zeros((tys.shape[0], txs.shape[1]))
        for wgt, mo, mc in zip(weights, orig, cand):
            dist += wgt * np.linalg.norm(mc - mo[None, None, :], axis=-1)
        # keep the shifted box inside the image
        feas = ((x1 + txs >= 0) & (x2 + txs <= w)
                & (y1 + tys >= 0) & (y2 + tys <= h))
        tau = max(np.median(dist[feas]) if feas.any() else 1.0, 1e-3)
        prob = np.exp(-dist / tau) * feas
        total = prob.sum()
        if total <= 0:
            return 0, 0
        flat = np.random.choice(prob.size, p=(prob / total).ravel())
        oy, ox = np.unravel_index(flat, prob.shape)
        return int(txs[0, ox]), int(tys[oy, 0])

    def _paste_one(self, img, mask):
        import cv2
        h, w = img.shape[:2]
        m8 = (np.asarray(mask) > 0).astype(np.uint8)
        if m8.sum() < 16:
            return img, mask
        act = np.random.choice(self.action_candidate,
                               p=np.asarray(self.action_prob, float)
                               / max(sum(self.action_prob), 1e-9))
        if act == "skip":
            return img, mask
        ys, xs = np.nonzero(m8)
        x1, x2, y1, y2 = xs.min(), xs.max() + 1, ys.min(), ys.max() + 1
        patch = img[y1:y2, x1:x2].copy()
        pmask = m8[y1:y2, x1:x2].copy()
        # inpaint the hole
        img = cv2.inpaint(img, m8 * 255, 3, cv2.INPAINT_TELEA)
        # jittered placement: heatmap-guided when hflag (package parity),
        # uniform otherwise
        s = np.random.uniform(*self.scale)
        if self.hflag:
            tx, ty = self._heatmap_offsets(img, x1, y1, x2, y2)
        else:
            tx = int(np.random.uniform(-self.dx, self.dx))
            ty = int(np.random.uniform(-self.dy, self.dy))
        ang = np.random.uniform(*self.theta)
        ph, pw = max(int(pmask.shape[0] * s), 1), max(
            int(pmask.shape[1] * s), 1)
        patch = cv2.resize(patch, (pw, ph))
        pmask = cv2.resize(pmask, (pw, ph),
                           interpolation=cv2.INTER_NEAREST)
        if act == "horizontal":
            patch, pmask = patch[:, ::-1], pmask[:, ::-1]
        if abs(ang) > 1e-3:
            M = cv2.getRotationMatrix2D((pw / 2, ph / 2), ang, 1.0)
            patch = cv2.warpAffine(patch, M, (pw, ph))
            pmask = cv2.warpAffine(pmask, M, (pw, ph),
                                   flags=cv2.INTER_NEAREST)
        nx1 = int(np.clip(x1 + tx, 0, max(w - pw, 0)))
        ny1 = int(np.clip(y1 + ty, 0, max(h - ph, 0)))
        pw = min(pw, w - nx1)
        ph = min(ph, h - ny1)
        patch, pmask = patch[:ph, :pw], pmask[:ph, :pw]
        region = img[ny1:ny1 + ph, nx1:nx1 + pw]
        sel = pmask.astype(bool)
        region[sel] = patch[sel]
        new_mask = np.zeros_like(m8)
        new_mask[ny1:ny1 + ph, nx1:nx1 + pw] = pmask
        return img, new_mask

    def __call__(self, results):
        if np.random.uniform() > self.aug_ratio:
            return results
        masks = results.get("gt_masks")
        if masks is None or len(getattr(masks, "masks", masks)) == 0:
            return results
        arrs = getattr(masks, "masks", masks)
        img = np.ascontiguousarray(results["img"]).astype(np.uint8)
        new_masks = []
        boxes = []
        for m in arrs:
            img, nm = self._paste_one(img, m)
            new_masks.append(nm)
            ys, xs = np.nonzero(nm)
            if len(xs):
                boxes.append([xs.min(), ys.min(), xs.max() + 1,
                              ys.max() + 1])
            else:
                boxes.append([0, 0, 0, 0])
        results["img"] = img.astype(results["img"].dtype)
        if hasattr(masks, "masks"):
            from ...core.mask.structures import BitmapMasks
            results["gt_masks"] = BitmapMasks(new_masks, img.shape[0],
                                              img.shape[1])
        else:
            results["gt_masks"] = np.stack(new_masks)
        results["gt_bboxes"] = np.asarray(boxes, np.float32)
        return results
