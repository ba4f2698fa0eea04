"""In-repo ``Albu`` pipeline op (reference
mmdet/datasets/pipelines/transforms.py:1321).

The reference wraps the external ``albumentations`` package, which is not
available in this image.  This module reimplements (a) the mmdet wrapper
contract — keymap, pascal_voc bbox threading, ``filter_lost_elements``
via the idx_mapper pseudo-field, ``skip_img_without_anno`` returning None,
``update_pad_shape`` — and (b) the albumentations ops that mmdet configs
commonly put inside it (the reference docstring's own example uses
ShiftScaleRotate / RandomBrightnessContrast / ChannelShuffle / OneOf /
Blur / MedianBlur), each following the published albumentations semantics
(parameter ranges, probability gates, border behavior) with cv2/numpy.

Unsupported op names raise loudly at construction, like the reference does
for a missing albumentations install.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional

import numpy as np

from ...utils.registry import PIPELINES


def _to_tuple(limit, low=None):
    """albumentations-style limit: scalar x -> (-x, x); pair kept as-is."""
    if isinstance(limit, (tuple, list)):
        return float(limit[0]), float(limit[1])
    x = float(limit)
    return (low if low is not None else -x), x


class _AlbuOp:
    """Base op: probability gate + image/bbox hooks."""

    def __init__(self, p: float = 0.5):
        self.p = float(p)

    # ops that move pixels override both; photometric ops only the image
    def apply(self, img: np.ndarray) -> np.ndarray:
        return img

    def apply_bboxes(self, bboxes: np.ndarray, h: int, w: int) -> np.ndarray:
        return bboxes

    def sample(self):
        """Draw this call's parameters (so image+bboxes see the same)."""

    def __call__(self, img, bboxes, h, w):
        if np.random.random() >= self.p:
            return img, bboxes
        self.sample()
        return self.apply(img), self.apply_bboxes(bboxes, h, w)


class ShiftScaleRotate(_AlbuOp):
    """albumentations.ShiftScaleRotate: one warpAffine combining a shift
    (fraction of the side), uniform scale and rotation about the center;
    bboxes map through the same matrix corner-wise (enclosing box)."""

    def __init__(self, shift_limit=0.0625, scale_limit=0.1, rotate_limit=45,
                 interpolation=1, border_mode=4, value=None, p=0.5):
        # 1, 4: cv2.INTER_LINEAR, cv2.BORDER_REFLECT_101 (cv2 is imported
        # only where an op runs)
        super().__init__(p)
        self.shift_limit = _to_tuple(shift_limit)
        self.scale_limit = _to_tuple(scale_limit)
        self.rotate_limit = _to_tuple(rotate_limit)
        self.interpolation = interpolation
        self.border_mode = border_mode
        self.value = value

    def sample(self):
        self.angle = np.random.uniform(*self.rotate_limit)
        self.scale = 1.0 + np.random.uniform(*self.scale_limit)
        self.dx = np.random.uniform(*self.shift_limit)
        self.dy = np.random.uniform(*self.shift_limit)

    def _matrix(self, h, w):
        import cv2
        m = cv2.getRotationMatrix2D((w / 2 - 0.5, h / 2 - 0.5),
                                    self.angle, self.scale)
        m[0, 2] += self.dx * w
        m[1, 2] += self.dy * h
        return m

    def apply(self, img):
        import cv2
        h, w = img.shape[:2]
        return cv2.warpAffine(img, self._matrix(h, w), (w, h),
                              flags=self.interpolation,
                              borderMode=self.border_mode,
                              borderValue=self.value)

    def apply_bboxes(self, bboxes, h, w):
        if len(bboxes) == 0:
            return bboxes
        m = self._matrix(h, w)
        x1, y1, x2, y2 = bboxes.T
        corners = np.stack([
            np.stack([x1, y1], -1), np.stack([x2, y1], -1),
            np.stack([x2, y2], -1), np.stack([x1, y2], -1)], 1)  # (N,4,2)
        warped = corners @ m[:, :2].T + m[:, 2]
        return np.concatenate([warped.min(1), warped.max(1)],
                              -1).astype(np.float32)


class RandomBrightnessContrast(_AlbuOp):
    """img*alpha + beta*255 (brightness_by_max=True default)."""

    def __init__(self, brightness_limit=0.2, contrast_limit=0.2,
                 brightness_by_max=True, p=0.5):
        super().__init__(p)
        self.brightness_limit = _to_tuple(brightness_limit)
        self.contrast_limit = _to_tuple(contrast_limit)
        self.brightness_by_max = brightness_by_max

    def sample(self):
        self.alpha = 1.0 + np.random.uniform(*self.contrast_limit)
        self.beta = np.random.uniform(*self.brightness_limit)

    def apply(self, img):
        out = img.astype(np.float32) * self.alpha
        out += self.beta * (255.0 if self.brightness_by_max
                            else out.mean())
        return np.clip(out, 0, 255).astype(img.dtype)


class RGBShift(_AlbuOp):
    def __init__(self, r_shift_limit=20, g_shift_limit=20, b_shift_limit=20,
                 p=0.5):
        super().__init__(p)
        self.limits = [_to_tuple(r_shift_limit), _to_tuple(g_shift_limit),
                       _to_tuple(b_shift_limit)]

    def sample(self):
        self.shifts = [np.random.uniform(*l) for l in self.limits]

    def apply(self, img):
        # mmdet feeds BGR; albumentations assumes RGB order — apply the
        # (r, g, b) draws to the (2, 1, 0) channels accordingly
        out = img.astype(np.float32)
        for ch, s in zip((2, 1, 0), self.shifts):
            out[..., ch] += s
        return np.clip(out, 0, 255).astype(img.dtype)


class HueSaturationValue(_AlbuOp):
    def __init__(self, hue_shift_limit=20, sat_shift_limit=30,
                 val_shift_limit=20, p=0.5):
        super().__init__(p)
        self.hue_shift_limit = _to_tuple(hue_shift_limit)
        self.sat_shift_limit = _to_tuple(sat_shift_limit)
        self.val_shift_limit = _to_tuple(val_shift_limit)

    def sample(self):
        self.hue = np.random.uniform(*self.hue_shift_limit)
        self.sat = np.random.uniform(*self.sat_shift_limit)
        self.val = np.random.uniform(*self.val_shift_limit)

    def apply(self, img):
        import cv2
        hsv = cv2.cvtColor(img.astype(np.uint8),
                           cv2.COLOR_BGR2HSV).astype(np.float32)
        hsv[..., 0] = (hsv[..., 0] + self.hue) % 180
        hsv[..., 1] = np.clip(hsv[..., 1] + self.sat, 0, 255)
        hsv[..., 2] = np.clip(hsv[..., 2] + self.val, 0, 255)
        return cv2.cvtColor(hsv.astype(np.uint8),
                            cv2.COLOR_HSV2BGR).astype(img.dtype)


class ChannelShuffle(_AlbuOp):
    def sample(self):
        self.perm = np.random.permutation(3)

    def apply(self, img):
        return img[..., self.perm]


class Blur(_AlbuOp):
    def __init__(self, blur_limit=7, p=0.5):
        super().__init__(p)
        self.blur_limit = (3, int(blur_limit)) \
            if np.isscalar(blur_limit) else tuple(blur_limit)

    def sample(self):
        lo, hi = self.blur_limit
        self.ksize = int(np.random.choice(np.arange(lo | 1, hi + 1, 2)))

    def apply(self, img):
        import cv2
        return cv2.blur(img, (self.ksize, self.ksize))


class MedianBlur(Blur):
    def apply(self, img):
        import cv2
        return cv2.medianBlur(np.ascontiguousarray(img), self.ksize)


class ToGray(_AlbuOp):
    def apply(self, img):
        import cv2
        g = cv2.cvtColor(img.astype(np.uint8), cv2.COLOR_BGR2GRAY)
        return np.stack([g] * 3, -1).astype(img.dtype)


class InvertImg(_AlbuOp):
    def apply(self, img):
        return (255 - img.astype(np.float32)).astype(img.dtype)


class JpegCompression(_AlbuOp):
    def __init__(self, quality_lower=99, quality_upper=100, p=0.5):
        super().__init__(p)
        self.quality = (int(quality_lower), int(quality_upper))

    def sample(self):
        self.q = int(np.random.randint(self.quality[0], self.quality[1] + 1))

    def apply(self, img):
        import cv2
        ok, buf = cv2.imencode(".jpg", img.astype(np.uint8),
                               [cv2.IMWRITE_JPEG_QUALITY, self.q])
        return cv2.imdecode(buf, cv2.IMREAD_COLOR).astype(img.dtype)


class ImageCompression(JpegCompression):
    pass


class HorizontalFlip(_AlbuOp):
    def apply(self, img):
        return img[:, ::-1]

    def apply_bboxes(self, bboxes, h, w):
        if len(bboxes) == 0:
            return bboxes
        out = bboxes.copy()
        out[:, 0], out[:, 2] = w - bboxes[:, 2], w - bboxes[:, 0]
        return out


class VerticalFlip(_AlbuOp):
    def apply(self, img):
        return img[::-1]

    def apply_bboxes(self, bboxes, h, w):
        if len(bboxes) == 0:
            return bboxes
        out = bboxes.copy()
        out[:, 1], out[:, 3] = h - bboxes[:, 3], h - bboxes[:, 1]
        return out


class RandomRotate90(_AlbuOp):
    def sample(self):
        self.k = int(np.random.randint(0, 4))

    def apply(self, img):
        return np.ascontiguousarray(np.rot90(img, self.k))

    def apply_bboxes(self, bboxes, h, w):
        b = bboxes
        for _ in range(self.k):       # one CCW np.rot90 step at a time
            if len(b):
                x1, y1, x2, y2 = b.T
                b = np.stack([y1, w - x2, y2, w - x1], -1)
            h, w = w, h
        return b.astype(np.float32) if len(b) else b


class OneOf(_AlbuOp):
    """Pick one child (probability proportional to its p) and force-apply."""

    def __init__(self, transforms: List[_AlbuOp], p: float = 0.5):
        super().__init__(p)
        self.transforms = transforms
        ps = np.array([t.p for t in transforms], np.float64)
        self.child_probs = ps / ps.sum() if ps.sum() > 0 else \
            np.full(len(ps), 1.0 / max(len(ps), 1))

    def __call__(self, img, bboxes, h, w):
        if np.random.random() >= self.p or not self.transforms:
            return img, bboxes
        t = self.transforms[int(np.random.choice(len(self.transforms),
                                                 p=self.child_probs))]
        t.sample()
        return t.apply(img), t.apply_bboxes(bboxes, h, w)


_OPS = {
    "ShiftScaleRotate": ShiftScaleRotate,
    "RandomBrightnessContrast": RandomBrightnessContrast,
    "RGBShift": RGBShift,
    "HueSaturationValue": HueSaturationValue,
    "ChannelShuffle": ChannelShuffle,
    "Blur": Blur,
    "MedianBlur": MedianBlur,
    "ToGray": ToGray,
    "InvertImg": InvertImg,
    "JpegCompression": JpegCompression,
    "ImageCompression": ImageCompression,
    "HorizontalFlip": HorizontalFlip,
    "VerticalFlip": VerticalFlip,
    "RandomRotate90": RandomRotate90,
    "OneOf": OneOf,
}


def _build_op(cfg: Dict[str, Any]) -> _AlbuOp:
    cfg = dict(cfg)
    name = cfg.pop("type")
    if name not in _OPS:
        raise NotImplementedError(
            f"Albu op '{name}' is not in the in-repo subset "
            f"({sorted(_OPS)}); albumentations itself is unavailable in "
            "this environment")
    if "transforms" in cfg:
        cfg["transforms"] = [_build_op(t) for t in cfg["transforms"]]
    return _OPS[name](**cfg)


@PIPELINES.register_module()
class Albu:
    """mmdet-compatible Albu wrapper over the in-repo op subset
    (reference transforms.py:1321-1520 contract: keymap, pascal_voc
    bboxes with label_fields, filter_lost_elements via idx_mapper,
    skip_img_without_anno -> None, update_pad_shape)."""

    def __init__(self, transforms: List[Dict], bbox_params=None,
                 keymap=None, update_pad_shape: bool = False,
                 skip_img_without_anno: bool = False):
        transforms = copy.deepcopy(transforms)
        self.transforms = [_build_op(t) for t in transforms]
        self.update_pad_shape = update_pad_shape
        self.skip_img_without_anno = skip_img_without_anno
        self.filter_lost_elements = False
        self.origin_label_fields: List[str] = []
        self.min_visibility = 0.0
        self.min_area = 0.0
        if isinstance(bbox_params, dict):
            bbox_params = dict(bbox_params)
            fmt = bbox_params.get("format", "pascal_voc")
            if fmt != "pascal_voc":
                raise NotImplementedError(
                    f"Albu bbox format '{fmt}' unsupported (mmdet always "
                    "configures pascal_voc)")
            if ("label_fields" in bbox_params
                    and "filter_lost_elements" in bbox_params):
                self.filter_lost_elements = True
                self.origin_label_fields = list(bbox_params["label_fields"])
            self.min_visibility = float(bbox_params.get("min_visibility", 0))
            self.min_area = float(bbox_params.get("min_area", 0))
        self.keymap_to_albu = keymap or {"img": "image",
                                         "gt_bboxes": "bboxes"}
        self.keymap_back = {v: k for k, v in self.keymap_to_albu.items()}

    def __call__(self, results: Dict[str, Any]):
        img_key = next((k for k, v in self.keymap_to_albu.items()
                        if v == "image"), "img")
        bbox_key = next((k for k, v in self.keymap_to_albu.items()
                         if v == "bboxes"), None)
        img = results[img_key]
        h, w = img.shape[:2]
        has_boxes = bbox_key is not None and bbox_key in results
        bboxes = (np.asarray(results[bbox_key], np.float32).reshape(-1, 4)
                  if has_boxes else np.zeros((0, 4), np.float32))
        orig_areas = np.maximum(bboxes[:, 2] - bboxes[:, 0], 0) * \
            np.maximum(bboxes[:, 3] - bboxes[:, 1], 0)

        for t in self.transforms:
            img, bboxes = t(img, bboxes, h, w)

        keep = np.arange(len(bboxes))
        if has_boxes:
            # albumentations BboxParams post-filter: clip to the image,
            # drop boxes below min_area / min_visibility (defaults 0:
            # anything with no positive area inside the image is lost)
            clipped = bboxes.copy()
            clipped[:, 0::2] = np.clip(clipped[:, 0::2], 0, w)
            clipped[:, 1::2] = np.clip(clipped[:, 1::2], 0, h)
            areas = np.maximum(clipped[:, 2] - clipped[:, 0], 0) * \
                np.maximum(clipped[:, 3] - clipped[:, 1], 0)
            vis = np.where(orig_areas > 0, areas / np.maximum(orig_areas,
                                                              1e-12), 0.0)
            mask = (areas > self.min_area) & (vis > self.min_visibility)
            keep = np.flatnonzero(mask)
            results[bbox_key] = clipped[keep]
            if self.filter_lost_elements:
                for label in self.origin_label_fields:
                    results[label] = np.asarray(
                        [results[label][i] for i in keep])
                if len(keep) == 0 and self.skip_img_without_anno:
                    return None

        results[img_key] = img
        if "gt_labels" in results:
            results["gt_labels"] = np.asarray(results["gt_labels"],
                                              np.int64)
        if self.update_pad_shape:
            results["pad_shape"] = img.shape
        return results

    def __repr__(self):
        return (f"{self.__class__.__name__}"
                f"(transforms={[type(t).__name__ for t in self.transforms]})")
