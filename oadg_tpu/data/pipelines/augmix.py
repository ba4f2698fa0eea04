"""AugMix pipeline op (reference mmdet/datasets/pipelines/augmix.py:220).

Host-side (numpy/cv2/PIL) implementation of the standalone AugMix class:
multi-view (`img2..imgN`), ``no_jsd`` single-view, and ``copy`` modes. Uses
the same op families as the reference's `augmentations` lists, implemented
with the in-repo numpy/cv2 equivalents (the heavy OA-Mix path runs
on-device; plain AugMix is light enough for the host pipeline and is kept
here for config parity).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np

from ...utils.registry import PIPELINES


def _sample_level(n):
    return np.random.uniform(low=0.1, high=n)


def _int_param(level, maxval):
    return int(level * maxval / 10)


def _float_param(level, maxval):
    return float(level) * maxval / 10.0


def _autocontrast(img, level, img_size):
    from PIL import Image, ImageOps
    return np.asarray(ImageOps.autocontrast(Image.fromarray(img)))


def _equalize(img, level, img_size):
    from PIL import Image, ImageOps
    return np.asarray(ImageOps.equalize(Image.fromarray(img)))


def _posterize(img, level, img_size):
    from PIL import Image, ImageOps
    bits = 4 - _int_param(_sample_level(level), 4)
    return np.asarray(ImageOps.posterize(Image.fromarray(img), max(bits, 1)))


def _solarize(img, level, img_size):
    from PIL import Image, ImageOps
    thr = 256 - _int_param(_sample_level(level), 256)
    return np.asarray(ImageOps.solarize(Image.fromarray(img), thr))


def _rotate(img, level, img_size):
    import cv2
    deg = _int_param(_sample_level(level), 30)
    if np.random.uniform() > 0.5:
        deg = -deg
    m = cv2.getRotationMatrix2D((img_size[0] / 2, img_size[1] / 2), deg, 1.0)
    return cv2.warpAffine(img, m, img_size)


def _shear_x(img, level, img_size):
    import cv2
    s = _float_param(_sample_level(level), 0.3)
    if np.random.uniform() > 0.5:
        s = -s
    m = np.float32([[1, -s, 0], [0, 1, 0]])
    return cv2.warpAffine(img, m, img_size)


def _shear_y(img, level, img_size):
    import cv2
    s = _float_param(_sample_level(level), 0.3)
    if np.random.uniform() > 0.5:
        s = -s
    m = np.float32([[1, 0, 0], [-s, 1, 0]])
    return cv2.warpAffine(img, m, img_size)


def _translate_x(img, level, img_size):
    import cv2
    t = _int_param(_sample_level(level), img_size[0] / 3)
    if np.random.random() > 0.5:
        t = -t
    m = np.float32([[1, 0, -t], [0, 1, 0]])
    return cv2.warpAffine(img, m, img_size)


def _translate_y(img, level, img_size):
    import cv2
    t = _int_param(_sample_level(level), img_size[1] / 3)
    if np.random.random() > 0.5:
        t = -t
    m = np.float32([[1, 0, 0], [0, 1, -t]])
    return cv2.warpAffine(img, m, img_size)


def _enh(name):
    def fn(img, level, img_size):
        from PIL import Image, ImageEnhance
        f = _float_param(_sample_level(level), 1.8) + 0.1
        cls = getattr(ImageEnhance, name)
        return np.asarray(cls(Image.fromarray(img)).enhance(f))
    return fn


_AUGMENTATIONS = [_autocontrast, _equalize, _posterize, _rotate, _solarize,
                  _shear_x, _shear_y, _translate_x, _translate_y]
_AUGMENTATIONS_ALL = _AUGMENTATIONS + [
    _enh("Color"), _enh("Contrast"),
    _enh("Brightness"), _enh("Sharpness")]
_WO_TRANS = [_autocontrast, _equalize, _posterize, _solarize,
             _enh("Color"), _enh("Contrast"),
             _enh("Brightness"), _enh("Sharpness")]
_WO_GEO = [_autocontrast, _equalize, _posterize, _solarize]


@PIPELINES.register_module()
class AugMix:
    def __init__(self, mean=None, std=None, aug_list="augmentations",
                 to_rgb=True, no_jsd=False, aug_severity=1, num_views=3,
                 **kwargs):
        self.mixture_width = 3
        self.mixture_depth = -1
        self.aug_prob_coeff = 1.0
        self.aug_severity = aug_severity
        self.no_jsd = no_jsd
        self.num_views = num_views
        self.copy_mode = aug_list == "copy"
        if aug_list in ("augmentations_without_obj_translation", "wotrans"):
            self.aug_list = _WO_TRANS
        elif aug_list in ("augmentations_all", "all"):
            self.aug_list = _AUGMENTATIONS_ALL
        elif aug_list in ("wogeo", "augmentations_without_geo"):
            self.aug_list = _WO_GEO
        else:
            self.aug_list = _AUGMENTATIONS

    def aug(self, img: np.ndarray) -> np.ndarray:
        ws = np.float32(np.random.dirichlet(
            [self.aug_prob_coeff] * self.mixture_width))
        m = np.float32(np.random.beta(self.aug_prob_coeff,
                                      self.aug_prob_coeff))
        h, w = img.shape[:2]
        img_size = (w, h)
        mix = np.zeros_like(img, dtype=np.float32)
        for i in range(self.mixture_width):
            image_aug = img.copy()
            depth = (self.mixture_depth if self.mixture_depth > 0
                     else np.random.randint(1, 4))
            for _ in range(depth):
                op = self.aug_list[np.random.randint(len(self.aug_list))]
                image_aug = np.asarray(op(image_aug, self.aug_severity,
                                          img_size), dtype=np.uint8)
            mix += ws[i] * image_aug.astype(np.float32)
        return (1 - m) * img.astype(np.float32) + m * mix

    def __call__(self, results: Dict[str, Any]) -> Dict[str, Any]:
        img = np.asarray(results["img"], np.uint8)
        if self.no_jsd:
            results["img"] = self.aug(img)
            return results
        if self.copy_mode:
            results["img2"] = img.copy()
            results["img3"] = img.copy()
            results["img_fields"] = ["img", "img2", "img3"]
            return results
        results["img_fields"] = ["img"]
        for i in range(2, self.num_views + 1):
            results[f"img{i}"] = self.aug(img)
            results["img_fields"].append(f"img{i}")
        return results

    def __repr__(self):
        return f"AugMix(num_views={self.num_views}, no_jsd={self.no_jsd})"
