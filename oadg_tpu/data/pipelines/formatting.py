"""Formatting pipeline ops + Compose + test-time aug wrapper.

``DefaultFormatBundle``/``Collect`` keep the reference's key contract
(reference mmdet/datasets/pipelines/formating.py:175,289) but produce plain
numpy HWC images and metadata dicts — no DataContainers; static-shape
batching happens in the loader (data/loader.py).
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np

from ...utils.registry import PIPELINES, build_from_cfg


@PIPELINES.register_module()
class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = []
        for t in transforms:
            if isinstance(t, dict):
                self.transforms.append(build_from_cfg(dict(t), PIPELINES))
            else:
                self.transforms.append(t)

    def __call__(self, results):
        for t in self.transforms:
            results = t(results)
            if results is None:
                return None
        return results

    def __repr__(self):
        return "Compose(\n" + "\n".join(f"  {t!r}" for t in self.transforms) + "\n)"


@PIPELINES.register_module()
class DefaultFormatBundle:
    """Keep images HWC float32; ensure gt arrays are well-typed. The
    reference converts to CHW torch tensors here (formating.py:218-233);
    NHWC is the layout the models use, so images stay as-is."""

    def __init__(self, img_to_float: bool = True, pad_val=None):
        self.img_to_float = img_to_float

    def __call__(self, results: Dict[str, Any]):
        for key in results.get("img_fields", ["img"]):
            img = results[key]
            if (self.img_to_float and img.dtype != np.float32
                    and not results.get("norm_on_device")):
                # norm_on_device (on-device OA-Mix): pixels stay uint8
                # through collate; the device preprocess converts +
                # normalizes on-chip (engine/preprocess.py).
                img = img.astype(np.float32)
            if img.ndim == 2:
                img = img[..., None]
            results[key] = np.ascontiguousarray(img)
        for key in ("gt_bboxes", "gt_bboxes_ignore"):
            if key in results:
                results[key] = results[key].astype(np.float32).reshape(-1, 4)
        if "gt_labels" in results:
            results["gt_labels"] = np.asarray(results["gt_labels"], np.int64)
        return results


@PIPELINES.register_module()
class ImageToTensor:
    def __init__(self, keys):
        self.keys = keys

    def __call__(self, results):
        for key in self.keys:
            img = results[key]
            if img.ndim == 2:
                img = img[..., None]
            results[key] = np.ascontiguousarray(img)
        return results


@PIPELINES.register_module()
class Collect:
    META_KEYS = ("filename", "ori_filename", "ori_shape", "img_shape",
                 "pad_shape", "scale_factor", "flip", "flip_direction",
                 "img_norm_cfg")

    def __init__(self, keys, meta_keys=META_KEYS):
        self.keys = keys
        self.meta_keys = meta_keys

    def __call__(self, results: Dict[str, Any]):
        data = {}
        img_meta = {k: results[k] for k in self.meta_keys if k in results}
        data["img_metas"] = img_meta
        for key in self.keys:
            if key in results:
                data[key] = results[key]
        for key in results.get("custom_field", []):
            if key not in data and key in results:
                data[key] = results[key]
        if "oamix_cfg" in results:
            data["oamix_cfg"] = results["oamix_cfg"]
        return data


@PIPELINES.register_module()
class MultiScaleFlipAug:
    """Test-time augmentation wrapper (reference
    mmdet/datasets/pipelines/test_time_aug.py:11). Produces a LIST of
    pipeline outputs, one per (scale, flip) combination."""

    def __init__(self, transforms, img_scale=None, scale_factor=None,
                 flip: bool = False, flip_direction="horizontal"):
        self.transforms = Compose(transforms)
        if img_scale is not None:
            self.img_scale = (img_scale if isinstance(img_scale, list)
                              else [img_scale])
        else:
            self.img_scale = [scale_factor]
        self.flip = flip
        self.flip_direction = (flip_direction if isinstance(flip_direction, list)
                               else [flip_direction])

    def __call__(self, results):
        aug_data = []
        flips = [False] + ([True] if self.flip else [])
        for scale in self.img_scale:
            for f in flips:
                directions = self.flip_direction if f else ["horizontal"]
                for d in (directions if f else ["horizontal"]):
                    _results = dict(results)
                    _results["scale"] = tuple(scale)
                    _results["flip"] = f
                    _results["flip_direction"] = d
                    aug_data.append(self.transforms(_results))
        if len(aug_data) == 1:
            return aug_data[0]
        merged = {k: [d[k] for d in aug_data] for k in aug_data[0]}
        merged["__tta__"] = True
        return merged


@PIPELINES.register_module()
class ToTensor:
    """Convert keys to the framework's array currency (reference
    formating.py:38 converts to torch.Tensor; here batches move to device
    as numpy and jnp.asarray happens at dispatch, so this normalizes to
    contiguous numpy arrays)."""

    def __init__(self, keys):
        self.keys = keys

    def __call__(self, results):
        for key in self.keys:
            results[key] = np.ascontiguousarray(np.asarray(results[key]))
        return results

    def __repr__(self):
        return f"{self.__class__.__name__}(keys={self.keys})"


@PIPELINES.register_module()
class Transpose:
    """Transpose array axes (reference formating.py:104)."""

    def __init__(self, keys, order):
        self.keys = keys
        self.order = tuple(order)

    def __call__(self, results):
        for key in self.keys:
            results[key] = np.asarray(results[key]).transpose(self.order)
        return results

    def __repr__(self):
        return f"{self.__class__.__name__}(keys={self.keys}, order={self.order})"


class DataContainer:
    """Minimal stand-in for mmcv.parallel.DataContainer: tags a value with
    stack/pad metadata. The static-shape loader ignores the metadata (it
    pads everything), but configs using ToDataContainer keep working and
    downstream code can unwrap ``.data``."""

    def __init__(self, data, stack=False, padding_value=0, cpu_only=False):
        self.data = data
        self.stack = stack
        self.padding_value = padding_value
        self.cpu_only = cpu_only

    def __repr__(self):
        return f"DataContainer({self.data!r})"


@PIPELINES.register_module()
class ToDataContainer:
    """Wrap keys in DataContainers (reference formating.py:136)."""

    def __init__(self, fields=(dict(key="img", stack=True),
                               dict(key="gt_bboxes"),
                               dict(key="gt_labels"))):
        self.fields = tuple(dict(f) for f in fields)

    def __call__(self, results):
        for field in self.fields:
            f = dict(field)
            key = f.pop("key")
            if key in results:
                results[key] = DataContainer(results[key], **f)
        return results

    def __repr__(self):
        return f"{self.__class__.__name__}(fields={self.fields})"


@PIPELINES.register_module()
class WrapFieldsToLists:
    """Wrap every field into a single-element list (reference
    formating.py:365 — single-image inference collation)."""

    def __call__(self, results):
        for key, val in results.items():
            results[key] = [val]
        return results

    def __repr__(self):
        return f"{self.__class__.__name__}()"
