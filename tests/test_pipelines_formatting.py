"""Loading/formatting pipeline ops (reference test style:
tests/test_data/test_pipelines/test_formatting.py + test_loading.py —
feed dict fixtures through transforms, assert key/shape/dtype contracts)."""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from oadg_tpu.data.pipelines.formatting import (Collect, Compose,
                                                DefaultFormatBundle,
                                                ImageToTensor,
                                                MultiScaleFlipAug)
from oadg_tpu.data.pipelines.loading import (LoadAnnotations,
                                             LoadImageFromFile,
                                             LoadImageFromWebcam)


def _results(h=32, w=48):
    rng = np.random.RandomState(0)
    return dict(
        img=rng.randint(0, 255, (h, w, 3)).astype(np.uint8),
        img_fields=["img"],
        img_shape=(h, w, 3), ori_shape=(h, w, 3), pad_shape=(h, w, 3),
        scale_factor=np.array([1, 1, 1, 1], np.float32),
        flip=False, flip_direction=None,
        gt_bboxes=np.array([[2.0, 3, 20, 21]], np.float32),
        gt_labels=[1],
    )


def test_default_format_bundle_types():
    out = DefaultFormatBundle()(_results())
    assert out["img"].dtype == np.float32           # HWC stays (NHWC)
    assert out["img"].ndim == 3 and out["img"].shape[-1] == 3
    assert out["gt_bboxes"].dtype == np.float32
    assert out["gt_bboxes"].shape == (1, 4)
    assert out["gt_labels"].dtype == np.int64


def test_default_format_bundle_gray_image_gets_channel():
    r = _results()
    r["img"] = r["img"][..., 0]
    out = DefaultFormatBundle()(r)
    assert out["img"].shape[-1] == 1


def test_collect_contract():
    r = DefaultFormatBundle()(_results())
    r["custom_field"] = ["img2"]
    r["img2"] = r["img"].copy()
    data = Collect(keys=["img", "gt_bboxes", "gt_labels"])(r)
    assert set(data) == {"img_metas", "img", "gt_bboxes", "gt_labels",
                         "img2"}
    # meta keys follow the reference META_KEYS contract (formating.py:289)
    for k in ("ori_shape", "img_shape", "pad_shape", "scale_factor",
              "flip"):
        assert k in data["img_metas"]


def test_image_to_tensor_keeps_contiguous():
    r = _results()
    r["img"] = np.asfortranarray(r["img"])
    out = ImageToTensor(keys=["img"])(r)
    assert out["img"].flags["C_CONTIGUOUS"]


def test_load_image_from_file_and_webcam(tmp_path):
    import cv2
    img = np.random.RandomState(1).randint(0, 255, (20, 30, 3)).astype(
        np.uint8)
    path = str(tmp_path / "x.png")
    cv2.imwrite(path, img)
    out = LoadImageFromFile()(dict(
        img_info=dict(filename="x.png"), img_prefix=str(tmp_path)))
    assert out["img"].shape == (20, 30, 3)
    assert out["img_shape"] == (20, 30, 3) or tuple(
        out["img_shape"])[:2] == (20, 30)
    assert "img" in out.get("img_fields", ["img"])
    np.testing.assert_array_equal(out["img"], img)

    out2 = LoadImageFromWebcam()(dict(img=img, img_info=dict(filename=None),
                                      img_prefix=None))
    np.testing.assert_array_equal(out2["img"], img)


def test_load_annotations_bboxes_labels():
    ann = dict(bboxes=np.array([[1.0, 2, 10, 12], [3, 4, 8, 9]], np.float32),
               labels=np.array([0, 2], np.int64),
               bboxes_ignore=np.zeros((0, 4), np.float32))
    out = LoadAnnotations()(dict(ann_info=ann, img_info={}))
    assert out["gt_bboxes"].shape == (2, 4)
    assert list(out["gt_labels"]) == [0, 2]
    assert "bbox_fields" in out


def test_multiscale_flip_aug_enumerates_views():
    calls = []

    class Probe:
        def __call__(self, r):
            calls.append((r["scale"], r["flip"]))
            return dict(img=np.zeros((4, 4, 3), np.float32),
                        scale=r["scale"], flip=r["flip"])

    tta = MultiScaleFlipAug(transforms=[], img_scale=[(32, 32), (64, 64)],
                            flip=True)
    tta.transforms = Probe()
    merged = tta(dict(img=np.zeros((4, 4, 3), np.uint8)))
    # 2 scales x (no-flip + flip) = 4 views
    assert len(calls) == 4
    assert merged["__tta__"] is True
    assert len(merged["flip"]) == 4
    assert sum(bool(f) for f in merged["flip"]) == 2
