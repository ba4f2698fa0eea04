"""Inference APIs (reference mmdet/apis/inference.py:17,89,212):
init_detector / inference_detector / show_result.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Config
from ..core.bbox.transforms import bbox2result
from ..data.pipelines.formatting import Compose
from ..engine.train_step import make_test_step
from ..models import build_detector


class DetectorHandle:
    """Holds module + variables + jitted test fn (the 'model' object the
    reference APIs pass around)."""

    def __init__(self, detector, variables, cfg, num_classes: int):
        self.detector = detector
        self.variables = variables
        self.cfg = cfg
        self.num_classes = num_classes
        self.CLASSES = None
        self._test_fn = make_test_step(detector)
        self._pipeline = None  # lazily-built test pipeline (cached)

    def test(self, batch):
        return self._test_fn(self.variables["params"],
                             self.variables.get("batch_stats"), batch)


def init_detector(config: Union[str, Config], checkpoint: Optional[str] = None,
                  cfg_options=None) -> DetectorHandle:
    if isinstance(config, str):
        config = Config.fromfile(config)
    if cfg_options:
        config.merge_from_dict(cfg_options)
    det = build_detector(dict(config.model), num_views=1)
    nc = _num_classes(config)
    # init params at a small spatial size (shape-independent)
    dummy = {
        "img": jnp.zeros((1, 128, 128, 3), jnp.float32),
        "img_shape": jnp.asarray([[128.0, 128.0]]),
        "scale_factor": jnp.ones((1, 4), jnp.float32),
    }
    variables = jax.jit(lambda r, b: det.init(r, b, "test"))(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)},
        dummy)
    if checkpoint:
        from ..utils.checkpoint import (load_checkpoint_variables,
                                        merge_variables)
        variables = merge_variables(variables,
                                    load_checkpoint_variables(checkpoint))
    handle = DetectorHandle(det, variables, config, nc)
    try:
        handle.CLASSES = _classes_from_cfg(config)
    except Exception:
        pass
    return handle


def _num_classes(cfg) -> int:
    m = dict(cfg.model)
    rh = dict(m.get("roi_head") or {})
    if rh.get("bbox_head"):
        return int(dict(rh["bbox_head"]).get("num_classes", 80))
    return int(dict(m.get("bbox_head") or {}).get("num_classes", 80))


def _classes_from_cfg(cfg):
    from ..utils.registry import DATASETS
    t = dict(cfg.data.test).get("type")
    ds = DATASETS.get(t)
    return getattr(ds, "CLASSES", None)


def _test_pipeline(cfg) -> Compose:
    pipeline = list(cfg.data.test["pipeline"])
    # replace the file loader so raw arrays work (reference LoadImage shim)
    if pipeline and pipeline[0].get("type") == "LoadImageFromFile":
        pipeline[0] = dict(type="LoadImageFromWebcam")
    return Compose(pipeline)


def prepare_batch(model: DetectorHandle, img,
                  pipeline: Optional[Compose] = None) -> dict:
    """Image path or array -> a 1-image test batch dict (the pipeline +
    pad-to-32 step of ``inference_detector``, exposed for notebooks and
    feature-visualization workflows). The built pipeline is cached on the
    handle so per-image calls don't rebuild it."""
    if pipeline is None:
        if model._pipeline is None:
            model._pipeline = _test_pipeline(model.cfg)
        pipeline = model._pipeline
    if isinstance(img, str):
        import cv2
        arr = cv2.imread(img)
        if arr is None:
            raise FileNotFoundError(img)
    else:
        arr = np.asarray(img)
    data = pipeline(dict(img=arr.copy(),
                         img_info=dict(filename=None), img_prefix=None))
    im = data["img"]
    h, w = im.shape[:2]
    d = 32
    hp, wp = ((h + d - 1) // d) * d, ((w + d - 1) // d) * d
    canvas = np.zeros((hp, wp, 3), np.float32)
    canvas[:h, :w] = im
    return {
        "img": jnp.asarray(canvas[None]),
        "img_shape": jnp.asarray([[h, w]], jnp.float32),
        "scale_factor": jnp.asarray(
            np.asarray(data["img_metas"].get("scale_factor",
                                             [1, 1, 1, 1]),
                       np.float32).reshape(1, -1)[:, :4]),
    }


def inference_detector(model: DetectorHandle, imgs) -> List[List[np.ndarray]]:
    """Run inference on image path(s) or array(s); returns per-class det
    lists like the reference (single input -> single result)."""
    single = not isinstance(imgs, (list, tuple))
    if single:
        imgs = [imgs]
    results = []
    for img in imgs:
        batch = prepare_batch(model, img)
        dets, labels, valid = model.test(batch)
        v = np.asarray(valid[0])
        results.append(bbox2result(np.asarray(dets[0])[v],
                                   np.asarray(labels[0])[v],
                                   model.num_classes))
    return results[0] if single else results


def show_result_pyplot(model: DetectorHandle, img, result,
                       score_thr: float = 0.3, out_file: Optional[str] = None,
                       **kwargs):
    from ..core.visualization import imshow_det_bboxes
    if isinstance(img, str):
        import cv2
        img = cv2.imread(img)
    bboxes = np.vstack(result)
    labels = np.concatenate([
        np.full(len(r), i, np.int32) for i, r in enumerate(result)])
    return imshow_det_bboxes(img, bboxes, labels,
                             class_names=model.CLASSES,
                             score_thr=score_thr, out_file=out_file, **kwargs)


async def async_inference_detector(model: DetectorHandle, imgs):
    """Async inference (reference mmdet/apis/inference.py:155).

    JAX dispatch is already asynchronous: each ``model.test`` call
    enqueues device work and returns immediately, so all images are
    dispatched before any result is awaited; the host->numpy fetches run
    in the default executor so the event loop stays free (the role
    torch.cuda streams play in the reference).
    """
    import asyncio

    single = not isinstance(imgs, (list, tuple))
    if single:
        imgs = [imgs]
    outs = [model.test(prepare_batch(model, img)) for img in imgs]
    loop = asyncio.get_event_loop()
    results = []
    for dets, labels, valid in outs:
        d, l, v = await loop.run_in_executor(
            None, lambda o=(dets, labels, valid): jax.device_get(o))
        vv = np.asarray(v[0])
        results.append(bbox2result(np.asarray(d[0])[vv],
                                   np.asarray(l[0])[vv],
                                   model.num_classes))
    return results[0] if single else results
