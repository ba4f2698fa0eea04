"""Single-stage detectors (reference mmdet/models/detectors/single_stage.py
+ yolo.py): backbone -> neck -> dense head; OA-DG multi-view batches flow
through unchanged (losses handle view chunking)."""
from __future__ import annotations

from typing import Any, Dict

import jax
import jax.numpy as jnp

from ... import nn
from ...utils.registry import BACKBONES, DETECTORS, HEADS, NECKS, build_from_cfg


@DETECTORS.register_module()
class SingleStageDetector(nn.Module):
    backbone: Any = None
    neck: Any = None
    bbox_head: Any = None
    train_cfg: Any = None
    test_cfg: Any = None
    num_views: int = 1
    init_cfg: Any = None
    pretrained: Any = None
    dtype: Any = None

    def setup(self):
        bb = dict(self.backbone)
        bb_type = bb.pop("type", "ResNet")
        self.backbone_m = build_from_cfg(dict(type=bb_type, **bb,
                                              dtype=self.dtype), BACKBONES)
        if self.neck is not None:
            nk = dict(self.neck)
            nk_type = nk.pop("type", "FPN")
            self.neck_m = build_from_cfg(dict(type=nk_type, **nk,
                                              dtype=self.dtype), NECKS)
        else:
            self.neck_m = None
        bh = dict(self.bbox_head)
        bh_type = bh.pop("type")
        self.head = build_from_cfg(
            dict(type=bh_type, **bh, train_cfg=self.train_cfg,
                 test_cfg=self.test_cfg, num_views=self.num_views,
                 dtype=self.dtype), HEADS)

    def extract_feat(self, img):
        x = self.backbone_m(img)
        if self.neck_m is not None:
            x = self.neck_m(x)
        return x

    def __call__(self, batch, mode: str = "train"):
        if mode == "aug_test":
            views, metas = batch
            return self.aug_test(views, metas)
        feats = self.extract_feat(batch["img"])
        outs = self.head(feats)
        if mode == "train":
            rng = self.make_rng("sampling")
            if len(outs) == 1:
                return self.head.loss(outs[0], batch["gt_bboxes"],
                                      batch["gt_valid"], batch["gt_labels"],
                                      rng)
            return self.head.loss(outs, batch["gt_bboxes"],
                                  batch["gt_valid"], batch["gt_labels"], rng)
        sf = batch.get("scale_factor",
                       jnp.ones((batch["img"].shape[0], 4), jnp.float32))
        return self.head.get_bboxes(outs, batch["img_shape"], sf)

    def aug_test(self, views, metas):
        """Test-time augmentation (reference
        dense_test_mixins.aug_test_bboxes + merge_augs.py:84): run each
        view, map its rescaled detections back to the original frame
        (flip-back within the original extent), pool every view's
        detections and run one class-aware NMS.

        Divergence from the reference noted: the reference concatenates
        PRE-NMS candidate boxes across views; here each view contributes
        its top ``max_per_img`` post-NMS detections before the merged NMS
        — identical results unless a view has more than max_per_img
        near-duplicate candidates.

        ``metas`` is a STATIC tuple of (flip, flip_direction) per view.
        """
        from ...core.bbox.transforms import bbox_flip
        from ...core.post_processing.nms import batched_nms_padded

        cfg = dict(self.test_cfg or {})
        iou_thr = float(dict(cfg.get("nms", {})).get("iou_threshold", 0.5))
        mpi = int(cfg.get("max_per_img", 100))

        all_d, all_l, all_v = [], [], []
        for vd, (flip, fdir) in zip(views, metas):
            feats = self.extract_feat(vd["img"])
            outs = self.head(feats)
            sf = vd.get("scale_factor",
                        jnp.ones((vd["img"].shape[0], 4), jnp.float32))
            dets, labels, valid = self.head.get_bboxes(
                outs, vd["img_shape"], sf)        # rescaled: original frame
            if flip:
                # original extent: view shape (h, w) / (h_scale, w_scale)
                ori_shape = vd["img_shape"] / sf[:, (1, 0)]
                boxes = jax.vmap(
                    lambda bx, s: bbox_flip(bx, s, fdir))(
                    dets[..., :4], ori_shape)
                dets = jnp.concatenate([boxes, dets[..., 4:]], axis=-1)
            all_d.append(dets)
            all_l.append(labels)
            all_v.append(valid)

        dets = jnp.concatenate(all_d, axis=1)
        labels = jnp.concatenate(all_l, axis=1)
        valid = jnp.concatenate(all_v, axis=1)

        def fin(d, l, v):
            keep = batched_nms_padded(d[:, :4], d[:, 4], l, iou_thr, valid=v)
            sc = jnp.where(keep, d[:, 4], -jnp.inf)
            top_s, ti = jax.lax.top_k(sc, min(mpi, sc.shape[0]))
            return d[ti], l[ti], jnp.isfinite(top_s)

        return jax.vmap(fin)(dets, labels, valid)


@DETECTORS.register_module()
class YOLOV3(SingleStageDetector):
    """Alias (reference mmdet/models/detectors/yolo.py:10)."""
    pass


@DETECTORS.register_module()
class RetinaNet(SingleStageDetector):
    """Registered for config compatibility (P2 head pending)."""
    pass
