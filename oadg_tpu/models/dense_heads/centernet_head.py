"""CenterNet head + detector (reference
mmdet/models/dense_heads/centernet_head.py:15, detectors/centernet.py):
center heatmap (gaussian focal), wh and offset L1 regression at centers;
decode = 3x3 local-maximum suppression + top-k (replaces the reference's
``get_local_maximum`` maxpool trick with the same XLA reduce_window).
"""
from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp

from ... import nn
from ...utils.registry import DETECTORS, HEADS, LOSSES, build_from_cfg
from ..layers import Conv
from ..utils.misc import gaussian_radius, gen_gaussian_target


@HEADS.register_module()
class CenterNetHead(nn.Module):
    num_classes: int = 80
    in_channels: int = 64
    feat_channels: int = 64
    stride: int = 4                      # CenterNet works on a 1/4 map
    loss_center_heatmap: Any = None
    loss_wh: Any = None
    loss_offset: Any = None
    train_cfg: Any = None
    test_cfg: Any = None
    num_views: int = 1
    dtype: Any = None

    def setup(self):
        self.loss_hm = build_from_cfg(dict(self.loss_center_heatmap or dict(
            type="GaussianFocalLoss", loss_weight=1.0)), LOSSES)
        self.wh_weight = float((self.loss_wh or {}).get("loss_weight", 0.1))
        self.off_weight = float((self.loss_offset or {}).get("loss_weight", 1.0))
        def branch(out, name):
            return (Conv(self.feat_channels, 3, 1, 1, dtype=self.dtype,
                         name=f"{name}_conv"),
                    Conv(out, 1, 1, 0, dtype=self.dtype, name=f"{name}_out"))
        self.hm_branch = branch(self.num_classes, "heatmap")
        self.wh_branch = branch(2, "wh")
        self.off_branch = branch(2, "offset")

    def _apply_branch(self, branch, x):
        c, o = branch
        return o(nn.relu(c(x)))

    def __call__(self, feats):
        x = feats[0]
        hm = jax.nn.sigmoid(
            self._apply_branch(self.hm_branch, x).astype(jnp.float32))
        wh = self._apply_branch(self.wh_branch, x).astype(jnp.float32)
        off = self._apply_branch(self.off_branch, x).astype(jnp.float32)
        return (hm, wh, off)

    def _targets_single(self, gt, gtv, gtl, fh: int, fw: int):
        """Static gaussian heatmap + center wh/offset targets, one image."""
        s = float(self.stride)
        cx = (gt[:, 0] + gt[:, 2]) / 2 / s
        cy = (gt[:, 1] + gt[:, 3]) / 2 / s
        bw = (gt[:, 2] - gt[:, 0]) / s
        bh = (gt[:, 3] - gt[:, 1]) / s
        radius = jnp.maximum(gaussian_radius((bh, bw), 0.3), 0.0)

        def draw(i, hm):
            g = gen_gaussian_target(
                jnp.zeros((fh, fw)), (jnp.floor(cx[i]), jnp.floor(cy[i])),
                jnp.maximum(radius[i], 1.0))
            g = jnp.where(gtv[i] & (bw[i] > 0) & (bh[i] > 0), g, 0.0)
            cls_sel = jax.nn.one_hot(gtl[i], self.num_classes)  # (C,)
            return jnp.maximum(hm, g[..., None] * cls_sel[None, None, :])

        hm = jax.lax.fori_loop(0, gt.shape[0], draw,
                               jnp.zeros((fh, fw, self.num_classes)))
        ix = jnp.clip(jnp.floor(cx).astype(jnp.int32), 0, fw - 1)
        iy = jnp.clip(jnp.floor(cy).astype(jnp.int32), 0, fh - 1)
        return hm, ix, iy, bw, bh, cx - jnp.floor(cx), cy - jnp.floor(cy)

    def loss(self, outs, gt_bboxes, gt_valid, gt_labels, rng=None):
        hm_pred, wh_pred, off_pred = outs
        n, fh, fw = hm_pred.shape[:3]

        def one(hm_i, wh_i, off_i, gt, gtv, gtl):
            hm_t, ix, iy, bw, bh, ox, oy = self._targets_single(
                gt, gtv, gtl, fh, fw)
            l_hm = self.loss_hm(jnp.clip(hm_i, 1e-4, 1 - 1e-4), hm_t,
                                avg_factor=jnp.maximum(jnp.sum(gtv), 1.0))
            vw = gtv.astype(jnp.float32)
            wh_at = wh_i[iy, ix]                       # (G, 2)
            off_at = off_i[iy, ix]
            l_wh = jnp.sum(jnp.abs(wh_at - jnp.stack([bw, bh], -1))
                           * vw[:, None]) / jnp.maximum(jnp.sum(vw) * 2, 1.0)
            l_off = jnp.sum(jnp.abs(off_at - jnp.stack([ox, oy], -1))
                            * vw[:, None]) / jnp.maximum(jnp.sum(vw) * 2, 1.0)
            return l_hm, l_wh, l_off

        lh, lw, lo = jax.vmap(one)(hm_pred, wh_pred, off_pred, gt_bboxes,
                                   gt_valid, gt_labels)
        return dict(loss_center_heatmap=jnp.mean(lh),
                    loss_wh=self.wh_weight * jnp.mean(lw),
                    loss_offset=self.off_weight * jnp.mean(lo))

    def get_bboxes(self, outs, img_shapes, scale_factors, rescale=True,
                   cfg=None):
        hm, wh, off = outs
        cfg = dict(cfg or self.test_cfg or {})
        k = int(cfg.get("max_per_img", 100))
        n, fh, fw, nc = hm.shape
        # local maximum: keep peaks equal to their 3x3 max
        pad = jnp.pad(hm, ((0, 0), (1, 1), (1, 1), (0, 0)),
                      constant_values=-jnp.inf)
        hmax = jax.lax.reduce_window(pad, -jnp.inf, jax.lax.max,
                                     (1, 3, 3, 1), (1, 1, 1, 1), "VALID")
        peaks = jnp.where(hm == hmax, hm, 0.0)

        def one(p_i, wh_i, off_i, shape, sf):
            flat = p_i.reshape(-1)                      # (fh*fw*nc)
            scores, idx = jax.lax.top_k(flat, k)
            cls = (idx % nc).astype(jnp.int32)
            pix = idx // nc
            ys = (pix // fw).astype(jnp.float32)
            xs = (pix % fw).astype(jnp.float32)
            o = off_i.reshape(-1, 2)[pix]
            s = wh_i.reshape(-1, 2)[pix]
            cx = (xs + o[:, 0]) * self.stride
            cy = (ys + o[:, 1]) * self.stride
            bw = s[:, 0] * self.stride
            bh = s[:, 1] * self.stride
            boxes = jnp.stack([cx - bw / 2, cy - bh / 2,
                               cx + bw / 2, cy + bh / 2], -1)
            if rescale:
                boxes = boxes / jnp.asarray(sf, jnp.float32).reshape(-1)[:4]
            dets = jnp.concatenate([boxes, scores[:, None]], -1)
            return dets, cls, scores > 0

        return jax.vmap(one)(peaks, wh, off, img_shapes, scale_factors)


from ..detectors.single_stage import SingleStageDetector  # noqa: E402


@DETECTORS.register_module()
class CenterNet(SingleStageDetector):
    """CenterNet detector (reference mmdet/models/detectors/centernet.py:10)."""
    pass
