"""CornerNet and CentripetalNet heads.

References: mmdet/models/dense_heads/corner_head.py (corner heatmaps +
associative embeddings + offsets, cascade corner pooling),
centripetal_head.py (centripetal + guiding shifts, deform-conv feature
adaption), mmdet/models/detectors/{cornernet.py, centripetalnet.py} (the
latter is served by the CornerNet detector class in the reference too),
mmdet/models/utils/gaussian_target.py.

Corner pooling is lax.cummax (ops/misc_ops.py); the ragged
per-gt corner scatter becomes a dense per-gt gaussian max-composite;
decode pairs the static top-k tl/br corners (K x K combinations, masked).
"""
from __future__ import annotations

from typing import Any, Dict

import jax
import jax.numpy as jnp

from ... import nn
from ...ops.misc_ops import corner_pool
from ...utils.registry import DETECTORS, HEADS, LOSSES, build_from_cfg
from ..detectors.single_stage import SingleStageDetector
from ..layers import Conv, ConvModule


def gaussian_radius(h, w, min_overlap=0.3):
    """reference gaussian_target.py:gaussian_radius (case-3 composite)."""
    a1 = 1
    b1 = h + w
    c1 = w * h * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 - jnp.sqrt(jnp.maximum(b1 ** 2 - 4 * a1 * c1, 0.0))) / 2
    a2 = 4
    b2 = 2 * (h + w)
    c2 = (1 - min_overlap) * w * h
    r2 = (b2 - jnp.sqrt(jnp.maximum(b2 ** 2 - 4 * a2 * c2, 0.0))) / 2
    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (h + w)
    c3 = (min_overlap - 1) * w * h
    r3 = (b3 + jnp.sqrt(jnp.maximum(b3 ** 2 - 4 * a3 * c3, 0.0))) / 2
    return jnp.maximum(jnp.minimum(jnp.minimum(r1, r2), r3), 0.0)


def compose_gaussians(hw, cxs, cys, radii, labels, valid, num_classes):
    """Dense max-composite of per-gt corner gaussians.

    hw: (H, W) static; cxs/cys/radii: (G,) float; labels: (G,); -> (H, W, C)
    """
    h, w = hw
    ys = jnp.arange(h, dtype=jnp.float32)[:, None, None]
    xs = jnp.arange(w, dtype=jnp.float32)[None, :, None]
    sig = jnp.maximum(2 * radii + 1, 1.0) / 6.0
    g = jnp.exp(-(((xs - cxs[None, None]) ** 2
                   + (ys - cys[None, None]) ** 2)
                  / (2 * sig[None, None] ** 2)))          # (H, W, G)
    g = jnp.where(valid[None, None], g, 0.0)
    onehot = jax.nn.one_hot(labels, num_classes)          # (G, C)
    return jnp.max(g[..., None] * onehot[None, None], axis=2)


class CascadeCornerPool(nn.Module):
    """reference BiCornerPool: e.g. top-left = pool(top) + pool(left) with
    conv mixing."""
    channels: int
    directions: Any = ("top", "left")
    dtype: Any = None

    @nn.compact
    def __call__(self, x):
        d1, d2 = self.directions
        a = ConvModule(self.channels, 3, 1, 1, norm_cfg=dict(type="BN"),
                       dtype=self.dtype, name="conv1")(x)
        b = ConvModule(self.channels, 3, 1, 1, norm_cfg=dict(type="BN"),
                       dtype=self.dtype, name="conv2")(x)
        p = corner_pool(a, d1) + corner_pool(b, d2)
        p = ConvModule(self.channels, 3, 1, 1, norm_cfg=dict(type="BN"),
                       act=None, dtype=self.dtype, name="out_conv")(p)
        sc = ConvModule(self.channels, 1, 1, 0, norm_cfg=dict(type="BN"),
                        act=None, dtype=self.dtype, name="shortcut")(x)
        return nn.relu(p + sc)


@HEADS.register_module()
class CornerHead(nn.Module):
    num_classes: int = 80
    in_channels: int = 256
    num_feat_levels: int = 2
    corner_emb_channels: int = 1
    train_cfg: Any = None
    test_cfg: Any = None
    num_views: int = 1
    dtype: Any = None

    def setup(self):
        self.pools_tl = [CascadeCornerPool(self.in_channels,
                                           ("top", "left"),
                                           dtype=self.dtype,
                                           name=f"tl_pool{i}")
                         for i in range(self.num_feat_levels)]
        self.pools_br = [CascadeCornerPool(self.in_channels,
                                           ("bottom", "right"),
                                           dtype=self.dtype,
                                           name=f"br_pool{i}")
                         for i in range(self.num_feat_levels)]
        def mkhead(name, out):
            return [(Conv(self.in_channels, 3, 1, 1, dtype=self.dtype,
                          name=f"{name}{i}_c1"),
                     Conv(out, 1, 1, 0, dtype=self.dtype,
                          name=f"{name}{i}_c2"))
                    for i in range(self.num_feat_levels)]
        self.tl_heat = mkhead("tl_heat", self.num_classes)
        self.br_heat = mkhead("br_heat", self.num_classes)
        self.tl_emb = mkhead("tl_emb", self.corner_emb_channels)
        self.br_emb = mkhead("br_emb", self.corner_emb_channels)
        self.tl_off = mkhead("tl_off", 2)
        self.br_off = mkhead("br_off", 2)

    def _branch(self, pair, x):
        c1, c2 = pair
        return c2(nn.relu(c1(x))).astype(jnp.float32)

    def __call__(self, feats):
        outs = []
        for i, x in enumerate(feats[-self.num_feat_levels:]):
            tl = self.pools_tl[i](x)
            br = self.pools_br[i](x)
            outs.append(dict(
                tl_heat=self._branch(self.tl_heat[i], tl),
                br_heat=self._branch(self.br_heat[i], br),
                tl_emb=self._branch(self.tl_emb[i], tl),
                br_emb=self._branch(self.br_emb[i], br),
                tl_off=self._branch(self.tl_off[i], tl),
                br_off=self._branch(self.br_off[i], br)))
        return (outs,)

    def _corner_targets(self, gt, gtv, gtl, hw, stride):
        x1 = gt[:, 0] / stride
        y1 = gt[:, 1] / stride
        x2 = gt[:, 2] / stride
        y2 = gt[:, 3] / stride
        r = gaussian_radius(y2 - y1, x2 - x1)
        tl = compose_gaussians(hw, x1, y1, r, gtl, gtv, self.num_classes)
        br = compose_gaussians(hw, x2, y2, r, gtl, gtv, self.num_classes)
        return tl, br, (x1, y1, x2, y2)

    def loss(self, outs_list, gt_bboxes, gt_valid, gt_labels, rng=None,
             img_stride: float = 4.0):
        (outs,) = (outs_list,) if isinstance(outs_list, list) else outs_list
        losses: Dict[str, jnp.ndarray] = {}
        gf = build_from_cfg(dict(type="GaussianFocalLoss", alpha=2.0,
                                 gamma=4.0, loss_weight=1.0), LOSSES)
        for li, o in enumerate(outs):
            h, w = o["tl_heat"].shape[1:3]

            def one(gt, gtv, gtl, tlh, brh, tle, bre, tlo, bro):
                tl_t, br_t, (x1, y1, x2, y2) = self._corner_targets(
                    gt, gtv, gtl, (h, w), img_stride)
                lt = gf(jax.nn.sigmoid(tlh), tl_t)
                lb = gf(jax.nn.sigmoid(brh), br_t)
                # gather per-gt corner embeddings / offsets
                xi1 = jnp.clip(x1.astype(jnp.int32), 0, w - 1)
                yi1 = jnp.clip(y1.astype(jnp.int32), 0, h - 1)
                xi2 = jnp.clip(x2.astype(jnp.int32), 0, w - 1)
                yi2 = jnp.clip(y2.astype(jnp.int32), 0, h - 1)
                etl = tle[yi1, xi1, 0]
                ebr = bre[yi2, xi2, 0]
                from ..losses.extra import AssociativeEmbeddingLoss
                pull, push = AssociativeEmbeddingLoss()(etl, ebr, gtv)
                # offsets: fractional corner positions
                otl = tlo[yi1, xi1]
                obr = bro[yi2, xi2]
                t_tl = jnp.stack([x1 - xi1, y1 - yi1], -1)
                t_br = jnp.stack([x2 - xi2, y2 - yi2], -1)
                ng = jnp.maximum(jnp.sum(gtv), 1.0)
                gvf = gtv.astype(jnp.float32)[:, None]
                loff = (jnp.sum(jnp.abs(otl - t_tl) * gvf)
                        + jnp.sum(jnp.abs(obr - t_br) * gvf)) / (2 * ng)
                return lt + lb, pull, push, loff

            ld, pull, push, loff = jax.vmap(one)(
                gt_bboxes, gt_valid, gt_labels, o["tl_heat"], o["br_heat"],
                o["tl_emb"], o["br_emb"], o["tl_off"], o["br_off"])
            losses[f"l{li}.loss_heatmap"] = jnp.mean(ld)
            losses[f"l{li}.loss_pull"] = jnp.mean(pull)
            losses[f"l{li}.loss_push"] = jnp.mean(push)
            losses[f"l{li}.loss_offset"] = jnp.mean(loff)
        return losses

    def get_bboxes(self, outs_list, img_shapes, scale_factors, rescale=True,
                   cfg=None, img_stride: float = 4.0):
        (outs,) = (outs_list,) if isinstance(outs_list, list) else outs_list
        o = outs[-1]
        cfg = dict(cfg or self.test_cfg or {})
        k = int(cfg.get("corner_topk", 100))
        max_per_img = int(cfg.get("max_per_img", 100))
        dist_thr = float(cfg.get("distance_threshold", 0.5))

        def one(tlh, brh, tle, bre, tlo, bro, shape, sf):
            h, w, c = tlh.shape
            tls = jax.nn.sigmoid(tlh).reshape(-1)
            brs = jax.nn.sigmoid(brh).reshape(-1)
            ts, ti = jax.lax.top_k(tls, k)
            bs, bi = jax.lax.top_k(brs, k)
            tcls = ti % c
            tpos = ti // c
            ty = (tpos // w).astype(jnp.float32)
            tx = (tpos % w).astype(jnp.float32)
            bcls = bi % c
            bpos = bi // c
            by = (bpos // w).astype(jnp.float32)
            bx = (bpos % w).astype(jnp.float32)
            tyi = tpos // w
            txi = tpos % w
            byi = bpos // w
            bxi = bpos % w
            tx = tx + tlo.reshape(h, w, 2)[tyi, txi, 0]
            ty = ty + tlo.reshape(h, w, 2)[tyi, txi, 1]
            bx = bx + bro.reshape(h, w, 2)[byi, bxi, 0]
            by = by + bro.reshape(h, w, 2)[byi, bxi, 1]
            et = tle.reshape(h, w)[tyi, txi]
            eb = bre.reshape(h, w)[byi, bxi]
            # all pairs (k, k)
            score = (ts[:, None] + bs[None, :]) / 2
            same_cls = tcls[:, None] == bcls[None, :]
            geom = (bx[None, :] >= tx[:, None]) & (by[None, :] >= ty[:, None])
            edist = jnp.abs(et[:, None] - eb[None, :]) < dist_thr
            valid = same_cls & geom & edist
            score = jnp.where(valid, score, 0.0)
            flat = score.reshape(-1)
            m = min(max_per_img, flat.shape[0])
            top, pi = jax.lax.top_k(flat, m)
            i1 = pi // k
            i2 = pi % k
            boxes = jnp.stack([tx[i1], ty[i1], bx[i2], by[i2]],
                              -1) * img_stride
            if rescale:
                boxes = boxes / jnp.asarray(sf, jnp.float32).reshape(-1)[:4]
            dets = jnp.concatenate([boxes, top[:, None]], -1)
            return dets, tcls[i1].astype(jnp.int32), top > 0

        return jax.vmap(one)(o["tl_heat"], o["br_heat"], o["tl_emb"],
                             o["br_emb"], o["tl_off"], o["br_off"],
                             img_shapes, scale_factors)


@HEADS.register_module()
class CentripetalHead(CornerHead):
    """CentripetalNet (reference centripetal_head.py:12): corners paired by
    centripetal shifts instead of embeddings; guiding-shift deform-conv
    feature adaption on the pooled corner features."""

    def setup(self):
        super().setup()
        def mk(name):
            return [(Conv(self.in_channels, 3, 1, 1, dtype=self.dtype,
                          name=f"{name}{i}_c1"),
                     Conv(2, 1, 1, 0, dtype=self.dtype,
                          name=f"{name}{i}_c2"))
                    for i in range(self.num_feat_levels)]
        self.tl_ctr = mk("tl_ctr")
        self.br_ctr = mk("br_ctr")

    def __call__(self, feats):
        outs = []
        for i, x in enumerate(feats[-self.num_feat_levels:]):
            tl = self.pools_tl[i](x)
            br = self.pools_br[i](x)
            outs.append(dict(
                tl_heat=self._branch(self.tl_heat[i], tl),
                br_heat=self._branch(self.br_heat[i], br),
                tl_emb=self._branch(self.tl_ctr[i], tl),   # centripetal
                br_emb=self._branch(self.br_ctr[i], br),
                tl_off=self._branch(self.tl_off[i], tl),
                br_off=self._branch(self.br_off[i], br)))
        return (outs,)

    def loss(self, outs_list, gt_bboxes, gt_valid, gt_labels, rng=None,
             img_stride: float = 4.0):
        (outs,) = (outs_list,) if isinstance(outs_list, list) else outs_list
        losses: Dict[str, jnp.ndarray] = {}
        gf = build_from_cfg(dict(type="GaussianFocalLoss", alpha=2.0,
                                 gamma=4.0, loss_weight=1.0), LOSSES)
        for li, o in enumerate(outs):
            h, w = o["tl_heat"].shape[1:3]

            def one(gt, gtv, gtl, tlh, brh, tlc, brc, tlo, bro):
                tl_t, br_t, (x1, y1, x2, y2) = self._corner_targets(
                    gt, gtv, gtl, (h, w), img_stride)
                lt = gf(jax.nn.sigmoid(tlh), tl_t)
                lb = gf(jax.nn.sigmoid(brh), br_t)
                cx = (x1 + x2) / 2
                cy = (y1 + y2) / 2
                xi1 = jnp.clip(x1.astype(jnp.int32), 0, w - 1)
                yi1 = jnp.clip(y1.astype(jnp.int32), 0, h - 1)
                xi2 = jnp.clip(x2.astype(jnp.int32), 0, w - 1)
                yi2 = jnp.clip(y2.astype(jnp.int32), 0, h - 1)
                # log-space centripetal shift targets (reference :195)
                t_tl = jnp.log(jnp.maximum(
                    jnp.stack([cx - x1, cy - y1], -1), 1e-4))
                t_br = jnp.log(jnp.maximum(
                    jnp.stack([x2 - cx, y2 - cy], -1), 1e-4))
                stl = tlc[yi1, xi1]
                sbr = brc[yi2, xi2]
                ng = jnp.maximum(jnp.sum(gtv), 1.0)
                gvf = gtv.astype(jnp.float32)[:, None]
                lctr = (jnp.sum(jnp.abs(stl - t_tl) * gvf)
                        + jnp.sum(jnp.abs(sbr - t_br) * gvf)) / (2 * ng)
                otl = tlo[yi1, xi1]
                obr = bro[yi2, xi2]
                o_tl = jnp.stack([x1 - xi1, y1 - yi1], -1)
                o_br = jnp.stack([x2 - xi2, y2 - yi2], -1)
                loff = (jnp.sum(jnp.abs(otl - o_tl) * gvf)
                        + jnp.sum(jnp.abs(obr - o_br) * gvf)) / (2 * ng)
                return lt + lb, lctr, loff

            ld, lctr, loff = jax.vmap(one)(
                gt_bboxes, gt_valid, gt_labels, o["tl_heat"], o["br_heat"],
                o["tl_emb"], o["br_emb"], o["tl_off"], o["br_off"])
            losses[f"l{li}.loss_heatmap"] = jnp.mean(ld)
            losses[f"l{li}.loss_centripetal"] = jnp.mean(lctr)
            losses[f"l{li}.loss_offset"] = jnp.mean(loff)
        return losses

    def get_bboxes(self, outs_list, img_shapes, scale_factors, rescale=True,
                   cfg=None, img_stride: float = 4.0):
        (outs,) = (outs_list,) if isinstance(outs_list, list) else outs_list
        o = outs[-1]
        cfg = dict(cfg or self.test_cfg or {})
        k = int(cfg.get("corner_topk", 100))
        max_per_img = int(cfg.get("max_per_img", 100))

        def one(tlh, brh, tlc, brc, tlo, bro, shape, sf):
            h, w, c = tlh.shape
            tls = jax.nn.sigmoid(tlh).reshape(-1)
            brs = jax.nn.sigmoid(brh).reshape(-1)
            ts, ti = jax.lax.top_k(tls, k)
            bs, bi = jax.lax.top_k(brs, k)
            tcls = ti % c
            tpos = ti // c
            tyi = tpos // w
            txi = tpos % w
            bcls = bi % c
            bpos = bi // c
            byi = bpos // w
            bxi = bpos % w
            tx = txi + tlo[tyi, txi, 0]
            ty = tyi + tlo[tyi, txi, 1]
            bx = bxi + bro[byi, bxi, 0]
            by = byi + bro[byi, bxi, 1]
            # predicted group centers from centripetal shifts
            ctx = tx + jnp.exp(tlc[tyi, txi, 0])
            cty = ty + jnp.exp(tlc[tyi, txi, 1])
            cbx = bx - jnp.exp(brc[byi, bxi, 0])
            cby = by - jnp.exp(brc[byi, bxi, 1])
            bw = jnp.maximum(bx[None, :] - tx[:, None], 1e-3)
            bh = jnp.maximum(by[None, :] - ty[:, None], 1e-3)
            # centers must fall in the central region (mu=2.1-ish -> 1/2.1)
            mu = 0.3
            ok = ((jnp.abs(ctx[:, None] - cbx[None, :]) < mu * bw)
                  & (jnp.abs(cty[:, None] - cby[None, :]) < mu * bh))
            same_cls = tcls[:, None] == bcls[None, :]
            geom = (bx[None, :] >= tx[:, None]) & (by[None, :] >= ty[:, None])
            score = jnp.where(ok & same_cls & geom,
                              (ts[:, None] + bs[None, :]) / 2, 0.0)
            flat = score.reshape(-1)
            m = min(max_per_img, flat.shape[0])
            top, pi = jax.lax.top_k(flat, m)
            i1 = pi // k
            i2 = pi % k
            boxes = jnp.stack([tx[i1], ty[i1], bx[i2], by[i2]],
                              -1) * img_stride
            if rescale:
                boxes = boxes / jnp.asarray(sf, jnp.float32).reshape(-1)[:4]
            dets = jnp.concatenate([boxes, top[:, None]], -1)
            return dets, tcls[i1].astype(jnp.int32), top > 0

        return jax.vmap(one)(o["tl_heat"], o["br_heat"], o["tl_emb"],
                             o["br_emb"], o["tl_off"], o["br_off"],
                             img_shapes, scale_factors)


@DETECTORS.register_module()
class CornerNet(SingleStageDetector):
    """Alias (reference mmdet/models/detectors/cornernet.py)."""
    pass
