"""Static-shape RoIAlign in XLA (replaces the mmcv.ops.RoIAlign CUDA kernel).

The reference extracts 7x7 RoI features with
``RoIAlign(output_size=7, sampling_ratio=0, aligned=True)`` (reference
configs/_base_/models/faster_rcnn_r50_fpn.py:39 via
mmdet/models/roi_heads/roi_extractors/base_roi_extractor.py:37).

Design decisions:
- All shapes static: a fixed number of RoIs per call; invalid RoIs are
  processed anyway (garbage-in, masked-out downstream) — branch-free.
- ``sampling_ratio=0`` means per-RoI adaptive grid (ceil(roi/out)) in the
  CUDA kernel; data-dependent grid sizes defeat XLA, so we use a static
  ``sampling_ratio`` (default 2).
  Numerics differ slightly from mmcv for large RoIs; training is unaffected.
- Features are NHWC; the gather is expressed over a flattened (B*H*W, C)
  table so one take covers the batch dimension, and RoIs are chunked through
  ``lax.map`` to bound the transient gather memory.

``roi_align`` differentiates through its gathers (scatter-add under AD);
``roi_align_multilevel`` has a hand-written scatter-add backward.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["roi_align", "roi_align_multilevel", "map_roi_levels"]


@partial(jax.jit, static_argnames=("output_size", "sampling_ratio", "spatial_scale", "chunk"))
def roi_align(feats: jnp.ndarray,
              rois: jnp.ndarray,
              output_size: int = 7,
              spatial_scale: float = 1.0,
              sampling_ratio: int = 2,
              aligned: bool = True,
              chunk: int = 256) -> jnp.ndarray:
    """RoIAlign on batched NHWC features.

    Args:
        feats: (B, H, W, C) feature map.
        rois: (R, 5) [batch_idx, x1, y1, x2, y2] in input-image coordinates.
        output_size: output bins per side (7 for RCNN heads, 14 for masks).
        spatial_scale: feature stride reciprocal (e.g. 1/4 for FPN P2).
        sampling_ratio: sample points per bin side (static; >=1).
        aligned: half-pixel offset (mmcv aligned=True semantics).

    Returns:
        (R, output_size, output_size, C) float32.
    """
    b, h, w, c = feats.shape
    out = output_size
    sr = max(int(sampling_ratio), 1)
    offset = 0.5 if aligned else 0.0
    table = feats.reshape(b * h * w, c)

    r = rois.shape[0]
    pad = (-r) % chunk
    rois_p = jnp.pad(rois, ((0, pad), (0, 0)))

    def one_chunk(rois_c):
        bidx = rois_c[:, 0].astype(jnp.int32)                   # (Rc,)
        x1 = rois_c[:, 1] * spatial_scale - offset
        y1 = rois_c[:, 2] * spatial_scale - offset
        x2 = rois_c[:, 3] * spatial_scale - offset
        y2 = rois_c[:, 4] * spatial_scale - offset
        roi_w = x2 - x1
        roi_h = y2 - y1
        if not aligned:                                         # legacy clamp
            roi_w = jnp.maximum(roi_w, 1.0)
            roi_h = jnp.maximum(roi_h, 1.0)
        bin_w = roi_w / out
        bin_h = roi_h / out
        # sample coords: (Rc, out*sr) per axis
        grid = (jnp.arange(out * sr, dtype=jnp.float32).reshape(out, sr))
        frac = (jnp.arange(sr, dtype=jnp.float32) + 0.5) / sr   # within-bin
        pos = jnp.arange(out, dtype=jnp.float32)[:, None] + frac[None, :]  # (out, sr)
        xs = x1[:, None, None] + pos[None] * bin_w[:, None, None]
        ys = y1[:, None, None] + pos[None] * bin_h[:, None, None]
        xs = xs.reshape(-1, out * sr)                           # (Rc, S)
        ys = ys.reshape(-1, out * sr)

        # CUDA bilinear_interpolate semantics: a sample point outside
        # (-1, W) x (-1, H) contributes zero; otherwise the point is clamped
        # into [0, size-1] and the high tap saturates at the edge.
        okx = (xs > -1.0) & (xs < w)
        oky = (ys > -1.0) & (ys < h)
        px = jnp.clip(xs, 0.0, w - 1)
        py = jnp.clip(ys, 0.0, h - 1)
        x0i = jnp.floor(px).astype(jnp.int32)
        y0i = jnp.floor(py).astype(jnp.int32)
        fx = px - x0i
        fy = py - y0i
        x1i = jnp.minimum(x0i + 1, w - 1)
        y1i = jnp.minimum(y0i + 1, h - 1)

        def gather(yi, xi):
            lin = (bidx[:, None, None] * h + yi[:, :, None]) * w + xi[:, None, :]
            vals = jnp.take(table, lin.reshape(-1), axis=0)
            return vals.reshape(xi.shape[0], yi.shape[1], xi.shape[1], c)

        v00 = gather(y0i, x0i)
        v01 = gather(y0i, x1i)
        v10 = gather(y1i, x0i)
        v11 = gather(y1i, x1i)
        wx = fx[:, None, :, None]
        wy = fy[:, :, None, None]
        val = ((v00 * (1 - wx) + v01 * wx) * (1 - wy)
               + (v10 * (1 - wx) + v11 * wx) * wy)              # (Rc, S, S, C)
        ok = (oky[:, :, None] & okx[:, None, :])[..., None]
        val = jnp.where(ok, val, 0.0)
        val = val.reshape(-1, out, sr, out, sr, c)
        return jnp.mean(val, axis=(2, 4))                       # (Rc, out, out, C)

    chunks = rois_p.reshape(-1, chunk, 5)
    res = jax.lax.map(one_chunk, chunks)
    return res.reshape(-1, out, out, c)[:r]


def map_roi_levels(rois: jnp.ndarray, num_levels: int,
                   finest_scale: int = 56) -> jnp.ndarray:
    """FPN level index per RoI (reference SingleRoIExtractor.map_roi_levels,
    mmdet/models/roi_heads/roi_extractors/single_level_roi_extractor.py:60):
    lvl = floor(log2(sqrt(area) / finest_scale + 1e-6)) clamped to range."""
    scale = jnp.sqrt((rois[:, 3] - rois[:, 1]) * (rois[:, 4] - rois[:, 2]))
    lvl = jnp.floor(jnp.log2(scale / finest_scale + 1e-6))
    return jnp.clip(lvl, 0, num_levels - 1).astype(jnp.int32)


@partial(jax.jit, static_argnames=("output_size", "sampling_ratio",
                                   "featmap_strides", "finest_scale", "chunk"))
def _roi_align_multilevel_impl(feats, rois, output_size: int = 7,
                         featmap_strides=(4, 8, 16, 32),
                         sampling_ratio: int = 2,
                         finest_scale: int = 56,
                         chunk: int = 256) -> jnp.ndarray:
    """RoIAlign across an FPN pyramid in ONE fused gather pass.

    Instead of running the kernel per level and masking (4x waste), all level
    tables are concatenated into a single (sum_l B*H_l*W_l, C) table and each
    RoI's gather indices are offset into its assigned level's region — the
    replacement for the reference's per-level loop
    (single_level_roi_extractor.py:89).

    Args:
        feats: list of (B, H_l, W_l, C) NHWC maps, ordered fine->coarse.
        rois: (R, 5) [batch_idx, x1, y1, x2, y2] image coords.

    Returns: (R, out, out, C).
    """
    num_levels = len(feats)
    b = feats[0].shape[0]
    c = feats[0].shape[-1]
    out = output_size
    sr = max(int(sampling_ratio), 1)

    hs = np.array([f.shape[1] for f in feats])
    ws = np.array([f.shape[2] for f in feats])
    level_off = np.concatenate([[0], np.cumsum(b * hs * ws)[:-1]])
    table = jnp.concatenate([f.reshape(-1, c) for f in feats], axis=0)
    # channel-paired table: row i holds (feat[i], feat[i+1]); one gather per
    # y-tap then fetches both x-taps (half the gathered rows). The +1
    # neighbor crossing a row boundary is harmless: it is only read when
    # fx > 0, which implies x0+1 is in-row.
    table_pair = jnp.concatenate(
        [table, jnp.concatenate([table[1:], table[:1]], axis=0)], axis=1)
    scales = np.array([1.0 / s for s in featmap_strides], np.float32)

    lvl = map_roi_levels(rois, num_levels, finest_scale)         # (R,)
    roi_scale = jnp.asarray(scales)[lvl]
    roi_h = jnp.asarray(hs)[lvl]
    roi_w = jnp.asarray(ws)[lvl]
    roi_off = jnp.asarray(level_off)[lvl]

    r = rois.shape[0]
    pad = (-r) % chunk
    rois_p = jnp.pad(rois, ((0, pad), (0, 0)))
    aux_p = jnp.pad(jnp.stack([roi_scale,
                               roi_h.astype(jnp.float32),
                               roi_w.astype(jnp.float32),
                               roi_off.astype(jnp.float32)], axis=1),
                    ((0, pad), (0, 0)))

    def one_chunk(args):
        rois_c, aux_c = args
        bidx = rois_c[:, 0].astype(jnp.int32)
        sc = aux_c[:, 0]
        fh = aux_c[:, 1]
        fw = aux_c[:, 2]
        off = aux_c[:, 3].astype(jnp.int32)
        fhi = fh.astype(jnp.int32)
        fwi = fw.astype(jnp.int32)

        x1 = rois_c[:, 1] * sc - 0.5
        y1 = rois_c[:, 2] * sc - 0.5
        x2 = rois_c[:, 3] * sc - 0.5
        y2 = rois_c[:, 4] * sc - 0.5
        bin_w = (x2 - x1) / out
        bin_h = (y2 - y1) / out
        frac = (jnp.arange(sr, dtype=jnp.float32) + 0.5) / sr
        pos = jnp.arange(out, dtype=jnp.float32)[:, None] + frac[None, :]
        xs = (x1[:, None, None] + pos[None] * bin_w[:, None, None]).reshape(-1, out * sr)
        ys = (y1[:, None, None] + pos[None] * bin_h[:, None, None]).reshape(-1, out * sr)

        okx = (xs > -1.0) & (xs < fw[:, None])
        oky = (ys > -1.0) & (ys < fh[:, None])
        px = jnp.clip(xs, 0.0, fw[:, None] - 1)
        py = jnp.clip(ys, 0.0, fh[:, None] - 1)
        x0i = jnp.floor(px).astype(jnp.int32)
        y0i = jnp.floor(py).astype(jnp.int32)
        fx = px - x0i
        fy = py - y0i
        y1i = jnp.minimum(y0i + 1, fhi[:, None] - 1)

        def gather_pair(yi):
            lin = (off[:, None, None]
                   + ((bidx[:, None, None] * fhi[:, None, None] + yi[:, :, None])
                      * fwi[:, None, None] + x0i[:, None, :]))
            # mode="clip": indices are in-bounds by construction (coords are
            # clamped above; padded RoIs resolve to level 0 / row 0). The
            # default fill mode materializes a per-element oob select over
            # the (chunk*S^2, 2C) gather output.
            vals = jnp.take(table_pair, lin.reshape(-1), axis=0, mode="clip")
            vals = vals.reshape(yi.shape[0], yi.shape[1], x0i.shape[1], 2 * c)
            return vals[..., :c], vals[..., c:]

        v00, v01 = gather_pair(y0i)
        v10, v11 = gather_pair(y1i)
        wx = fx[:, None, :, None]
        wy = fy[:, :, None, None]
        val = ((v00 * (1 - wx) + v01 * wx) * (1 - wy)
               + (v10 * (1 - wx) + v11 * wx) * wy)
        ok = (oky[:, :, None] & okx[:, None, :])[..., None]
        val = jnp.where(ok, val, 0.0)
        val = val.reshape(-1, out, sr, out, sr, c)
        return jnp.mean(val, axis=(2, 4))

    res = jax.lax.map(one_chunk, (rois_p.reshape(-1, chunk, 5),
                                  aux_p.reshape(-1, chunk, 4)))
    return res.reshape(-1, out, out, c)[:r]


# ---------------------------------------------------------- custom VJP ----
#
# The autodiff transpose of the chunked pair-table gather accumulates a
# DENSE (sum_l B*H_l*W_l, 2C) gradient buffer once per chunk iteration.
# This hand-written backward (mmcv's atomic-add design) recomputes the tap
# indices/weights from the rois (cheap) and issues ONE sparse scatter-add
# into the BASE (N, C) table — no pair-table gradient, no per-chunk dense
# accumulation. RoIs get no gradient (the reference CUDA kernel likewise
# only differentiates w.r.t. features; proposals are stop-gradiented).


def _ml_tap_geometry(rois, output_size, featmap_strides, finest_scale,
                     sampling_ratio, hs, ws, level_off, b):
    """Recompute per-sample-point corner rows + weights (R, S2) arrays."""
    out = output_size
    sr = max(int(sampling_ratio), 1)
    num_levels = len(featmap_strides)
    scales = np.array([1.0 / s for s in featmap_strides], np.float32)
    lvl = map_roi_levels(rois, num_levels, finest_scale)
    sc = jnp.asarray(scales)[lvl]
    fh = jnp.asarray(hs)[lvl].astype(jnp.float32)
    fw = jnp.asarray(ws)[lvl].astype(jnp.float32)
    off = jnp.asarray(level_off)[lvl].astype(jnp.int32)
    fhi = fh.astype(jnp.int32)
    fwi = fw.astype(jnp.int32)
    bidx = rois[:, 0].astype(jnp.int32)

    x1 = rois[:, 1] * sc - 0.5
    y1 = rois[:, 2] * sc - 0.5
    x2 = rois[:, 3] * sc - 0.5
    y2 = rois[:, 4] * sc - 0.5
    bin_w = (x2 - x1) / out
    bin_h = (y2 - y1) / out
    frac = (jnp.arange(sr, dtype=jnp.float32) + 0.5) / sr
    pos = jnp.arange(out, dtype=jnp.float32)[:, None] + frac[None, :]
    xs = (x1[:, None, None] + pos[None] * bin_w[:, None, None]).reshape(
        -1, out * sr)
    ys = (y1[:, None, None] + pos[None] * bin_h[:, None, None]).reshape(
        -1, out * sr)
    okx = (xs > -1.0) & (xs < fw[:, None])
    oky = (ys > -1.0) & (ys < fh[:, None])
    px = jnp.clip(xs, 0.0, fw[:, None] - 1)
    py = jnp.clip(ys, 0.0, fh[:, None] - 1)
    x0i = jnp.floor(px).astype(jnp.int32)
    y0i = jnp.floor(py).astype(jnp.int32)
    fx = px - x0i
    fy = py - y0i
    y1i = jnp.minimum(y0i + 1, fhi[:, None] - 1)
    x1i = jnp.minimum(x0i + 1, fwi[:, None] - 1)

    def rows(yi, xi):
        return (off[:, None, None]
                + ((bidx[:, None, None] * fhi[:, None, None]
                    + yi[:, :, None]) * fwi[:, None, None] + xi[:, None, :]))

    ok = oky[:, :, None] & okx[:, None, :]
    wx = fx[:, None, :]
    wy = fy[:, :, None]
    okf = ok.astype(jnp.float32)
    return ((rows(y0i, x0i), okf * (1 - wy) * (1 - wx)),
            (rows(y0i, x1i), okf * (1 - wy) * wx),
            (rows(y1i, x0i), okf * wy * (1 - wx)),
            (rows(y1i, x1i), okf * wy * wx))


@partial(jax.custom_vjp, nondiff_argnums=(2, 3, 4, 5, 6))
def _roi_align_multilevel_vjp(feats, rois, output_size,
                              featmap_strides, sampling_ratio,
                              finest_scale, chunk):
    return _roi_align_multilevel_impl(
        feats, rois, output_size=output_size,
        featmap_strides=tuple(featmap_strides),
        sampling_ratio=sampling_ratio, finest_scale=finest_scale,
        chunk=chunk)


def _ml_fwd(feats, rois, output_size, featmap_strides, sampling_ratio,
            finest_scale, chunk):
    out = _roi_align_multilevel_vjp(feats, rois, output_size,
                                    featmap_strides, sampling_ratio,
                                    finest_scale, chunk)
    return out, (rois, feats)


def _ml_bwd(output_size, featmap_strides, sampling_ratio, finest_scale,
            chunk, residuals, g):
    rois, feats = residuals
    shapes = [(f.shape, f.dtype) for f in feats]
    out = output_size
    sr = max(int(sampling_ratio), 1)
    b = shapes[0][0][0]
    c = shapes[0][0][3]
    hs = np.array([sh[0][1] for sh in shapes])
    ws = np.array([sh[0][2] for sh in shapes])
    level_off = np.concatenate([[0], np.cumsum(b * hs * ws)[:-1]])
    n_rows = int(np.sum(b * hs * ws))

    taps = _ml_tap_geometry(rois, out, featmap_strides, finest_scale,
                            sampling_ratio, hs, ws, level_off, b)
    gpt = g.astype(jnp.float32) / (sr * sr)
    gpt = jnp.repeat(jnp.repeat(gpt, sr, axis=1), sr, axis=2)
    gpt = gpt.reshape(rois.shape[0], out * sr, out * sr, c)
    rows_all = jnp.concatenate([ri.reshape(-1) for ri, _ in taps])
    upds_all = jnp.concatenate(
        [(gpt * w[..., None]).reshape(-1, c) for _, w in taps])
    # One combined scatter-add over the four bilinear taps (four .at[].add
    # calls would make four passes over the table). The table accumulates
    # in float32 whatever the feature dtype: rois overlap, and the
    # scatter's atomics add them in no fixed order, which a bf16 sum would
    # round differently from run to run.
    d_table = jnp.zeros((n_rows, c), jnp.float32).at[rows_all].add(
        upds_all, mode="drop")
    d_feats = []
    start = 0
    for (shape, dt) in shapes:
        cnt = int(np.prod(shape[:3]))
        d_feats.append(d_table[start:start + cnt].reshape(shape).astype(dt))
        start += cnt
    return (list(d_feats), jnp.zeros_like(rois))


_roi_align_multilevel_vjp.defvjp(_ml_fwd, _ml_bwd)


def roi_align_multilevel(feats, rois, output_size: int = 7,
                         featmap_strides=(4, 8, 16, 32),
                         sampling_ratio: int = 2,
                         finest_scale: int = 56,
                         chunk: int = 256):
    """Public entry (kwargs-friendly wrapper over the custom-VJP core)."""
    return _roi_align_multilevel_vjp(list(feats), rois, int(output_size),
                                     tuple(featmap_strides),
                                     int(sampling_ratio), int(finest_scale),
                                     int(chunk))
