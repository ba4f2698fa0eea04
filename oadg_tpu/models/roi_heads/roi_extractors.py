"""RoI feature extractors as registry components.

- SingleRoIExtractor (reference mmdet/models/roi_heads/roi_extractors/
  single_level_roi_extractor.py:12): area-mapped level per roi, one fused
  multilevel RoIAlign (ops/roi_align.py).
- GenericRoIExtractor (reference generic_roi_extractor.py:10): extract
  from ALL levels and aggregate by sum or concat, with optional pre/post
  conv modules.
"""
from __future__ import annotations

from typing import Any, Sequence

import jax.numpy as jnp

from ... import nn
from ...ops.roi_align import roi_align, roi_align_multilevel
from ...utils.registry import ROI_EXTRACTORS
from ..layers import ConvModule


@ROI_EXTRACTORS.register_module()
class SingleRoIExtractor(nn.Module):
    roi_layer: Any = None
    out_channels: int = 256
    featmap_strides: Sequence[int] = (4, 8, 16, 32)
    finest_scale: int = 56
    init_cfg: Any = None
    dtype: Any = None

    @property
    def num_inputs(self):
        return len(self.featmap_strides)

    def __call__(self, feats, rois, out_size: int = None):
        layer = dict(self.roi_layer or dict(output_size=7))
        out = int(out_size or layer.get("output_size", 7))
        sr = int(layer.get("sampling_ratio", 0)) or 2
        return roi_align_multilevel(
            list(feats[: len(self.featmap_strides)]), rois,
            output_size=out, featmap_strides=tuple(self.featmap_strides),
            sampling_ratio=sr, finest_scale=self.finest_scale)


@ROI_EXTRACTORS.register_module()
class GenericRoIExtractor(nn.Module):
    """All-level extraction + aggregation (reference
    generic_roi_extractor.py:10, used by e.g. GRoIE configs)."""
    roi_layer: Any = None
    out_channels: int = 256
    featmap_strides: Sequence[int] = (4, 8, 16, 32)
    aggregation: str = "sum"
    pre_cfg: Any = None
    post_cfg: Any = None
    init_cfg: Any = None
    dtype: Any = None

    @property
    def num_inputs(self):
        return len(self.featmap_strides)

    @nn.compact
    def __call__(self, feats, rois, out_size: int = None):
        assert self.aggregation in ("sum", "concat")
        layer = dict(self.roi_layer or dict(output_size=7))
        out = int(out_size or layer.get("output_size", 7))
        sr = int(layer.get("sampling_ratio", 0)) or 2
        parts = []
        for i, stride in enumerate(self.featmap_strides):
            r = roi_align(feats[i], rois, output_size=out,
                          spatial_scale=1.0 / stride, sampling_ratio=sr)
            if self.pre_cfg is not None:
                pc = dict(self.pre_cfg)
                pc.pop("type", None)
                r = ConvModule(pc.get("out_channels", self.out_channels),
                               pc.get("kernel_size", 3), 1,
                               pc.get("padding", 1),
                               norm_cfg=pc.get("norm_cfg"),
                               dtype=self.dtype, name=f"pre{i}")(r)
            parts.append(r)
        if self.aggregation == "sum":
            agg = sum(parts)
        else:
            agg = jnp.concatenate(parts, axis=-1)
        if self.post_cfg is not None:
            pc = dict(self.post_cfg)
            pc.pop("type", None)
            agg = ConvModule(pc.get("out_channels", self.out_channels),
                             pc.get("kernel_size", 3), 1,
                             pc.get("padding", 1),
                             norm_cfg=pc.get("norm_cfg"),
                             dtype=self.dtype, name="post")(agg)
        return agg
