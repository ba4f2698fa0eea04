"""OAMix pipeline op — an on-device split of the reference's CPU augmentation.

The reference runs the full OA-Mix algorithm per sample inside dataloader
worker processes (reference mmdet/datasets/pipelines/oa_mix.py:187-243);
SURVEY.md §3.1 identifies that CPU loop as the throughput bottleneck.

Design: this pipeline op does NOT augment. It records the OA-Mix
configuration and view bookkeeping on the sample; the batched augmentation
(multi-view chain-and-mix, saliency gating, object-aware mixing) runs
on-device as fused XLA kernels over the whole batch
(:mod:`oadg_tpu.ops.oamix_device`), invoked by the train step before the
forward pass. ``custom_field`` mirrors the reference contract so configs and
downstream consumers (Collect keys img2/gt_bboxes2/multilevel_boxes/
oamix_boxes) keep working.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np

from ...utils.registry import PIPELINES


@PIPELINES.register_module()
class OAMix:
    def __init__(self, version: str = "augmix", num_views: int = 2,
                 keep_orig: bool = True, severity: int = 10,
                 mixture_width: int = 3, mixture_depth: int = -1,
                 random_box_scale=(0.01, 0.1), random_box_ratio=(3, 1 / 3),
                 oa_random_box_scale=(0.005, 0.1),
                 oa_random_box_ratio=(3, 1 / 3), num_bboxes=(3, 5),
                 spatial_ratio: int = 4, sigma_ratio: float = 0.3,
                 on_device: bool = True, **kwargs):
        self.cfg = dict(
            version=version, num_views=num_views, keep_orig=keep_orig,
            severity=severity, mixture_width=mixture_width,
            mixture_depth=mixture_depth, random_box_scale=random_box_scale,
            random_box_ratio=random_box_ratio,
            oa_random_box_scale=oa_random_box_scale,
            oa_random_box_ratio=oa_random_box_ratio, num_bboxes=num_bboxes,
            spatial_ratio=spatial_ratio, sigma_ratio=sigma_ratio)
        self.num_views = num_views
        self.keep_orig = keep_orig
        self.on_device = on_device

    def _call_host(self, results: Dict[str, Any]) -> Dict[str, Any]:
        """CPU oracle path (reference OAMix.__call__, oa_mix.py:187): runs
        the full per-sample algorithm on host and materializes img2.. ."""
        from .oa_mix_host import oamix_host
        results["custom_field"] = []
        history: Dict[str, Any] = {}
        for i in range(1, self.num_views + 1):
            if i == 1:
                history = {}
                if not self.keep_orig:
                    results["img"] = oamix_host(results["img"].copy(),
                                                results["gt_bboxes"].copy(),
                                                self.cfg, history)
                results["img_fields"] = ["img"]
            else:
                results[f"img{i}"] = oamix_host(results["img"].copy(),
                                                results["gt_bboxes"].copy(),
                                                self.cfg, history)
                results["img_fields"] += [f"img{i}"]
                results[f"gt_bboxes{i}"] = results["gt_bboxes"].copy()
                results["oamix_boxes"] = history["oa_random_box_list"]
                results["multilevel_boxes"] = history["random_box_list"]
                results["custom_field"] += [f"img{i}", f"gt_bboxes{i}",
                                            "oamix_boxes", "multilevel_boxes"]
        return results

    def __call__(self, results: Dict[str, Any]) -> Dict[str, Any]:
        if not self.on_device:
            return self._call_host(results)
        # Mark for on-device augmentation; keep the reference's field
        # contract (img2.. / gt_bboxes2.. / custom_field) so Collect works.
        # A pristine pre-Normalize copy rides along — the device kernels
        # augment raw [0,255] pixels exactly like the reference does before
        # its Normalize step (reference pipeline order, SURVEY.md §3.2).
        #
        # Host-cost contract (Normalize is the largest host pipeline
        # cost): ``norm_on_device`` tells the
        # downstream Normalize to skip the pixel math (the device
        # preprocess normalizes BOTH the clean view and the aug views
        # on-chip from img_raw), and the placeholder views stay OUT of
        # img_fields so Normalize/Pad never touch them — the collate
        # ships only the uint8 img_raw (4x less host->device traffic).
        results["img_raw"] = np.ascontiguousarray(results["img"])
        results["norm_on_device"] = True
        results["oamix_cfg"] = self.cfg
        # norm_on_device rides custom_field so Collect keeps it and the
        # static collate can see it per-sample.
        results["custom_field"] = ["img_raw", "norm_on_device"]
        results["img_fields"] = ["img"]
        for i in range(2, self.num_views + 1):
            results[f"img{i}"] = results["img"]        # placeholder view;
            results[f"gt_bboxes{i}"] = results["gt_bboxes"].copy()
            results["custom_field"] += [f"img{i}", f"gt_bboxes{i}"]
        # random-box fields are produced on device; declare empty shells
        results.setdefault("multilevel_boxes", np.zeros((0, 4), np.float32))
        results.setdefault("oamix_boxes", np.zeros((0, 4), np.float32))
        results["custom_field"] += ["multilevel_boxes", "oamix_boxes"]
        return results

    def __repr__(self):
        return f"OAMix(num_views={self.num_views}, on_device=True)"
