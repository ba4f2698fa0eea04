"""Model builders (reference mmdet/models/builder.py contract)."""
from __future__ import annotations

from typing import Optional

from ..utils.registry import (BACKBONES, DETECTORS, HEADS, LOSSES, NECKS,
                              build_from_cfg)


def build_backbone(cfg):
    return build_from_cfg(dict(cfg), BACKBONES)


def build_neck(cfg):
    return build_from_cfg(dict(cfg), NECKS)


def build_head(cfg):
    return build_from_cfg(dict(cfg), HEADS)


def build_loss(cfg):
    return build_from_cfg(dict(cfg), LOSSES)


def build_detector(cfg, train_cfg=None, test_cfg=None, num_views: int = 1,
                   dtype=None):
    """Build a detector module from an mmdet-style config dict.

    ``train_cfg``/``test_cfg`` may live in the model cfg (mmdet 2.x new
    style) or be passed separately (legacy style, reference
    tools/train.py:167-171). ``num_views`` mirrors the kwarg
    ``integrate_data`` injects (reference base.py:22-48) and is static here.
    """
    cfg = dict(cfg)
    t = cfg.pop("type")
    cfg.setdefault("train_cfg", train_cfg)
    cfg.setdefault("test_cfg", test_cfg)
    if cfg.get("train_cfg") is None:
        cfg["train_cfg"] = train_cfg
    if cfg.get("test_cfg") is None:
        cfg["test_cfg"] = test_cfg
    cfg.pop("pretrained", None)
    cls = DETECTORS.get(t)
    if cls is None:
        raise KeyError(f"{t} is not a registered detector")
    return cls(**cfg, num_views=num_views, dtype=dtype)
