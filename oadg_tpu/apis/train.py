"""train_detector API (reference mmdet/apis/train.py:71-212).

Assembles loaders, the jitted data-parallel train step (with on-device
OA-Mix when the pipeline contains an OAMix op), runner + hooks, and runs.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional

import jax
import numpy as np

from ..data import build_dataloader, build_dataset
from ..engine.preprocess import make_oadg_preprocess
from ..engine.runner import EpochBasedRunner, get_root_logger
from ..parallel.mesh import make_mesh


def init_random_seed(seed: Optional[int] = None) -> int:
    """Reference apis/train.py:19 — one seed for every host (a single jax
    process sees the whole mesh, so no broadcast is needed)."""
    if seed is not None:
        return seed
    return int(np.random.randint(2 ** 31))


def set_random_seed(seed: int, deterministic: bool = False):
    np.random.seed(seed)
    import random
    random.seed(seed)


def _find_pipeline_op(pipeline, op_type: str):
    for p in pipeline or []:
        if isinstance(p, dict) and p.get("type") == op_type:
            return p
    return None


def _static_hw_from_pipeline(pipeline, divisor: int = 32):
    """Static batch canvas: the max resize scale rounded up to divisor."""
    r = _find_pipeline_op(pipeline, "Resize")
    if r is None or r.get("img_scale") is None:
        return None
    scales = r["img_scale"]
    if not isinstance(scales, list):
        scales = [scales]
    long_edge = max(max(s) for s in scales)
    short_edge = max(min(s) for s in scales)
    rnd = lambda v: ((v + divisor - 1) // divisor) * divisor
    return (rnd(short_edge), rnd(long_edge))


def data_parallel_devices(samples_per_gpu: int, gpu_ids=None):
    """The devices a training run spans and the loader batch of this
    process: every device takes ``samples_per_gpu`` images (the
    reference's per-GPU batch), so the global batch is ``samples_per_gpu``
    x the device count. ``gpu_ids`` (reference ``cfg.gpu_ids``) restricts
    a single-process run to those devices."""
    if samples_per_gpu < 1:
        raise ValueError(f"samples_per_gpu must be >= 1, got "
                         f"{samples_per_gpu}")
    devices = jax.devices()
    if gpu_ids is not None:
        if jax.process_count() > 1:
            raise ValueError("gpu_ids selects devices of a single-process "
                             "run")
        devices = [devices[i] for i in gpu_ids]
    local = sum(d.process_index == jax.process_index() for d in devices)
    return devices, samples_per_gpu * local


def train_detector(detector, dataset, cfg, distributed: bool = False,
                   validate: bool = False, timestamp=None, meta=None,
                   num_views: int = 1, work_dir: Optional[str] = None):
    """Build everything and run the training loop.

    ``detector`` is the module from build_detector; ``dataset`` the
    built train dataset (or cfg dict).
    """
    work_dir = work_dir or cfg.get("work_dir", "./work_dirs/default")
    logger = get_root_logger(os.path.join(work_dir, "train.log")
                             if os.path.isdir(work_dir) else None)

    if isinstance(dataset, dict):
        dataset = build_dataset(dataset)

    data_cfg = dict(cfg.data)
    train_data_cfg = dict(data_cfg["train"])
    pipeline = (train_data_cfg.get("pipeline")
                or dict(train_data_cfg.get("dataset", {})).get("pipeline"))
    static_hw = _static_hw_from_pipeline(pipeline)
    gpu_ids = cfg.get("gpu_ids")
    devices, local_batch = data_parallel_devices(
        int(data_cfg.get("samples_per_gpu", 2)),
        None if gpu_ids is None else list(gpu_ids))
    loader = build_dataloader(
        dataset,
        samples_per_gpu=local_batch,
        workers_per_gpu=int(data_cfg.get("workers_per_gpu", 2)),
        seed=cfg.get("seed", 0), static_hw=static_hw,
        max_gt=int(cfg.get("max_gt", 128)))

    preprocess = None
    oamix_op = _find_pipeline_op(pipeline, "OAMix")
    if oamix_op is not None:
        norm_op = _find_pipeline_op(pipeline, "Normalize") or {}
        # emit the integrated image stack in the model's compute dtype
        # (bf16 models cast at the first conv anyway; producing bf16 here
        # halves the bytes of the largest non-conv tensor in the step)
        preprocess = make_oadg_preprocess(
            dict(oamix_op), dict(norm_op),
            out_dtype=getattr(detector, "dtype", None))
        logger.info("OA-Mix runs on-device inside the train step")

    mesh = None
    if devices != jax.devices()[:1]:
        mesh = make_mesh(n_data=len(devices), devices=devices)
        logger.info(f"data-parallel mesh over {len(devices)} devices across "
                    f"{jax.process_count()} process(es), "
                    f"{local_batch} images per step from this process")

    val_dataset = val_loader = None
    if validate:
        val_cfg = dict(data_cfg["val"])
        val_cfg["test_mode"] = True
        val_dataset = build_dataset(val_cfg)
        val_loader = build_dataloader(
            val_dataset, samples_per_gpu=1,
            workers_per_gpu=int(data_cfg.get("workers_per_gpu", 2)),
            shuffle=False,
            static_hw=_static_hw_from_pipeline(val_cfg.get("pipeline")))

    runner = EpochBasedRunner(detector, cfg, loader, work_dir,
                              val_dataset=val_dataset, val_loader=val_loader,
                              mesh=mesh, preprocess=preprocess, logger=logger,
                              seed=int(cfg.get("seed", 0) or 0))
    # backbone Pretrained init (reference: mmcv init_cfg / model.pretrained,
    # e.g. open-mmlab://detectron2/resnet101_caffe in the DWD flagship
    # recipe, faster_rcnn_r101_dc5_1x_dwd.py:9-11): merge the (resolved,
    # downloaded, converted) backbone weights into the fresh init before
    # any load_from/resume overrides them.
    model_cfg = dict(cfg.get("model") or {})
    bb_cfg = dict(model_cfg.get("backbone") or {})
    init_cfg = dict(bb_cfg.get("init_cfg") or {})
    pretrained = (init_cfg.get("checkpoint")
                  if init_cfg.get("type") == "Pretrained" else None)
    pretrained = pretrained or model_cfg.get("pretrained")
    if pretrained:
        from ..utils.checkpoint import (load_checkpoint_variables,
                                        merge_variables)
        logger.info(f"initializing backbone from {pretrained}")
        pre = load_checkpoint_variables(pretrained)
        merged = merge_variables(
            {"params": runner.params,
             "batch_stats": runner.batch_stats or {}}, pre, logger=logger)
        runner.params = merged["params"]
        if runner.batch_stats is not None:
            runner.batch_stats = merged["batch_stats"]
    if cfg.get("resume_from"):
        runner.resume(cfg["resume_from"])
    elif cfg.get("auto_resume"):
        runner.resume(auto=True)
    elif cfg.get("load_from"):
        from ..utils.checkpoint import load_checkpoint_variables
        runner.load_weights(load_checkpoint_variables(cfg["load_from"]))
    runner.run()
    return runner
