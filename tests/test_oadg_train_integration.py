"""Flagship-path integration: train_detector with an OAMix pipeline — the
full chain loader -> on-device OA-Mix preprocess -> multi-view detector ->
OA-Loss -> SGD, on a tiny synthetic dataset (CPU)."""
import json
import os.path as osp

import numpy as np
import pytest

import cv2

from oadg_tpu.config import Config


@pytest.fixture(scope="module")
def oadg_setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("oadg")
    (root / "imgs").mkdir()
    rng = np.random.RandomState(0)
    images, annotations = [], []
    for i in range(4):
        img = rng.randint(0, 255, (64, 96, 3)).astype(np.uint8)
        cv2.imwrite(str(root / "imgs" / f"i{i}.png"), img)
        images.append(dict(id=i, file_name=f"i{i}.png", width=96, height=64))
        for j in range(2):
            annotations.append(dict(
                id=2 * i + j, image_id=i, category_id=j + 1,
                bbox=[8 + 40 * j, 8, 30, 30], area=900, iscrowd=0))
    (root / "ann.json").write_text(json.dumps(dict(
        images=images, annotations=annotations,
        categories=[dict(id=1, name='person'), dict(id=2, name='car')])))
    return str(root)


@pytest.mark.slow
def test_oadg_train_two_iters(oadg_setup, tmp_path):
    root = oadg_setup
    from tests.test_forward import TEST_CFG, TRAIN_CFG
    num_views = 2
    model = dict(
        type='FasterRCNN',
        backbone=dict(type='ResNet', depth=18, base_channels=16,
                      stem_channels=16, out_indices=(0, 1, 2, 3)),
        neck=dict(type='FPN', in_channels=[16, 32, 64, 128],
                  out_channels=16, num_outs=5),
        rpn_head=dict(
            type='RPNHead', in_channels=16, feat_channels=16,
            anchor_generator=dict(scales=[8], ratios=[0.5, 1.0, 2.0],
                                  strides=[4, 8, 16, 32, 64]),
            loss_cls=dict(type='CrossEntropyLossPlus', use_sigmoid=True,
                          loss_weight=1.0, num_views=num_views,
                          additional_loss='jsdv1_3_2aug', lambda_weight=0.1),
            loss_bbox=dict(type='L1LossPlus', loss_weight=1.0,
                           num_views=num_views, additional_loss="None")),
        roi_head=dict(
            type='ContrastiveRoIHead',
            bbox_roi_extractor=dict(
                roi_layer=dict(output_size=7, sampling_ratio=0),
                out_channels=16, featmap_strides=[4, 8, 16, 32]),
            bbox_head=dict(
                type='Shared2FCContrastiveHead', in_channels=16,
                fc_out_channels=32, num_classes=2,
                cont_predictor_cfg=dict(num_linear=2, feat_channels=16),
                loss_cls=dict(type='CrossEntropyLossPlus',
                              use_sigmoid=False, loss_weight=1.0,
                              num_views=num_views,
                              additional_loss='jsdv1_3_2aug',
                              lambda_weight=10),
                loss_bbox=dict(type='SmoothL1LossPlus', beta=1.0,
                               loss_weight=1.0, num_views=num_views,
                               additional_loss="None"),
                loss_cont=dict(type='ContrastiveLossPlus', loss_weight=0.01,
                               temperature=0.06, num_views=num_views,
                               min_samples=2))),
        train_cfg=dict(
            **TRAIN_CFG,
            random_proposal_cfg=dict(bbox_from='oagrb', num_bboxes=4,
                                     scales=(0.01, 0.3),
                                     ratios=(0.3, 1 / 0.3), iou_max=0.7)),
        test_cfg=TEST_CFG)

    img_norm = dict(mean=[123.675, 116.28, 103.53],
                    std=[58.395, 57.12, 57.375], to_rgb=True)
    train_pipeline = [
        dict(type='LoadImageFromFile'),
        dict(type='LoadAnnotations', with_bbox=True),
        dict(type='Resize', img_scale=(96, 64), keep_ratio=True),
        dict(type='RandomFlip', flip_ratio=0.5),
        dict(type='OAMix', version='augmix', num_views=num_views,
             keep_orig=True, severity=10),
        dict(type='Normalize', **img_norm),
        dict(type='Pad', size_divisor=32),
        dict(type='DefaultFormatBundle'),
        dict(type='Collect', keys=['img', 'img2', 'gt_bboxes', 'gt_bboxes2',
                                   'gt_labels', 'multilevel_boxes',
                                   'oamix_boxes']),
    ]
    cfg = Config(dict(
        model=model, num_views=num_views, gpu_ids=[0, 1],
        data=dict(samples_per_gpu=1, workers_per_gpu=1,
                  train=dict(type='CocoDataset',
                             ann_file=osp.join(root, "ann.json"),
                             img_prefix=osp.join(root, "imgs"),
                             classes=('person', 'car'),
                             pipeline=train_pipeline)),
        optimizer=dict(type='SGD', lr=0.01, momentum=0.9, weight_decay=1e-4),
        optimizer_config=dict(grad_clip=None),
        lr_config=dict(policy='step', warmup='linear', warmup_iters=2,
                       warmup_ratio=0.1, step=[1]),
        runner=dict(type='EpochBasedRunner', max_epochs=1),
        log_config=dict(interval=1), checkpoint_config=dict(interval=1),
        work_dir=str(tmp_path), seed=0))

    from oadg_tpu.apis import train_detector
    from oadg_tpu.models import build_detector
    det = build_detector(dict(cfg.model), num_views=num_views)
    runner = train_detector(det, dict(cfg.data.train), cfg,
                            validate=False, num_views=num_views,
                            work_dir=str(tmp_path))
    assert runner.epoch == 1
    log = [json.loads(l) for l in open(osp.join(str(tmp_path), "log.json"))
           if l.strip()]
    train_logs = [e for e in log if e.get("mode") == "train"]
    assert train_logs, "no training iterations logged"
    assert all(np.isfinite(e["loss"]) for e in train_logs)
    # contrastive + jsd losses present in the logged keys
    assert "loss_cont" in train_logs[-1]
