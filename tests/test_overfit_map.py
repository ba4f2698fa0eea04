"""Accuracy gate: the flagship OA-DG pipeline must LEARN, not just run.

Trains the tiny OA-DG Faster R-CNN (multi-view OA-Mix + OA-Losses) on a
4-image synthetic COCO dataset until it overfits, then drives the REAL
test path (Orbax checkpoint -> tools/test.py -> COCO evaluator) and
asserts train-set bbox mAP.  This is the strongest accuracy evidence
available without network/datasets: it exercises assigner/sampler/coder/
NMS/RoIAlign end-to-end and would catch sign or indexing bugs that
finite-loss smoke tests cannot (reference capability: the mAP numbers in
/root/reference/resources/table1.png, README.md:166).

The synthetic task: solid colored rectangles on a gray background; the
color determines the class.  Trivially separable, so failure to reach
high mAP indicates a framework bug rather than a hard task.
"""
import json
import os.path as osp
import sys

import numpy as np
import pytest

import cv2

N_IMGS = 4
W, H = 96, 64
NUM_VIEWS = 2


def make_dataset(root):
    """4 images, 2 boxes each: red->person, green->car, varying positions."""
    (root / "imgs").mkdir()
    rng = np.random.RandomState(7)
    images, annotations = [], []
    aid = 0
    for i in range(N_IMGS):
        img = np.full((H, W, 3), 114, np.uint8)
        images.append(dict(id=i, file_name=f"i{i}.png", width=W, height=H))
        # two 30x30 boxes, jittered per image, never overlapping (left/right)
        for j, bgr in enumerate([(40, 40, 220), (40, 220, 40)]):  # red, green
            x = 4 + 48 * j + int(rng.randint(0, 10))
            y = 4 + int(rng.randint(0, 26))
            img[y:y + 30, x:x + 30] = bgr
            annotations.append(dict(id=aid, image_id=i, category_id=j + 1,
                                    bbox=[x, y, 30, 30], area=900, iscrowd=0))
            aid += 1
        cv2.imwrite(str(root / "imgs" / f"i{i}.png"), img)
    (root / "ann.json").write_text(json.dumps(dict(
        images=images, annotations=annotations,
        categories=[dict(id=1, name='person'), dict(id=2, name='car')])))


CONFIG_TEMPLATE = """
num_views = {num_views}
model = dict(
    type='FasterRCNN',
    backbone=dict(type='ResNet', depth=18, base_channels=16,
                  stem_channels=16, out_indices=(0, 1, 2, 3)),
    neck=dict(type='FPN', in_channels=[16, 32, 64, 128], out_channels=16,
              num_outs=5),
    rpn_head=dict(
        type='RPNHead', in_channels=16, feat_channels=16,
        anchor_generator=dict(type='AnchorGenerator', scales=[8],
                              ratios=[0.5, 1.0, 2.0],
                              strides=[4, 8, 16, 32, 64]),
        bbox_coder=dict(type='DeltaXYWHBBoxCoder',
                        target_means=[0., 0., 0., 0.],
                        target_stds=[1., 1., 1., 1.]),
        loss_cls=dict(type='CrossEntropyLossPlus', use_sigmoid=True,
                      loss_weight=1.0, num_views=num_views,
                      additional_loss='jsdv1_3_2aug', lambda_weight=0.1),
        loss_bbox=dict(type='L1LossPlus', loss_weight=1.0,
                       num_views=num_views, additional_loss='None')),
    roi_head=dict(
        type='ContrastiveRoIHead',
        bbox_roi_extractor=dict(
            type='SingleRoIExtractor',
            roi_layer=dict(type='RoIAlign', output_size=7, sampling_ratio=0),
            out_channels=16, featmap_strides=[4, 8, 16, 32]),
        bbox_head=dict(
            type='Shared2FCContrastiveHead', in_channels=16,
            fc_out_channels=32, roi_feat_size=7, num_classes=2,
            cont_predictor_cfg=dict(num_linear=2, feat_channels=16),
            bbox_coder=dict(type='DeltaXYWHBBoxCoder',
                            target_means=[0., 0., 0., 0.],
                            target_stds=[0.1, 0.1, 0.2, 0.2]),
            reg_class_agnostic=False,
            loss_cls=dict(type='CrossEntropyLossPlus', use_sigmoid=False,
                          loss_weight=1.0, num_views=num_views,
                          additional_loss='jsdv1_3_2aug', lambda_weight=10),
            loss_bbox=dict(type='SmoothL1LossPlus', beta=1.0, loss_weight=1.0,
                           num_views=num_views, additional_loss='None'),
            loss_cont=dict(type='ContrastiveLossPlus', loss_weight=0.01,
                           temperature=0.06, num_views=num_views,
                           min_samples=2))),
    train_cfg=dict(
        rpn=dict(assigner=dict(type='MaxIoUAssigner', pos_iou_thr=0.7,
                               neg_iou_thr=0.3, min_pos_iou=0.3,
                               match_low_quality=True, ignore_iof_thr=-1),
                 sampler=dict(type='RandomSampler', num=64, pos_fraction=0.5,
                              neg_pos_ub=-1, add_gt_as_proposals=False),
                 allowed_border=-1, pos_weight=-1, debug=False),
        rpn_proposal=dict(nms_pre=100, max_per_img=40,
                          nms=dict(type='nms', iou_threshold=0.7),
                          min_bbox_size=0),
        rcnn=dict(assigner=dict(type='MaxIoUAssigner', pos_iou_thr=0.5,
                                neg_iou_thr=0.5, min_pos_iou=0.5,
                                match_low_quality=False, ignore_iof_thr=-1),
                  sampler=dict(type='RandomSampler', num=64,
                               pos_fraction=0.25, neg_pos_ub=-1,
                               add_gt_as_proposals=True),
                  pos_weight=-1, debug=False),
        random_proposal_cfg=dict(bbox_from='oagrb', num_bboxes=4,
                                 scales=(0.01, 0.3), ratios=(0.3, 1 / 0.3),
                                 iou_max=0.7)),
    test_cfg=dict(
        rpn=dict(nms_pre=100, max_per_img=40,
                 nms=dict(type='nms', iou_threshold=0.7), min_bbox_size=0),
        rcnn=dict(score_thr=0.05, nms=dict(type='nms', iou_threshold=0.5),
                  max_per_img=10)))

img_norm_cfg = dict(mean=[123.675, 116.28, 103.53],
                    std=[58.395, 57.12, 57.375], to_rgb=True)
train_pipeline = [
    dict(type='LoadImageFromFile'),
    dict(type='LoadAnnotations', with_bbox=True),
    dict(type='Resize', img_scale=({w}, {h}), keep_ratio=True),
    dict(type='RandomFlip', flip_ratio=0.0),
    dict(type='OAMix', version='augmix', num_views=num_views,
         keep_orig=True, severity=10),
    dict(type='Normalize', **img_norm_cfg),
    dict(type='Pad', size_divisor=32),
    dict(type='DefaultFormatBundle'),
    dict(type='Collect', keys=['img', 'img2', 'gt_bboxes', 'gt_bboxes2',
                               'gt_labels', 'multilevel_boxes',
                               'oamix_boxes']),
]
test_pipeline = [
    dict(type='LoadImageFromFile'),
    dict(type='MultiScaleFlipAug', img_scale=({w}, {h}), flip=False,
         transforms=[
             dict(type='Resize', keep_ratio=True),
             dict(type='RandomFlip'),
             dict(type='Normalize', **img_norm_cfg),
             dict(type='Pad', size_divisor=32),
             dict(type='ImageToTensor', keys=['img']),
             dict(type='Collect', keys=['img']),
         ])
]
gpu_ids = [0, 1, 2, 3]
data = dict(
    samples_per_gpu=1, workers_per_gpu=1,
    train=dict(type='RepeatDataset', times={repeat},
               dataset=dict(type='CocoDataset', ann_file='{root}/ann.json',
                            img_prefix='{root}/imgs',
                            classes=('person', 'car'),
                            pipeline=train_pipeline)),
    test=dict(type='CocoDataset', ann_file='{root}/ann.json',
              img_prefix='{root}/imgs', classes=('person', 'car'),
              pipeline=test_pipeline, test_mode=True))
optimizer = dict(type='SGD', lr={lr}, momentum=0.9, weight_decay=1e-4)
optimizer_config = dict(grad_clip=None)
lr_config = dict(policy='step', warmup='linear', warmup_iters=30,
                 warmup_ratio=0.1, step=[{decay_epoch}])
runner = dict(type='EpochBasedRunner', max_epochs={epochs})
log_config = dict(interval=10)
checkpoint_config = dict(interval={epochs})
seed = 0
"""


def write_config(tmp_path, root, repeat=25, epochs=12, lr=0.02):
    cfg_path = tmp_path / "overfit_cfg.py"
    cfg_path.write_text(CONFIG_TEMPLATE.format(
        num_views=NUM_VIEWS, w=W, h=H, root=str(root), repeat=repeat,
        epochs=epochs, lr=lr, decay_epoch=max(epochs - 4, 1)))
    return str(cfg_path)


def train(cfg_path, work_dir):
    from oadg_tpu.apis import train_detector
    from oadg_tpu.config import Config
    from oadg_tpu.models import build_detector
    cfg = Config.fromfile(cfg_path)
    cfg["work_dir"] = work_dir
    det = build_detector(dict(cfg.model), num_views=NUM_VIEWS)
    runner = train_detector(det, dict(cfg.data.train), cfg,
                            validate=False, num_views=NUM_VIEWS,
                            work_dir=work_dir)
    return runner


def eval_via_tools_test(cfg_path, ckpt_path, monkeypatch=None):
    """Drive the real CLI: tools/test.py <cfg> <ckpt> --eval bbox."""
    sys.path.insert(0, osp.join(osp.dirname(osp.dirname(
        osp.abspath(__file__))), "tools"))
    import test as tools_test  # tools/test.py
    argv = ["test.py", cfg_path, ckpt_path, "--eval", "bbox"]
    old_argv = sys.argv
    sys.argv = argv
    try:
        metrics = tools_test.main()
    finally:
        sys.argv = old_argv
    return metrics


@pytest.mark.slow
def test_flagship_overfits_to_high_map(tmp_path):
    root = tmp_path / "data"
    root.mkdir()
    make_dataset(root)
    epochs = int(__import__("os").environ.get("OADG_OVERFIT_EPOCHS", "12"))
    cfg_path = write_config(tmp_path, root, repeat=25, epochs=epochs)
    work_dir = str(tmp_path / "work")
    runner = train(cfg_path, work_dir)

    # loss must have decreased substantially over training
    log = [json.loads(l) for l in open(osp.join(work_dir, "log.json"))
           if l.strip()]
    train_logs = [e for e in log if e.get("mode") == "train"]
    first, last = train_logs[0]["loss"], train_logs[-1]["loss"]
    assert last < 0.5 * first, (
        f"loss did not decrease: first={first:.3f} last={last:.3f}")

    ckpt = osp.join(work_dir, "checkpoints", f"epoch_{runner.epoch}")
    assert osp.isdir(ckpt), f"missing checkpoint {ckpt}"
    metrics = eval_via_tools_test(cfg_path, ckpt)
    assert metrics is not None and "bbox_mAP" in metrics, metrics
    print("overfit metrics:", metrics)
    assert metrics["bbox_mAP_50"] >= 0.95, metrics
    assert metrics["bbox_mAP"] >= 0.8, metrics
