# Mask R-CNN R50-FPN model schema (parity with the reference base model
# config mask_rcnn_r50_fpn.py; mask branch is the static-shape FCNMaskHead +
# box-cropped static-shape gt masks).
_base_ = './faster_rcnn_r50_fpn.py'
model = dict(
    type='MaskRCNN',
    roi_head=dict(
        mask_roi_extractor=dict(
            type='SingleRoIExtractor',
            roi_layer=dict(type='RoIAlign', output_size=14, sampling_ratio=0),
            out_channels=256,
            featmap_strides=[4, 8, 16, 32]),
        mask_head=dict(
            type='FCNMaskHead',
            num_convs=4,
            in_channels=256,
            conv_out_channels=256,
            num_classes=80,
            loss_mask=dict(type='CrossEntropyLoss', use_mask=True,
                           loss_weight=1.0))),
    train_cfg=dict(rcnn=dict(mask_size=28)),
    test_cfg=dict(rcnn=dict(mask_thr_binary=0.5)))
