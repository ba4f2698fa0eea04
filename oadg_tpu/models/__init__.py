"""Model zoo: backbones, necks, heads, losses, detectors (oadg_tpu.nn modules)."""
from . import layers  # noqa: F401
from .backbones import (csp_darknet, darknet, detectors_resnet,  # noqa: F401
                        hourglass, hrnet, mobilenet_v2, pvt, regnet,
                        resnest, resnet, ssd_vgg, swin, trident_resnet)
from .necks import (extra_necks, fpn, more_necks, yolo_neck,  # noqa: F401
                    yolox_pafpn)
from .dense_heads import (atss_head, autoassign_ld_heads,  # noqa: F401
                          cascade_rpn_head, centernet_head, corner_heads,
                          deformable_detr_head, detr_head, fcos_head,
                          fovea_fsaf_heads, free_anchor_heads, gfl_head,
                          guided_sabl_heads, instance_seg_heads, paa_head,
                          reppoints_head, retina_head, rpn_head, ssd_head,
                          tood_head, vfnet_head, yolo_head, yolof_head,
                          yolox_head)
from .roi_heads import (bbox_heads, cascade_roi_head, mask_heads,  # noqa: F401
                        htc_scnet_heads, more_roi_heads, shared_heads,
                        sparse_roi_head, standard_roi_head)
from .losses import common, extra, oadg  # noqa: F401
from .detectors import panoptic, single_stage, two_stage  # noqa: F401
from .builder import (build_backbone, build_detector, build_head, build_loss,
                      build_neck)

__all__ = ["build_backbone", "build_detector", "build_head", "build_loss",
           "build_neck"]
