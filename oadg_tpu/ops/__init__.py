"""Op substrate: JAX/XLA replacements for the native kernels
the reference delegates to mmcv-CUDA / OpenCV / Pillow (SURVEY.md §2.4)."""
from .image_ops import (box_blur3, gaussian_blur, gaussian_kernel1d,
                        invert_affine, resize_bilinear, rotation_matrix,
                        warp_affine, warp_affine_batch)
from .photometric import (autocontrast, enhance_brightness, enhance_color,
                          enhance_contrast, enhance_sharpness, equalize,
                          grayscale_l, invert, posterize, solarize)
from .deform_conv import (bilinear_gather, deform_conv2d,
                          modulated_deform_conv2d)
from .misc_ops import (carafe, corner_pool, masked_conv_apply, point_sample,
                       roi_pool)
from .roi_align import roi_align
from .saliency import saliency_score, spectral_residual_saliency

__all__ = [
    "bilinear_gather", "deform_conv2d", "modulated_deform_conv2d",
    "carafe", "corner_pool", "masked_conv_apply", "point_sample", "roi_pool",
    "box_blur3", "gaussian_blur", "gaussian_kernel1d", "invert_affine",
    "resize_bilinear", "rotation_matrix", "warp_affine", "warp_affine_batch",
    "autocontrast", "enhance_brightness", "enhance_color", "enhance_contrast",
    "enhance_sharpness", "equalize", "grayscale_l", "invert", "posterize",
    "solarize", "roi_align", "saliency_score", "spectral_residual_saliency",
]
