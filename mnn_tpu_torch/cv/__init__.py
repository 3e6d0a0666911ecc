"""The CV library on the port: colour, geometry, filters, histograms,
structural analysis, calib3d, drawing, codecs and `ImageProcess`.

Counterpart of the JAX package's `cv/` (the reference's OpenCV-like
tools/cv and source/cv ImageProcess). Image work runs on tensors on the
caller's device (an array goes to the card unless `device="cpu"`);
drawing and the small geometric reductions stay host-side numpy. The
codecs use PIL, imported inside `imread` / `imwrite` only.
"""

from mnn_tpu_torch.cv.color import (cvt_color, rgb_to_bgr, rgb_to_gray, yuv_nv12_to_rgb,
                                    yuv_nv21_to_rgb)
from mnn_tpu_torch.cv.filter import (bilateral_filter, blur, box_filter, dilate, erode,
                                     filter2d, gaussian_blur, get_deriv_kernels,
                                     get_gaussian_kernel, get_structuring_element, laplacian,
                                     morphology_ex, pyr_down, pyr_up, scharr, sep_filter2d,
                                     sobel, spatial_gradient, sqr_box_filter)
from mnn_tpu_torch.cv.geometric import (center_crop, crop, flip, get_affine_transform, pad,
                                        resize, rotate90, warp_affine)
from mnn_tpu_torch.cv.histogram import (adaptive_threshold, blend_linear, calc_hist,
                                        equalize_hist, integral, threshold)
from mnn_tpu_torch.cv.image_process import ImageProcess, ImageProcessConfig
from mnn_tpu_torch.cv.structural import (bounding_rect, box_points, connected_components,
                                         connected_components_with_stats, contour_area,
                                         convex_hull, min_area_rect)


def imread(path: str, fmt: str = "rgb"):
    """Decode an image file -> uint8 HWC numpy array (PIL, as cv::imread)."""
    import numpy as np
    from PIL import Image

    img = Image.open(path)
    img = img.convert("L" if fmt == "gray" else "RGB")
    arr = np.asarray(img)
    if fmt == "bgr":
        arr = arr[..., ::-1]
    return arr


def imwrite(path: str, img, src_fmt: str = "rgb") -> None:
    """Encode a uint8 HWC image (an array, or a tensor on any device)."""
    import numpy as np
    from PIL import Image

    from mnn_tpu_torch.cv.common import host

    arr = host(img)
    if src_fmt == "bgr":
        arr = arr[..., ::-1]
    Image.fromarray(arr.astype(np.uint8)).save(path)


__all__ = [
    "ImageProcess", "ImageProcessConfig", "center_crop", "crop", "cvt_color",
    "flip", "get_affine_transform", "imread", "imwrite", "pad", "resize",
    "rgb_to_bgr", "rgb_to_gray", "rotate90", "warp_affine",
    "yuv_nv12_to_rgb", "yuv_nv21_to_rgb",
]
