from .nms import NEG_INF, batched_nms_padded, nms_padded
from .nms_kernel import nms_keep, nms_keep_plain
from .roi_align import multilevel_roi_align_plain, roi_level_assignment
from .roi_align_kernel import multilevel_roi_align, pool_rois_multilevel

__all__ = ["NEG_INF", "batched_nms_padded", "multilevel_roi_align", "multilevel_roi_align_plain",
           "nms_keep", "nms_keep_plain", "nms_padded", "pool_rois_multilevel", "roi_level_assignment"]
