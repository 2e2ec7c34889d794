from .fused_bn import (
    fused_gemm_stats_backward_plain,
    fused_gemm_stats_plain,
    moments_to_affine,
    stats_to_moments,
)
from .fused_bn_kernel import fused_gemm_stats, fused_gemm_stats_backward
from .iou_kernel import box_iou, box_iou_plain
from .nms import NEG_INF, batched_nms_padded, nms_padded
from .nms_kernel import nms_keep, nms_keep_plain
from .roi_align import (
    multilevel_roi_align_backward_plain,
    multilevel_roi_align_plain,
    roi_level_assignment,
)
from .roi_align_kernel import (
    multilevel_roi_align,
    multilevel_roi_align_backward,
    pool_rois_multilevel,
)
from .scatter_rows import row_segments, scatter_rows_plain, segment_rows_plain
from .scatter_rows_kernel import gather_rows_batched, scatter_rows, segment_rows

__all__ = ["NEG_INF", "batched_nms_padded", "box_iou", "box_iou_plain", "fused_gemm_stats", "fused_gemm_stats_backward",
           "fused_gemm_stats_backward_plain", "fused_gemm_stats_plain", "gather_rows_batched",
           "moments_to_affine",
           "multilevel_roi_align", "multilevel_roi_align_backward",
           "multilevel_roi_align_backward_plain", "multilevel_roi_align_plain", "nms_keep",
           "nms_keep_plain", "nms_padded", "pool_rois_multilevel", "roi_level_assignment",
           "row_segments", "scatter_rows", "scatter_rows_plain", "segment_rows", "segment_rows_plain",
           "stats_to_moments"]
