"""The port's ops, with the names scflow_tpu.ops exports, imported at
first use."""

from scflow_tpu_torch import lazy_exports

__all__, __getattr__ = lazy_exports(__name__, {
    "grid_sample": "sampling", "sample_at_pixels": "sampling",
    "interpolate_bilinear": "resize", "avg_pool2": "resize", "resize_align_corners": "resize",
    "correlation_pyramid": "corr", "corr_lookup": "corr",
    "convex_upsample": "upsample", "unfold3x3": "upsample",
    "nn_points": "knn", "backward_warp": "warp",
})
