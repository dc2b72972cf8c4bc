"""The ortho raster and contour stage of the port (imports no jax)."""

from buildingsegment_tpu_torch.raster.ortho import (
    ground_threshold,
    compute_ortho_images,
    normalize_to_png,
    render_ortho_views,
)
from buildingsegment_tpu_torch.raster.contours import (
    morphology_close,
    extract_contours,
    extracted_contour,
)

__all__ = [
    "ground_threshold",
    "compute_ortho_images",
    "normalize_to_png",
    "render_ortho_views",
    "morphology_close",
    "extract_contours",
    "extracted_contour",
]
