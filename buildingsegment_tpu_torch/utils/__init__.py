"""Host helpers of the port: the synthetic scenes with known planes and
the label-agreement metric (copies of the JAX package's modules)."""

from buildingsegment_tpu_torch.utils.quality import bij_agreement
from buildingsegment_tpu_torch.utils.synthetic import make_building_cloud

__all__ = ["bij_agreement", "make_building_cloud"]
