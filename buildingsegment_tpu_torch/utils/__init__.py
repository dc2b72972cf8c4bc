"""Host helpers the port takes from the JAX package as they are (these
modules import no jax): the synthetic scenes with known planes and the
label-agreement metric."""

from buildingsegment_tpu.utils.quality import bij_agreement
from buildingsegment_tpu.utils.synthetic import make_building_cloud

__all__ = ["bij_agreement", "make_building_cloud"]
