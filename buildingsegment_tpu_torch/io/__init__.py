from buildingsegment_tpu_torch.io.ply import HostPointCloud, read_ply, write_ply
from buildingsegment_tpu_torch.io.png import encode_png, read_png, write_png
from buildingsegment_tpu_torch.io.obj import prism_obj_text, write_prism_obj

__all__ = [
    "HostPointCloud", "read_ply", "write_ply",
    "encode_png", "read_png", "write_png",
    "prism_obj_text", "write_prism_obj",
]
