from buildingsegment_tpu_torch.io.ply import HostPointCloud, read_ply, write_ply

__all__ = ["HostPointCloud", "read_ply", "write_ply"]
