"""Host utilities of the port (copies of `ceph_tpu/utils` modules)."""
from ceph_tpu_torch.utils.platform import ensure_backend

__all__ = ["ensure_backend"]
