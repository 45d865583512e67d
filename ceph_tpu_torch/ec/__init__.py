from ceph_tpu_torch.ec.interface import ErasureCode, ErasureCodeProfileError
from ceph_tpu_torch.ec.registry import create_erasure_code

__all__ = [
    "ErasureCode",
    "ErasureCodeProfileError",
    "create_erasure_code",
]
