"""ceph_tpu_torch — the PyTorch/CUDA port of `ceph_tpu`, for NVIDIA Hopper.

The package mirrors `ceph_tpu`'s layout module by module (`ec/gf.py` ↔
`ceph_tpu/ec/gf.py`, and so on) and is held byte-exact against it by the
`tests/test_torch_*.py` files.  It imports `torch` and numpy only: never
jax, and nothing of `ceph_tpu` (it keeps its own copies of the host
modules it needs).

Ported so far: Reed–Solomon erasure coding (`ceph_tpu_torch.ec`), whose
GF(2^8) matrix product is a CUDA kernel written for `sm_90a`
(`ec/csrc/gf_matmul.cu`), and its benchmark CLI
(`ceph_tpu_torch.cli.ec_benchmark`).

Entry points run on the card unless the caller asks for the CPU
(`device="cpu"`); see `ceph_tpu_torch.device.resolve_device`.
"""

from ceph_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
