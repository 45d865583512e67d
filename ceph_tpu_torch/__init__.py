"""ceph_tpu_torch — the PyTorch/CUDA port of `ceph_tpu`, for NVIDIA Hopper.

The package mirrors `ceph_tpu`'s layout module by module (`ec/gf.py` ↔
`ceph_tpu/ec/gf.py`, and so on) and is held byte-exact against it by the
`tests/test_torch_*.py` files.  It imports `torch` and numpy only: never
jax, and nothing of `ceph_tpu` (it keeps its own copies of the host
modules it needs).

Ported so far: Reed–Solomon erasure coding (`ceph_tpu_torch.ec`), whose
GF(2^8) matrix product is a CUDA kernel written for `sm_90a`
(`ec/csrc/gf_matmul.cu`), and its benchmark CLI
(`ceph_tpu_torch.cli.ec_benchmark`); CRUSH placement for straw2 maps
(`ceph_tpu_torch.core`, `.crush`, `.osd`: the PG→OSD pipeline and
`osd.pipeline.PoolMapper`), whose whole pipeline is a CUDA kernel
(`osd/csrc/pipeline.cu`) around the rule interpreter's body, itself also
a kernel (`crush/csrc/crush_rule.cu`).  `ceph_tpu_torch.build` builds
the kernels.

Entry points run on the card unless the caller asks for the CPU
(`device="cpu"`); see `ceph_tpu_torch.device.resolve_device`.

Importing the package imports no torch: the preflight probe's child
(`python -m ceph_tpu_torch.runtime.preflight --child cuda`) fires its
fault point before torch loads.  `resolve_device` loads on first use.
"""

__all__ = ["resolve_device"]


def __getattr__(name):
    if name == "resolve_device":
        from ceph_tpu_torch.device import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
