"""Where the port's entry points run.

The role of `ceph_tpu/utils/platform.py` (pick the backend once, at the
entry point), without its fallback ladder: the port runs on the card
unless the caller asks for the CPU, and a missing card is an error, never
a silent move to the host.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` -> `cuda`; anything else as `torch.device` reads it.  A
    CUDA device comes back with its index (`cuda` -> `cuda:<current>`),
    as the tensors on it report their device.

    Raises RuntimeError when CUDA is asked for (or defaulted to) and the
    process has no CUDA device: pass `device="cpu"` to run the plain
    PyTorch versions of the kernels on the host.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card by default; "
                "pass device='cpu' (CLI: --device cpu) to run on the host"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
