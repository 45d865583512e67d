"""Where the port's entry points run.

The role of `ceph_tpu/utils/platform.py` at the entry point: a device
left to the default is acquired through the backend ladder
(`utils.platform.ensure_backend`, once per process, recorded in
`runtime.last_provenance()`).  The default ladder is the card alone, so
a missing card is an error, never a silent move to the host; a lower
rung runs only when `CEPH_TPU_LADDER` names it, and then the descent is
recorded and warned about.  `device="cpu"` is the caller's way to ask
for the host.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` -> the backend the ladder acquires (`cuda` by default);
    anything else as `torch.device` reads it.  A CUDA device comes back
    with its index (`cuda` -> `cuda:<current>`), as the tensors on it
    report their device.

    Raises RuntimeError (`runtime.RequiredBackendError` for the default)
    when CUDA is asked for or defaulted to and the process has no CUDA
    device: pass `device="cpu"` to run the plain PyTorch versions of the
    kernels on the host.
    """
    if device is None:
        from ceph_tpu_torch.utils.platform import ensure_backend

        dev = torch.device("cuda" if ensure_backend() == "cuda" else "cpu")
    else:
        dev = torch.device(device)
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
