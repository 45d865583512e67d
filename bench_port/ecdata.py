"""The erasure-coded cells' batches: objects cut into stripes, made on the
device from the seed."""

from __future__ import annotations

import torch


class PortCodec:
    """The port: the profile's erasure code on the device engine."""

    def __init__(self, cfg: dict, device):
        from bench_port import system

        self.code = system.erasure_code(cfg, device)

    def encode(self, data: torch.Tensor) -> torch.Tensor:
        return self.code.encode_batch(data)

    def decode(self, want: set, chunks: dict, length: int) -> dict:
        return self.code.decode_batch(want, chunks, length)


def geometry(cfg: dict, params: dict) -> tuple[int, int, int, int]:
    """(batches, stripes a batch, k, chunk bytes): an object of
    object_bytes is object_bytes / (k * stripe_unit) stripes of k chunks
    of stripe_unit bytes; a batch is objects_per_batch objects."""
    k = int(cfg["ec_profile"]["k"])
    su = int(cfg["stripe_unit"])
    per_object = cfg["object_bytes"] // (k * su)
    if per_object * k * su != cfg["object_bytes"]:
        raise ValueError("object_bytes is not a whole number of stripes")
    return params["batches"], params["objects_per_batch"] * per_object, k, su


def batches(cfg: dict, params: dict, seed: int, device) -> torch.Tensor:
    """u8 [batches, N, k, L], one generator call on the device."""
    b, n, k, su = geometry(cfg, params)
    gen = torch.Generator(device=device).manual_seed(seed & (2**63 - 1))
    return torch.randint(0, 256, (b, n, k, su), generator=gen,
                         dtype=torch.uint8, device=device)


def prewarm(fn, count: int) -> None:
    """Run fn count times holding every result, then drop them: the
    allocator then holds blocks for as many outputs as the check keeps
    alive in the window, and the window allocates nothing new."""
    held = [fn() for _ in range(count)]
    del held
