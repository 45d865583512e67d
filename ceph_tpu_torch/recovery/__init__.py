"""Recovery data plane: the device-resident backlog/contention queue
(`queue.py`) the lifetime simulator steps each epoch."""

from ceph_tpu_torch.recovery.queue import (
    DRAIN_KEYS,
    RecoveryQueue,
    drain_pool_np,
    drain_pool_torch,
    stream_bytes_per_epoch,
)

__all__ = [
    "DRAIN_KEYS",
    "RecoveryQueue",
    "drain_pool_np",
    "drain_pool_torch",
    "stream_bytes_per_epoch",
]
