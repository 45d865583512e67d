"""Observability: the placement-decision records (`placement.py`), the
cluster health checks (`health.py`) and the time-series recorder
(`timeline.py`)."""

from ceph_tpu_torch.obs import health, placement, timeline

__all__ = ["health", "placement", "timeline"]
