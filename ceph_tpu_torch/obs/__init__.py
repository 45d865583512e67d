"""Observability: the placement-decision records (`placement.py`), the
cluster health checks (`health.py`), the time-series recorder
(`timeline.py`) and the latency quantiles (`quantiles.py`)."""

from ceph_tpu_torch.obs import health, placement, quantiles, timeline

__all__ = ["health", "placement", "quantiles", "timeline"]
