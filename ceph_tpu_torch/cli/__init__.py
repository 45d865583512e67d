"""Command-line tools of the port (`python -m ceph_tpu_torch.cli.<tool>`)."""
