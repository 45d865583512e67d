"""Host utilities of the port (copies of `ceph_tpu/utils` modules)."""
