from ceph_tpu_torch.balancer.upmap import calc_pg_upmaps

__all__ = ["calc_pg_upmaps"]
