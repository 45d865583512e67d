"""pipeline_roofline: the pipeline kernel's share of its roofline, %.

Each traced epoch's least time is the larger of its operations over the
card's issue rate and its bytes over the HBM bandwidth (`peaks.py`).  The
operations are the straw2 draws of its map state (counted by the
benchmark's plain reference over every PG) times the operations of a
draw, plus a seed hash a PG; the bytes are its `up` rows written once
and the four per-OSD vectors read once (the map's tables, a few hundred
KB, are left out).  The share is the least times' sum over the launches'
device time; each epoch is one launch."""

import torch

from bench_port import peaks


def read(r):
    draws = r.info.get("draws")
    n = r.launches("pipeline_kernel")
    if not draws or n != len(draws):
        return None
    name = torch.cuda.get_device_name(0)
    rate, card = peaks.issue_rate(name), peaks.card(name)
    if rate is None or card is None:
        return None
    ops_s = sum(peaks.pipeline_ops(d, r.info["pgs"]) for d in draws) / rate
    bytes_s = len(draws) * r.info["bytes"] / card["hbm_bytes_per_s"]
    return 100.0 * max(ops_s, bytes_s) / r.device_seconds("pipeline_kernel")
