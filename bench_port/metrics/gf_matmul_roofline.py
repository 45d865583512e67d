"""gf_matmul_roofline: the GF(2^8) kernel's share of its roofline, %.

Each traced call's least time is the bytes the product must move (each
input chunk read once, each output chunk written once; the driver's
`gf_bytes`) over the card's HBM bandwidth (`peaks.py`); its table
lookups are not counted, so this is a floor of the least time.  The
share is the least times' sum over the launches' device time; each call
is one launch."""

import torch

from bench_port import peaks


def read(r):
    nbytes = r.info.get("gf_bytes")
    n = r.launches("gf_matmul_kernel")
    if not nbytes or n != len(nbytes):
        return None
    card = peaks.card(torch.cuda.get_device_name(0))
    if card is None:
        return None
    bound = sum(nbytes) / card["hbm_bytes_per_s"]
    return 100.0 * bound / r.device_seconds("gf_matmul_kernel")
