"""The native threaded CRUSH mapper over the port's CrushMap.

Port of `ceph_tpu/native/mapper.py`.  `NativeMapper` mirrors a map into
the C++ engine (`native/crush.cpp`) and maps batches of seeds across
threads, with the semantics of `crush/mapper_ref.py::do_rule`.  It is the
host backend of `crushtool --backend native` and the multicore CPU
baseline that BASELINE.md's target is stated against (`n_threads=1`: one
core).
"""

from __future__ import annotations

import ctypes

import numpy as np

from ceph_tpu_torch.crush.types import CrushMap, ITEM_NONE
from ceph_tpu_torch.native import load_crush

_IP = ctypes.POINTER(ctypes.c_int)
_UP = ctypes.POINTER(ctypes.c_uint)


def _ints(vals):
    """A C int array of `vals`, or NULL for None (the caller keeps the
    array alive across the call that reads it)."""
    if vals is None:
        return None
    return ctypes.cast((ctypes.c_int * len(vals))(*[int(v) for v in vals]),
                       _IP)


def available() -> bool:
    """Whether the native mapper builds and loads here (crush.cpp, built
    by $CXX at first use), as the JAX package's `available` answers: a
    failed build is False.  It is a question for the caller; NativeMapper
    itself raises with the compiler's stderr."""
    try:
        load_crush()
    except RuntimeError:
        return False
    return True


class NativeMapper:
    """Mirror a CrushMap into the C++ engine; map batches across threads.

    `choose_args` (one ChooseArgs set) overrides bucket weights per
    position; its rows must have exactly the bucket's size."""

    def __init__(self, m: CrushMap, choose_args=None):
        lib = load_crush()
        self.lib = lib
        t = m.tunables
        self.h = lib.cm_create(
            t.choose_local_tries, t.choose_local_fallback_tries,
            t.choose_total_tries, t.chooseleaf_descend_once,
            t.chooseleaf_vary_r, t.chooseleaf_stable,
        )
        self.rules = {i for i, r in enumerate(m.rules) if r is not None}
        for bid in sorted(m.buckets, reverse=True):
            b = m.buckets[bid]
            nodes = b.node_weights
            lib.cm_add_bucket(
                self.h, bid, int(b.alg), b.type, b.size,
                _ints(b.items), _ints(b.weights), _ints(b.sum_weights),
                _ints(nodes), len(nodes) if nodes else 0, _ints(b.straws),
            )
        for ruleno in sorted(self.rules):
            r = m.rules[ruleno]
            lib.cm_add_rule(
                self.h, ruleno, r.ruleset, r.type, r.min_size, r.max_size,
                len(r.steps), _ints([op for op, _, _ in r.steps]),
                _ints([a for _, a, _ in r.steps]),
                _ints([a for _, _, a in r.steps]),
            )
        lib.cm_set_max_devices(self.h, m.max_devices)
        self.has_choose_args = False
        if choose_args is not None:
            for bid, ws in choose_args.weight_sets.items():
                b = m.buckets.get(bid)
                if b is None or not ws:
                    continue
                ids = choose_args.ids.get(bid)
                # the C side slices flat buffers at bucket-size strides:
                # reject mismatched rows instead of feeding it garbage
                if any(len(row) != b.size for row in ws) or (
                    ids is not None and len(ids) != b.size
                ):
                    raise ValueError(
                        f"choose_args for bucket {bid}: weight rows/ids "
                        f"must have exactly {b.size} entries"
                    )
                flat = [int(w) for row in ws for w in row]
                wa = ctypes.cast((ctypes.c_uint * len(flat))(*flat), _UP)
                lib.cm_set_choose_args(self.h, bid, len(ws), wa,
                                       _ints(ids) if ids else None, b.size)
                self.has_choose_args = True

    def map_batch(self, ruleno: int, xs: np.ndarray, result_max: int,
                  weights, n_threads: int = 0) -> np.ndarray:
        """-> int32[n, result_max], ITEM_NONE padded.  `n_threads` 0
        takes every core the host reports (at most 64), 1 maps on the
        calling thread alone."""
        if ruleno not in self.rules:
            raise ValueError(f"rule {ruleno} is not in the map")
        if result_max < 1:
            raise ValueError(f"result_max {result_max} < 1")
        xs = np.ascontiguousarray(xs, dtype=np.uint32)
        w = np.ascontiguousarray(weights, dtype=np.uint32)
        out = np.full((len(xs), result_max), ITEM_NONE, np.int32)
        self.lib.cm_map_batch(
            self.h, ruleno, xs.ctypes.data_as(_UP), len(xs), result_max,
            w.ctypes.data_as(_UP), len(w), out.ctypes.data_as(_IP),
            n_threads, 1 if self.has_choose_args else 0,
        )
        return out

    def __del__(self):
        h = getattr(self, "h", None)
        if h is not None:
            self.lib.cm_destroy(h)
            self.h = None
