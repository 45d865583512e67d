"""Reductions over mapping rows, on the rows' device.

The port of `ceph_tpu/core/reduce.py`.  The reference tools fold per-PG
mappings into small per-OSD summaries on the host as they loop
(CrushTester's utilization histogram, reference
src/crush/CrushTester.cc:637-698; osdmaptool's pgs/primary counts,
src/tools/osdmaptool.cc:696-754).  The rows come off the rule kernel on
the card, so these reductions run there too, and a caller fetches only
the O(OSDs) or O(1) results.

Every count is exact integer maths: `bincount` (int64) over the valid
lanes, with invalid lanes routed to one extra bin that is cut off;
`weighted_osd_histogram` sums integer-valued float64 weights, exact below
2^53.  `rows` is any integer tensor of OSD ids where ITEM_NONE or a
negative value marks an empty lane.  `dtype` is the counts' dtype.
"""

from __future__ import annotations

import torch

from ceph_tpu_torch.crush.types import ITEM_NONE


def valid_lanes(rows: torch.Tensor) -> torch.Tensor:
    """Occupied lanes: not NONE, a real non-negative OSD id."""
    return (rows != ITEM_NONE) & (rows >= 0)


def _bins(ids: torch.Tensor, n: int, valid: torch.Tensor) -> torch.Tensor:
    """ids where valid, else the overflow bin n; flat int64."""
    return torch.where(valid, ids.long().clamp(0, max(n - 1, 0)),
                       n).reshape(-1)


def osd_histogram(ids: torch.Tensor, n: int, extra_mask=None,
                  dtype=torch.int32) -> torch.Tensor:
    """Per-OSD counts; invalid lanes (ITEM_NONE pads, -1 no-primary
    markers, out-of-range ids) fall off the end."""
    valid = valid_lanes(ids) & (ids < n)
    if extra_mask is not None:
        valid = valid & extra_mask
    return torch.bincount(_bins(ids, n, valid),
                          minlength=n + 1)[:n].to(dtype)


def weighted_osd_histogram(rows: torch.Tensor, row_weight, n: int,
                           extra_mask=None) -> torch.Tensor:
    """Per-OSD sums of a per-row weight: rows [N, W] of OSD ids,
    row_weight [N] broadcast across the W replica lanes, float64."""
    valid = valid_lanes(rows) & (rows < n)
    if extra_mask is not None:
        valid = valid & extra_mask
    w = torch.as_tensor(row_weight, dtype=torch.float64,
                        device=rows.device)[:, None].expand(rows.shape)
    w = torch.where(valid, w, 0.0)
    return torch.zeros(n + 1, dtype=torch.float64,
                       device=rows.device).index_add_(
        0, _bins(rows, n, valid), w.reshape(-1))[:n]


def result_sizes(rows: torch.Tensor, extra_mask=None) -> torch.Tensor:
    """Per-row count of occupied lanes (the tester's `result size`)."""
    valid = valid_lanes(rows)
    if extra_mask is not None:
        valid = valid & extra_mask
    return valid.sum(-1)


def size_histogram(rows: torch.Tensor, max_size: int, extra_mask=None,
                   dtype=torch.int64) -> torch.Tensor:
    """Histogram of result_sizes over [0, max_size]."""
    sz = result_sizes(rows, extra_mask).long().clamp(0, max_size)
    return torch.bincount(sz.reshape(-1), minlength=max_size + 1).to(dtype)


def value_histogram(vals: torch.Tensor, max_value: int, extra_mask=None,
                    dtype=torch.int64) -> torch.Tensor:
    """Histogram of small non-negative integer values over
    [0, max_value]; negative values and values above max_value are
    dropped, not clamped (the reference histogram only counts
    `ftotal <= len - 1`, mapper_ref.do_rule)."""
    valid = (vals >= 0) & (vals <= max_value)
    if extra_mask is not None:
        valid = valid & extra_mask
    return torch.bincount(_bins(vals, max_value + 1, valid),
                          minlength=max_value + 2)[:max_value + 1].to(dtype)


def duplicate_rows(rows: torch.Tensor) -> torch.Tensor:
    """Per-row flag: the row carries the same OSD in two occupied lanes.
    [..., N, W] -> bool [..., N]."""
    valid = valid_lanes(rows)
    eq = ((rows[..., :, None] == rows[..., None, :])
          & valid[..., :, None] & valid[..., None, :])
    w = rows.shape[-1]
    upper = torch.ones((w, w), dtype=torch.bool,
                       device=rows.device).triu(1)
    return (eq & upper).flatten(-2).any(-1)


def moved_in_lanes(before: torch.Tensor,
                   after: torch.Tensor) -> torch.Tensor:
    """Per-lane flag: occupied `after` lanes whose OSD is not a member of
    the same row in `before`.  [..., N, W] x [..., N, W] -> bool
    [..., N, W]."""
    member = (after[..., :, None] == before[..., None, :]).any(-1)
    return ~member & valid_lanes(after)


def changed_rows(before: torch.Tensor, after: torch.Tensor) -> torch.Tensor:
    """Per-row flag: the row's occupied-OSD multiset changed (primary
    reordering alone does not count).  [..., N, W] x [..., N, W] -> bool
    [..., N]."""
    return (moved_in_lanes(before, after).any(-1)
            | moved_in_lanes(after, before).any(-1))


def misplaced_lanes(before: torch.Tensor, after: torch.Tensor,
                    extra_mask=None) -> torch.Tensor:
    """Count of occupied `after` lanes whose OSD is not a member of the
    same row in `before` (the replica-slot form of the reference's
    calc_misplaced_from).  -> int64 scalar on the rows' device."""
    moved = moved_in_lanes(before, after)
    if extra_mask is not None:
        moved = moved & extra_mask
    return moved.sum(dtype=torch.int64)
