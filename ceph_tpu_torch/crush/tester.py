"""CrushTester — the batched test loop behind `crushtool --test`.

The port of `ceph_tpu/crush/tester.py`, semantics-compatible with the
reference's tester (reference src/crush/CrushTester.cc:477-730): per rule
× numrep × x, run the mapping, accumulate per-device utilization,
result-size histogram, bad mappings, and optional RNG-simulated placement
for comparison (random_placement, CrushTester.cc:260).  Output lines match
the reference's formatting.

The x-loop (1 `crush_do_rule` per PG in the reference) runs as one
`crush.mapper.map_rule` call per (rule, numrep) (`backend="torch"`, the
default; "jax" is taken as its alias): the rule kernel on the card, or its
plain version with `device="cpu"`.  When nothing per-row is printed, the
utilization and size histograms are reduced on the device
(`core/reduce.py`) and only those come back.  `--show-choose-tries` takes
its histogram from the rule kernel's diagnostics planes, reduced on the
device (`crush/explain.py::device_choose_tries`).  `backend="ref"` runs
the host oracle (`crush/mapper_ref.py`) seed by seed, and collects the
histogram there.  `backend="native"` maps each pass with the threaded C++
mapper (`native/mapper.py`) on the host; with `--show-choose-tries` it
goes through the host oracle, which collects the histogram.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

import numpy as np
import torch

from ceph_tpu_torch.core import reduce
from ceph_tpu_torch.core.rjenkins import crush_hash32_2
from ceph_tpu_torch.crush import explain, mapper_ref
from ceph_tpu_torch.crush.mapper import compile_rule, map_rule
from ceph_tpu_torch.crush.soa import build_arrays, to_device
from ceph_tpu_torch.crush.types import CrushMap, ITEM_NONE
from ceph_tpu_torch.device import resolve_device
from ceph_tpu_torch.native.mapper import NativeMapper

BACKENDS = {"torch": "torch", "jax": "torch", "native": "native",
            "ref": "ref"}


def _vec(out) -> str:
    """C++ operator<< for vector<int>: [a,b,c]."""
    return "[" + ",".join(str(int(o)) for o in out) + "]"


@dataclass
class TesterConfig:
    __test__ = False  # not a test class, despite the Test* name (pytest)

    min_x: int = 0
    max_x: int = 1023
    rule: int = -1  # -1 = all rules
    min_rep: int = -1
    max_rep: int = -1
    num_rep: int = -1
    pool_id: int = -1
    weights: dict[int, int] = field(default_factory=dict)  # osd -> 16.16
    backend: str = "torch"  # torch (jax: its alias) | ref
    device: str | None = None  # the torch backend's; None: the card
    simulate: bool = False
    show_mappings: bool = False
    show_bad_mappings: bool = False
    show_utilization: bool = False
    show_utilization_all: bool = False
    show_statistics: bool = False
    # per-placement retry histogram (reference src/crush/mapper.c:640-643
    # choose_tries bookkeeping + CrushTester's --show-choose-tries dump),
    # from the diagnostics planes (torch) or the host oracle (ref)
    show_choose_tries: bool = False


class CrushTester:
    def __init__(self, m: CrushMap, cfg: TesterConfig, out=None):
        if cfg.backend not in BACKENDS:
            raise ValueError(f"unknown backend {cfg.backend!r}: torch "
                             "(jax), native, or ref")
        self.m = m
        self.cfg = cfg
        self.out = out if out is not None else sys.stdout
        self.weight = [0x10000] * m.max_devices
        for osd, w in cfg.weights.items():
            if 0 <= osd < m.max_devices:
                self.weight[osd] = w
        self._tables = None
        self._native = None

    # -- mapping backends --------------------------------------------------
    @property
    def device(self) -> torch.device:
        return resolve_device(self.cfg.device)

    def _real_xs(self, xs: np.ndarray) -> np.ndarray:
        """pool-seed mix of the x range (CrushTester.cc:621)."""
        if self.cfg.pool_id == -1:
            return xs.astype(np.uint32)
        return crush_hash32_2(
            xs, self.cfg.pool_id & 0xFFFFFFFF).numpy().astype(np.uint32)

    def _real_xs_device(self) -> torch.Tensor:
        """The pass's seeds, mixed with the pool id, on the device."""
        xs = torch.arange(self.cfg.min_x, self.cfg.max_x + 1,
                          dtype=torch.long, device=self.device)
        if self.cfg.pool_id == -1:
            return xs & 0xFFFFFFFF
        return crush_hash32_2(xs, self.cfg.pool_id & 0xFFFFFFFF)

    @staticmethod
    def _rows_from_padded(padded: np.ndarray, rule) -> list[list[int]]:
        """firstn rules compact ITEM_NONE away; indep keep positions."""
        return [
            [o for o in row if o != ITEM_NONE]
            if rule.type == 1
            else list(row)
            for row in padded.tolist()
        ]

    def _rows_device(self, ruleno: int, nr: int) -> torch.Tensor:
        """The pass's padded rows, int32 [n_x, nr], on the device."""
        if self._tables is None:
            self._arrays = build_arrays(self.m)
            self._tables = to_device(self._arrays, self.device)
        prog = compile_rule(self._arrays, ruleno, nr)
        weight = torch.tensor(self.weight, dtype=torch.long,
                              device=self.device)
        return map_rule(self._tables, prog, self._real_xs_device(), weight)

    def _map_batch(self, ruleno: int, nr: int) -> np.ndarray:
        return self._rows_device(ruleno, nr).cpu().numpy()

    def _stats_batch(self, ruleno: int, nr: int, rule):
        """Per-device utilization + result-size histogram with the rows
        staying on the device (core/reduce.py): the tester fetches only
        the O(devices) summaries it prints, the device-resident form of
        the reference's host-side accumulation loop (reference
        src/crush/CrushTester.cc:637-698)."""
        rows = self._rows_device(ruleno, nr)
        per = reduce.osd_histogram(rows, self.m.max_devices,
                                   dtype=torch.int64).cpu().numpy()
        if rule.type == 1:
            # firstn compacts ITEM_NONE away: size = occupied lanes
            sh = reduce.size_histogram(rows, nr).cpu().numpy()
            sizes = {i: int(c) for i, c in enumerate(sh) if c}
        else:
            # indep keeps positions: every row reports the padded width
            sizes = {int(rows.shape[1]): int(rows.shape[0])}
        return per, sizes

    def _map_one_ref(self, ruleno: int, x: int, nr: int) -> list[int]:
        return mapper_ref.do_rule(
            self.m, ruleno, x, nr, self.weight,
            collect_choose_tries=self.cfg.show_choose_tries,
        )

    def _collect_tries_device(self, ruleno: int, nr: int) -> None:
        """Fold this (rule, numrep) pass's per-placement retry counts
        into the histogram from the diagnostics planes, reduced on the
        device (the host oracle's increments, lane for lane)."""
        if self._tables is None:
            self._arrays = build_arrays(self.m)
            self._tables = to_device(self._arrays, self.device)
        hist = self.m.choose_tries_histogram
        counts, _ = explain.device_choose_tries(
            self._arrays, ruleno, nr,
            self._real_xs(np.arange(self.cfg.min_x, self.cfg.max_x + 1,
                                    dtype=np.int64)),
            self.weight, len(hist), self.device)
        for i, v in enumerate(counts):
            hist[i] += int(v)

    def _random_placement(
        self, rng: np.random.Generator, nr: int
    ) -> list[int]:
        """Weighted sample without replacement (reference
        CrushTester.cc:260-292 random_placement)."""
        w = np.asarray(self.weight, np.float64)
        total = w.sum()
        out: list[int] = []
        if total <= 0:
            return out
        for _ in range(nr):
            p = w / w.sum() if w.sum() > 0 else None
            if p is None:
                break
            pick = int(rng.choice(len(w), p=p))
            out.append(pick)
            w = w.copy()
            w[pick] = 0
        return out

    @property
    def choose_tries(self) -> list[int] | None:
        """The collected histogram: choose_tries[f] = placements that
        needed f retries (index 0 = first-draw success)."""
        return self.m.choose_tries_histogram

    def dump_choose_tries(self, out=None) -> None:
        """Print the histogram, trailing zeros trimmed (the shape of the
        reference tester's --show-choose-tries output)."""
        out = out if out is not None else self.out
        hist = self.choose_tries or []
        last = max((i for i, v in enumerate(hist) if v), default=-1)
        print("choose_tries histogram", file=out)
        for i in range(last + 1):
            print(f" {i}: {hist[i]}", file=out)

    # -- the test loop -----------------------------------------------------
    def test(self) -> int:
        cfg, m = self.cfg, self.m
        backend = BACKENDS[cfg.backend]
        if cfg.show_choose_tries:
            m.choose_tries_histogram = [0] * (
                m.tunables.choose_total_tries + 1
            )
            if backend == "native":
                # only the diagnostics planes (torch) and the host oracle
                # (ref) collect the histogram; native goes through ref
                backend = "ref"
        rules = (
            [cfg.rule]
            if cfg.rule >= 0
            else [i for i, r in enumerate(m.rules) if r is not None]
        )
        w = self.out
        rng = np.random.default_rng(0)
        for r in rules:
            rule = m.rules[r] if r < len(m.rules) else None
            if rule is None:
                print(f"rule {r} dne", file=w)
                continue
            rname = m.rule_names.get(r, f"rule{r}")
            if cfg.num_rep >= 0:
                minr = maxr = cfg.num_rep
            elif cfg.min_rep >= 0 and cfg.max_rep >= 0:
                minr, maxr = cfg.min_rep, cfg.max_rep
            else:
                minr, maxr = rule.min_size, rule.max_size
            if cfg.show_statistics:
                print(
                    f"rule {r} ({rname}), x = {cfg.min_x}..{cfg.max_x}, "
                    f"numrep = {minr}..{maxr}",
                    file=w,
                )
            n_x = cfg.max_x - cfg.min_x + 1
            for nr in range(minr, maxr + 1):
                per = np.zeros(m.max_devices, np.int64)
                sizes: dict[int, int] = {}
                xs = np.arange(cfg.min_x, cfg.max_x + 1, dtype=np.int64)
                if (cfg.show_choose_tries and backend == "torch"
                        and not cfg.simulate):
                    self._collect_tries_device(r, nr)
                if cfg.simulate:
                    rows = [
                        self._random_placement(rng, nr) for _ in range(n_x)
                    ]
                    prefix = "RNG"
                elif backend == "native":
                    if self._native is None:
                        self._native = NativeMapper(m)
                    padded = self._native.map_batch(
                        r, self._real_xs(xs), nr, self.weight)
                    rows = self._rows_from_padded(padded, rule)
                    prefix = "CRUSH"
                elif backend == "ref":
                    rows = [
                        self._map_one_ref(r, int(rx), nr)
                        for rx in self._real_xs(xs)
                    ]
                    prefix = "CRUSH"
                elif not (cfg.show_mappings or cfg.show_bad_mappings):
                    # nothing per-row to print: reduce on device, fetch
                    # only the O(devices) summaries
                    per_d, sizes_d = self._stats_batch(r, nr, rule)
                    per += per_d
                    for sz, cn in sizes_d.items():
                        sizes[sz] = sizes.get(sz, 0) + cn
                    rows = None
                else:
                    padded = self._map_batch(r, nr)
                    rows = self._rows_from_padded(padded, rule)
                    prefix = "CRUSH"
                for x, out_row in zip(xs, rows or ()):
                    if cfg.show_mappings:
                        print(
                            f"{prefix} rule {r} x {x} {_vec(out_row)}",
                            file=w,
                        )
                    has_none = False
                    realsize = 0
                    for o in out_row:
                        if o != ITEM_NONE:
                            per[o] += 1
                            realsize += 1
                        else:
                            has_none = True
                    sizes[len(out_row)] = sizes.get(len(out_row), 0) + 1
                    if cfg.show_bad_mappings and (
                        len(out_row) != nr or has_none
                    ):
                        print(
                            f"bad mapping rule {r} x {x} num_rep {nr} "
                            f"result {_vec(out_row)}",
                            file=w,
                        )
                total_w = sum(self.weight)
                expected = (
                    np.asarray(self.weight, np.float64)
                    / max(total_w, 1)
                    * n_x
                    * nr
                )
                if cfg.show_utilization and not cfg.show_statistics:
                    for i in range(m.max_devices):
                        print(f"  device {i}:\t{per[i]}", file=w)
                if cfg.show_statistics:
                    for sz in sorted(sizes):
                        print(
                            f"rule {r} ({rname}) num_rep {nr} "
                            f"result size == {sz}:\t{sizes[sz]}/{n_x}",
                            file=w,
                        )
                    if cfg.show_utilization or cfg.show_utilization_all:
                        for i in range(m.max_devices):
                            if cfg.show_utilization_all or (
                                expected[i] > 0 and per[i] > 0
                            ):
                                print(
                                    f"  device {i}:\t\t stored : {per[i]}"
                                    f"\t expected : {expected[i]:.0f}",
                                    file=w,
                                )
        if cfg.show_choose_tries:
            self.dump_choose_tries()
        return 0
