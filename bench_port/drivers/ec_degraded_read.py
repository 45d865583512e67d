"""Degraded reads from an erasure-coded pool: `decode_batch` of a batch
whose stripes each lost the same two chunks, one batch in flight.

Each of the `batches` batches has its own pair of lost chunks, drawn from
the seed: `two_data_lost` of them lose two data chunks, the rest one
data chunk and one parity chunk, so every seed decodes the same amount.
The program encodes the batches in set-up; each surviving chunk is a
buffer of its own, as it comes from its OSD.  The call asks for every
data chunk.  The check holds the rebuilt chunks of a seeded sample of the
window's calls and of its last `batches` calls to the data the benchmark
made, and counts the bytes that differ: the guarantee is that any k
chunks give back the data, whatever the coding matrix.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from bench_port import ecdata
from bench_port.harness import Parts
from bench_port.keep import Kept


def lost_pairs(k: int, m: int, batches: int, two_data: int,
               seed: int) -> list[tuple[int, int]]:
    rng = np.random.default_rng([seed, 0x6C6F7374])
    dd = list(itertools.combinations(range(k), 2))
    dp = [(d, p) for d in range(k) for p in range(k, k + m)]
    pick_dd = [dd[i] for i in rng.choice(len(dd), two_data, replace=False)]
    pick_dp = [dp[i] for i in rng.choice(len(dp), batches - two_data,
                                         replace=False)]
    pairs = pick_dd + pick_dp
    return [pairs[i] for i in rng.permutation(len(pairs))]


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg = ctx.config
        self.params = ctx.cell.traffic["params"]
        self.device = torch.device(ctx.device)
        self.nb, self.n, self.k, self.su = ecdata.geometry(self.cfg,
                                                          self.params)
        self.m = int(self.cfg["ec_profile"]["m"])
        self.parts = Parts()

    def setup(self) -> None:
        with self.parts("code"):
            self.prog = (self.ctx.program(self.cfg, self.device)
                         if self.ctx.program else
                         ecdata.PortCodec(self.cfg, self.device))
        with self.parts("data"):
            self.data = ecdata.batches(self.cfg, self.params,
                                       self.ctx.seed, self.device)
        self.lost = lost_pairs(self.k, self.m, self.nb,
                               self.params["two_data_lost"], self.ctx.seed)
        # the program's own encode, once a batch; each survivor a buffer
        self.chunks = []
        with self.parts("encode"):
            for b in range(self.nb):
                enc = self.prog.encode(self.data[b])
                self.chunks.append({i: enc[:, i].contiguous()
                                    for i in range(self.k + self.m)
                                    if i not in self.lost[b]})
                del enc
        self.want = set(range(self.k))
        self.missing = [sorted(self.want & set(p)) for p in self.lost]
        ks = self.params["check_sample_ops"]
        self.kept = Kept(ks, self.nb, self.ctx.seed)
        with self.parts("warm"):
            for b in range(self.nb):  # every batch's erasure pattern
                self.prog.decode(self.want, self.chunks[b], self.su)
            ecdata.prewarm(lambda: self.prog.decode(
                self.want, self.chunks[0], self.su), ks + self.nb + 2)
        self.out = None

    def prepare(self, i: int) -> int:
        return i % self.nb

    def op(self, b: int, span) -> None:
        with span("bench.decode"):
            out = self.prog.decode(self.want, self.chunks[b], self.su)
            self.out = {i: out[i] for i in self.missing[b]}

    def after(self, i: int, b: int) -> None:
        self.kept.add(i, (b, self.out))
        self.out = None

    def units(self, b: int) -> int:
        return self.n * self.k * self.su

    def end_to_end(self, w) -> dict:
        from bench_port.harness import p95

        return {"ec_gbps": w.units / w.seconds / 1e9,
                "op_p95_ms": p95(w.latency_ms)}

    def release(self) -> None:
        self.prog = None

    def check(self) -> list:
        bad = 0
        for _, (b, out) in self.kept.items():
            for i in self.missing[b]:
                bad += int((out[i] != self.data[b][:, i]).sum())
        return [("chunk_bytes_mismatched", bad, 0)]

    def trace_info(self, first: int, last: int) -> dict:
        """The bytes the GF kernel must move in each traced call: the k
        survivors it reads once, the chunks it rebuilds written once."""
        return {"gf_bytes": [
            self.n * (self.k + len(self.missing[i % self.nb])) * self.su
            for i in range(first, last)]}
