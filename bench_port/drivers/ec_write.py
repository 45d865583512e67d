"""Client writes to an erasure-coded pool: `encode_batch` of a batch of
objects' stripes, one batch in flight.

A pool of `batches` distinct batches of `objects_per_batch` objects,
made on the card from the seed, is cycled.  The check holds the program
to the configuration's guarantee, a systematic MDS code of k data and m
parity chunks, without its coding matrix.  It reads the one linear code
that the first kept call's first stripe can come from
(`reference/gf.py` `infer_code`) and counts the stripe columns (a
stripe's bytes at one offset) of a seeded sample of the window's calls
and of its last `batches` calls that some loss of m chunks would not
give back: every column when that code is not MDS, else each column
with a byte off the code (a data byte unlike the input, a parity byte
unlike the code's product).
"""

from __future__ import annotations

import torch

from bench_port import ecdata
from bench_port.harness import Parts
from bench_port.keep import Kept
from bench_port.reference import gf


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
        ks = self.params["check_sample_ops"]
        self.kept = Kept(ks, self.nb, self.ctx.seed)
        with self.parts("warm"):
            ecdata.prewarm(lambda: self.prog.encode(self.data[0]),
                           ks + self.nb + 2)
        self.out = None

    def prepare(self, i: int) -> int:
        return i % self.nb

    def op(self, b: int, span) -> None:
        with span("bench.encode"):
            self.out = self.prog.encode(self.data[b])

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
        kept = list(self.kept.items())
        b0, out0 = kept[0][1]
        C = gf.infer_code(self.data[b0][0], out0[0, self.k:])
        mds = gf.unrecoverable_sets(C) == 0
        parity: dict = {}
        lost = 0
        for _, (b, out) in kept:
            if not mds:
                lost += self.n * self.su
                continue
            if b not in parity:
                parity[b] = gf.apply(C, self.data[b])
            lost += gf.off_columns(C, self.data[b], out, parity[b])
        return [("columns_unrecoverable", lost, 0)]

    def trace_info(self, first: int, last: int) -> dict:
        """The bytes the GF kernel must move in each traced call: the
        data read once, the parity written once."""
        one = self.n * (self.k + self.m) * self.su
        return {"gf_bytes": [one] * (last - first)}
