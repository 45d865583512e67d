"""osdmaptool — create/inspect/test osdmaps, the PG loop on the card.

The port of `ceph_tpu/cli/osdmaptool.py`: the reference tool's flags,
messages, exit codes and output formats (reference
src/tools/osdmaptool.cc), plus `--device cuda|cpu`.

    osdmaptool mapfile --createsimple N [--pg-bits B] [--pgp-bits B]
                        [--with-default-pool] [--clobber]
    osdmaptool mapfile --create-from-conf -c ceph.conf
    osdmaptool mapfile --print | --dump FMT | --tree[=plain|json-pretty]
    osdmaptool mapfile --test-map-pgs[-dump[-all]] [--pool P]
    osdmaptool mapfile --test-map-pg <pgid> / --test-map-object <name>
    osdmaptool mapfile --mark-up-in / --mark-out N / --mark-up N
    osdmaptool mapfile --adjust-crush-weight osd:weight[,..] [--save]
    osdmaptool mapfile --export-crush f / --import-crush f
    osdmaptool mapfile --upmap out [--upmap-deviation D] [--upmap-max N]
                        [--upmap-pool name] [--save]
    osdmaptool mapfile --upmap-cleanup [f]
    osdmaptool mapfile --apply-incremental incfile   (extension: applies
                        binary OSDMap::Incremental epoch deltas in order)

Map files are the reference binary wire format (JSON also read, see
ceph_tpu_torch.osd.io).  `--test-map-pgs` maps each pool with one
`PoolMapper` call (the rule kernel on the card, its plain version with
`--device cpu`; the ParallelPGMapper analogue, reference loop
src/tools/osdmaptool.cc:630-755) and reduces the rows on the device to
the per-OSD counts and the size histogram; `--backend ref` maps PG by PG
with the host oracle, as `--test-map-pg` and `--test-map-object` do.
`--upmap` runs the balancer (`balancer.calc_pg_upmaps`, its "sets"
backend with the PGs mapped through `PoolMapper`, or through the host
pipeline with `--backend ref`).  `--health` is not yet ported: it exits
1 and says so.

    python -m ceph_tpu_torch.cli.osdmaptool om --test-map-pgs --device cpu
"""

from __future__ import annotations

import json
import math
import os
import sys
import time

import numpy as np
import torch

from ceph_tpu_torch.core import reduce
from ceph_tpu_torch.crush.types import ITEM_NONE
from ceph_tpu_torch.osd.osdmap import OSDMap, build_simple
from ceph_tpu_torch.osd.pipeline import PoolMapper, first_not_none
from ceph_tpu_torch.osd.types import PgId

ME = "osdmaptool"

USAGE = """ usage: [--print] <mapfilename>
   --create-from-conf      creates an osd map with default configurations
   --createsimple <numosd> [--clobber] [--pg-bits <bitsperosd>] [--pgp-bits <bits>] creates a relatively generic OSD map with <numosd> devices
   --pgp-bits <bits>       pgp_num map attribute will be shifted by <bits>
   --pg-bits <bits>        pg_num map attribute will be shifted by <bits>
   --clobber               allows osdmaptool to overwrite <mapfilename> if it already exists
   --export-crush <file>   write osdmap's crush map to <file>
   --import-crush <file>   replace osdmap's crush map with <file>
   --health                dump health checks
   --test-map-pgs [--pool <poolid>] [--pg_num <pg_num>] [--range-first <first> --range-last <last>] map all pgs
   --test-map-pgs-dump [--pool <poolid>] [--range-first <first> --range-last <last>] map all pgs
   --test-map-pgs-dump-all [--pool <poolid>] [--range-first <first> --range-last <last>] map all pgs to osds
   --mark-up-in            mark osds up and in (but do not persist)
   --mark-out <osdid>      mark an osd as out (but do not persist)
   --mark-up <osdid>       mark an osd as up (but do not persist)
   --mark-in <osdid>       mark an osd as in (but do not persist)
   --with-default-pool     include default pool when creating map
   --clear-temp            clear pg_temp and primary_temp
   --clean-temps           clean pg_temps
   --test-random           do random placements
   --test-map-pg <pgid>    map a pgid to osds
   --test-map-object <objectname> [--pool <poolid>] map an object to osds
   --upmap-cleanup <file>  clean up pg_upmap[_items] entries, writing
                           commands to <file> [default: - for stdout]
   --upmap <file>          calculate pg upmap entries to balance pg layout
                           writing commands to <file> [default: - for stdout]
   --upmap-max <max-count> set max upmap entries to calculate [default: 10]
   --upmap-deviation <max-deviation>
                           max deviation from target [default: 5]
   --upmap-pool <poolname> restrict upmap balancing to 1 or more pools
   --upmap-active          Act like an active balancer, keep applying changes until balanced
   --dump <format>         displays the map in plain text when <format> is 'plain', 'json' if specified format is not supported
   --tree                  displays a tree of the map
   --test-crush [--range-first <first> --range-last <last>] map pgs to acting osds
   --adjust-crush-weight <osdid:weight>[,<osdid:weight>,<...>] change <osdid> CRUSH <weight> (but do not persist)
   --save                  write modified osdmap with upmap or crush-adjust changes
"""


def _vec(v) -> str:
    return "[" + ",".join(str(int(o)) for o in v) + "]"


def _g(v: float) -> str:
    return f"{v:g}"


def _crush_weightf_map(m: OSDMap) -> dict[int, float]:
    """One pass over the (non-shadow) buckets: device -> crush weight."""
    shadows = {
        sid
        for per in m.crush.class_bucket.values()
        for sid in per.values()
    }
    out: dict[int, float] = {}
    for bid, b in m.crush.buckets.items():
        if bid in shadows:
            continue
        for it, w in zip(b.items, b.weights):
            if it >= 0 and it not in out:
                out[it] = w / 0x10000
    return out


def _map_pool(m: OSDMap, pool_id: int, backend: str, device=None):
    """-> (acting[N,W], acting_primary[N], up[N,W], up_primary[N]) int32
    tensors: on the device for the torch backend, on the host for ref."""
    pool = m.pools[pool_id]
    if backend != "ref":
        up, upp, acting, actp = PoolMapper(m, pool_id,
                                           device).map_all_tensors()
        return acting, actp, up, upp
    n = pool.pg_num
    W = pool.size
    up = np.full((n, W), ITEM_NONE, np.int32)
    upp = np.full(n, -1, np.int32)
    acting = np.full((n, W), ITEM_NONE, np.int32)
    actp = np.full(n, -1, np.int32)
    for ps in range(n):
        u, up_pr, a, a_pr = m.pg_to_up_acting_osds(PgId(pool_id, ps))
        up[ps, : len(u)] = u
        acting[ps, : len(a)] = a
        upp[ps] = up_pr
        actp[ps] = a_pr
    return tuple(torch.from_numpy(v) for v in (acting, actp, up, upp))


def test_map_pgs(
    m: OSDMap,
    only_pool: int = -1,
    dump: str | None = None,
    backend: str = "torch",
    out=None,
    device=None,
) -> None:
    """reference src/tools/osdmaptool.cc:630-755 output format.  The
    count, first and primary columns and the size histogram are reduced
    where the rows lie; only -dump and -dump-all bring rows to the
    host."""
    out = out or sys.stdout
    n = m.max_osd
    count = np.zeros(n, np.int64)
    first_count = np.zeros(n, np.int64)
    primary_count = np.zeros(n, np.int64)
    sizes: dict[int, int] = {}
    for pid in sorted(m.pools):
        if only_pool != -1 and pid != only_pool:
            continue
        pool = m.pools[pid]
        print(f"pool {pid} pg_num {pool.pg_num}", file=out)
        acting, actp, up, upp = _map_pool(m, pid, backend, device)

        def hist(ids):
            return reduce.osd_histogram(ids, n, dtype=torch.int64).cpu()

        count += hist(acting).numpy()
        first_count += hist(first_not_none(acting)).numpy()
        primary_count += hist(actp).numpy()
        sh = reduce.size_histogram(acting, acting.shape[1]).cpu().tolist()
        for sz, c in enumerate(sh):
            if c:
                sizes[sz] = sizes.get(sz, 0) + c
        if dump is None:
            continue
        acting, actp, up, upp = (t.cpu().numpy()
                                 for t in (acting, actp, up, upp))
        for ps in range(pool.pg_num):
            osds = [o for o in acting[ps] if o != ITEM_NONE]
            if dump == "dump":
                print(
                    f"{pid}.{ps:x}\t{_vec(osds)}\t{actp[ps]}", file=out
                )
            elif dump == "dump_all":
                raw = [o for o in up[ps] if o != ITEM_NONE]
                print(
                    f"{pid}.{ps:x} raw ({_vec(raw)}, p{upp[ps]}) "
                    f"up ({_vec(raw)}, p{upp[ps]}) "
                    f"acting ({_vec(osds)}, p{actp[ps]})",
                    file=out,
                )

    total = 0
    n_in = 0
    min_osd = max_osd = -1
    cwf = _crush_weightf_map(m)
    print("#osd\tcount\tfirst\tprimary\tc wt\twt", file=out)
    for i in range(n):
        if not m.is_in(i):
            continue
        cw = cwf.get(i, 0.0)
        if cw <= 0:
            continue
        n_in += 1
        print(
            f"osd.{i}\t{count[i]}\t{first_count[i]}\t{primary_count[i]}"
            f"\t{_g(cw)}\t{_g(m.get_weightf(i))}",
            file=out,
        )
        total += count[i]
        if count[i] and (min_osd < 0 or count[i] < count[min_osd]):
            min_osd = i
        if count[i] and (max_osd < 0 or count[i] > count[max_osd]):
            max_osd = i
    avg = total // n_in if n_in else 0
    dev = 0.0
    for i in range(n):
        if not m.is_in(i) or cwf.get(i, 0.0) <= 0:
            continue
        dev += float((avg - count[i]) ** 2)
    dev = math.sqrt(dev / n_in) if n_in else 0.0
    edev = (
        math.sqrt(total / n_in * (1.0 - 1.0 / n_in)) if n_in else 0.0
    )
    print(f" in {n_in}", file=out)
    print(
        f" avg {avg} stddev {_g(dev)} ({_g(dev / avg) if avg else 'nan'}x) "
        f"(expected {_g(edev)} {_g(edev / avg) if avg else 'nan'}x))",
        file=out,
    )
    if min_osd >= 0:
        print(f" min osd.{min_osd} {count[min_osd]}", file=out)
    if max_osd >= 0:
        print(f" max osd.{max_osd} {count[max_osd]}", file=out)
    for sz in sorted(sizes):
        print(f"size {sz}\t{sizes[sz]}", file=out)


class _Args:
    """ceph_argparse-alike: --opt val / --opt=val, '-' == '_'."""

    def __init__(self, argv: list[str]):
        self.argv = argv
        self.i = 0

    def done(self) -> bool:
        return self.i >= len(self.argv)

    def peek(self) -> str:
        return self.argv[self.i]

    @staticmethod
    def _norm(a: str) -> str:
        return a.replace("-", "_")

    def flag(self, *names: str) -> bool:
        a = self.peek().split("=", 1)[0]
        if self._norm(a) in {self._norm(n) for n in names}:
            self.i += 1
            return True
        return False

    def witharg(self, *names: str) -> str | None:
        """Returns the value, or None if flag doesn't match.  A matching
        flag with a missing value errors like ceph_argparse."""
        a = self.argv[self.i]
        head, eq, tail = a.partition("=")
        if self._norm(head) not in {self._norm(n) for n in names}:
            return None
        if eq:
            self.i += 1
            return tail
        if self.i + 1 >= len(self.argv):
            print(f"Option {head} requires an argument.", file=sys.stderr)
            print("", file=sys.stderr)
            raise SystemExit(1)
        self.i += 2
        return self.argv[self.i - 1]

    def withint(self, *names: str) -> int | None:
        v = self.witharg(*names)
        if v is None:
            return None
        try:
            return int(v)
        except ValueError:
            print(f"The option value '{v}' is invalid", file=sys.stderr)
            raise SystemExit(1)


def _now_utime() -> tuple[int, int]:
    t = time.time()
    return int(t), int((t % 1) * 1e9)


def main(argv: list[str] | None = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if not args:
        print(f"{ME}: -h or --help for usage", file=sys.stderr)
        return 1
    if "-h" in args or "--help" in args:
        print(USAGE, end="", file=sys.stderr)
        return 1

    createsimple = False
    num_osd = 0
    create_from_conf = False
    createpool = False
    conf_file = None
    pg_bits, pgp_bits = 6, 6
    do_print = False
    print_format: str | None = None
    tree = False
    tree_format: str | None = None
    mark_up_in = False
    marked_out = -1
    marked_up = -1
    clobber = False
    test_map_pgs_mode: str | None = None
    pool = -1
    pg_num = -1
    backend = "torch"
    device = None
    refused: list[str] = []  # flags of modules not yet ported
    upmap = False
    upmap_cleanup = False
    upmap_file = "-"
    upmap_deviation = 5
    upmap_max = 10
    upmap_pools: list[str] = []
    incrementals: list[str] = []
    aggressive = True  # osd_calc_pg_upmaps_aggressively default
    save = False
    export_crush = None
    import_crush = None
    test_map_pg = None
    test_map_object = None
    adjust_crush_weight = None
    fn = None
    default_pool_size: int | None = None
    marked_in = -1

    p = _Args(args)
    while not p.done():
        if p.flag("--print", "-p"):
            do_print = True
        elif (v := p.witharg("--dump")) is not None:
            do_print = True
            if v and v != "plain":
                print_format = v
        elif p.peek().split("=", 1)[0] == "--tree":
            a = p.peek()
            p.i += 1
            tree = True
            if "=" in a and a.split("=", 1)[1] not in ("", "plain"):
                tree_format = a.split("=", 1)[1]
        elif (v := p.withint("--createsimple")) is not None:
            createsimple = True
            num_osd = v
        elif p.flag("--create-from-conf"):
            create_from_conf = True
        elif p.flag("--with-default-pool"):
            createpool = True
        elif (v := p.witharg("-c", "--conf")) is not None:
            conf_file = v
        elif (v := p.withint("--pg-bits", "--osd-pg-bits")) is not None:
            pg_bits = v
        elif (v := p.withint("--pgp-bits", "--osd-pgp-bits")) is not None:
            pgp_bits = v
        elif p.flag("--clobber"):
            clobber = True
        elif p.flag("--mark-up-in"):
            mark_up_in = True
        elif (v := p.withint("--mark-out")) is not None:
            marked_out = v
        elif (v := p.withint("--mark-up")) is not None:
            marked_up = v
        elif (v := p.withint("--mark-in")) is not None:
            marked_in = v
        elif p.flag("--health"):
            refused.append("--health")
        elif p.flag("--test-map-pgs"):
            test_map_pgs_mode = "stats"
        elif p.flag("--test-map-pgs-dump"):
            test_map_pgs_mode = "dump"
        elif p.flag("--test-map-pgs-dump-all"):
            test_map_pgs_mode = "dump_all"
        elif (v := p.witharg("--test-map-pg")) is not None:
            test_map_pg = v
        elif (v := p.witharg("--test-map-object")) is not None:
            test_map_object = v
        elif (v := p.withint("--pool")) is not None:
            pool = v
        elif (v := p.withint("--pg-num")) is not None:
            pg_num = v
        elif (v := p.witharg("--backend")) is not None:
            backend = v
        elif (v := p.witharg("--device")) is not None:
            device = v
        elif (v := p.witharg("--upmap")) is not None:
            upmap = True
            upmap_cleanup = True
            upmap_file = v
        elif (v := p.witharg("--upmap-cleanup")) is not None:
            upmap_cleanup = True
            upmap_file = v
        elif (v := p.withint("--upmap-max")) is not None:
            upmap_max = v
        elif (v := p.withint("--upmap-deviation")) is not None:
            upmap_deviation = v
        elif (v := p.witharg("--upmap-pool")) is not None:
            upmap_pools.append(v)
        elif p.flag("--save"):
            save = True
        elif (v := p.witharg("--export-crush")) is not None:
            export_crush = v
        elif (v := p.witharg("--import-crush")) is not None:
            import_crush = v
        elif (v := p.witharg("--adjust-crush-weight")) is not None:
            adjust_crush_weight = v
        elif (v := p.witharg("--apply-incremental")) is not None:
            incrementals.append(v)
        elif p.peek().split("=", 1)[0].replace("-", "_") == \
                "__osd_calc_pg_upmaps_aggressively":
            a = p.peek()
            p.i += 1
            if "=" in a:
                aggressive = a.split("=", 1)[1].lower() not in (
                    "false", "0", "no")
            else:
                aggressive = True
        elif (v := p.withint("--osd-pool-default-size")) is not None:
            default_pool_size = v
        elif not p.peek().startswith("-"):
            if fn is None:
                fn = p.peek()
                p.i += 1
            else:
                print("too many arguments", file=sys.stderr)
                print(USAGE, end="", file=sys.stderr)
                return 1
        else:
            p.i += 1  # unrecognized: ceph_argparse skips it

    if refused:
        print(f"{ME}: {', '.join(dict.fromkeys(refused))}: not yet ported",
              file=sys.stderr)
        return 1
    if backend not in ("torch", "jax", "ref"):
        print(f"{ME}: unknown backend '{backend}'", file=sys.stderr)
        return 1
    if (upmap or upmap_cleanup) and upmap_deviation < 1:
        print("upmap-deviation must be >= 1", file=sys.stderr)
        print(USAGE, end="", file=sys.stderr)
        return 1

    if fn is None:
        print(f"{ME}: must specify osdmap filename", file=sys.stderr)
        print(USAGE, end="", file=sys.stderr)
        return 1

    print(f"{ME}: osdmap file '{fn}'", file=sys.stderr)

    m: OSDMap | None = None
    modified = False
    write_out = False

    if not createsimple and not create_from_conf and not clobber:
        if not os.path.exists(fn):
            print(
                f"{ME}: couldn't open {fn}: can't open {fn}: "
                "(2) No such file or directory",
                file=sys.stderr,
            )
            return 255
        from ceph_tpu_torch.osd.io import load_osdmap

        try:
            m = load_osdmap(fn)
        except Exception:
            print(f"{ME}: error decoding osdmap '{fn}'", file=sys.stderr)
            return 255
    elif (createsimple or create_from_conf) and not clobber \
            and os.path.exists(fn):
        print(f"{ME}: {fn} exists, --clobber to overwrite", file=sys.stderr)
        return 255
    else:
        m = OSDMap()  # --clobber without create: fresh empty map

    if createsimple or create_from_conf:
        if createsimple:
            if num_osd < 1:
                print(f"{ME}: osd count must be > 0", file=sys.stderr)
                return 1
            m = build_simple(
                num_osd, pg_bits, pgp_bits, default_pool=createpool,
                mark_up_in=False,
            )
            m.epoch = 0
        else:
            from ceph_tpu_torch.osd.conf import build_from_conf

            if not conf_file:
                print(f"{ME}: --create-from-conf requires -c", file=sys.stderr)
                return 1
            m = build_from_conf(
                conf_file, pg_bits, pgp_bits, default_pool=createpool,
            )
        if createpool and 1 in m.pools and default_pool_size is not None:
            m.pools[1].size = default_pool_size
            m.pools[1].min_size = default_pool_size - default_pool_size // 2
        now = _now_utime()
        m.wire = {"pools": {}, "created": now, "modified": now,
                  "fsid": bytes(16)}
        modified = True
    assert m is not None

    for incfile in incrementals:
        from ceph_tpu_torch.osd.incremental import (
            apply_incremental,
            decode_incremental,
        )

        with open(incfile, "rb") as f:
            inc = decode_incremental(f.read())
        m = apply_incremental(m, inc)
        print(
            f"{ME}: applied incremental epoch {inc.epoch} from {incfile}",
            file=sys.stderr,
        )
        write_out = True  # the delta already carries the new epoch

    if mark_up_in:
        print("marking all OSDs up and in")
        cwf = _crush_weightf_map(m)
        for o in range(m.max_osd):
            m.osd_state[o] |= 0b11  # EXISTS|UP (set_weight sets EXISTS)
            m.osd_weight[o] = 0x10000
            if cwf.get(o, 0.0) == 0.0:
                m.crush.adjust_item_weight(o, 0x10000)

    if 0 <= marked_out < m.max_osd:
        print(f"marking OSD@{marked_out} as out")
        m.osd_state[marked_out] |= 0b11
        m.osd_weight[marked_out] = 0

    if 0 <= marked_up < m.max_osd:
        print(f"marking OSD@{marked_up} as up")
        m.osd_state[marked_up] |= 0b10  # UP only (osdmaptool.cc:373-377)

    if 0 <= marked_in < m.max_osd:
        print(f"marking OSD@{marked_in} as up")  # reference message quirk
        m.osd_weight[marked_in] = 0x10000
        m.osd_state[marked_in] |= 0b01  # set_weight marks EXISTS

    if adjust_crush_weight:
        from ceph_tpu_torch.osd.incremental import (
            Incremental,
            apply_incremental,
        )

        for spec in adjust_crush_weight.split(","):
            if ":" not in spec:
                print(f"{ME}: use ':' as separator of osd id and its weight",
                      file=sys.stderr)
                print(USAGE, end="", file=sys.stderr)
                return 1
            osd_s, w_s = spec.split(":", 1)
            osd_id, new_weight = int(osd_s), float(w_s)
            m.crush.adjust_item_weight(osd_id, int(new_weight * 0x10000))
            print(f"Adjusted osd.{osd_id} CRUSH weight to {_g(new_weight)}")
            if save:
                m = apply_incremental(m, Incremental(epoch=m.epoch + 1))
                modified = True

    upmap_fd = None
    if upmap or upmap_cleanup:
        if upmap_file != "-":
            upmap_fd = open(upmap_file, "w")
            print(f"writing upmap command output to: {upmap_file}")

    def emit_upmap(lines: list[str]):
        out = upmap_fd or sys.stdout
        for ln in lines:
            print(ln, file=out)

    if upmap_cleanup:
        print("checking for upmap cleanups")
        cancelled, remapped = m.clean_pg_upmaps()
        lines = [f"ceph osd rm-pg-upmap-items {pg}" for pg in cancelled]
        for pg, items in remapped.items():
            pairs = " ".join(f"{f} {t}" for f, t in items)
            lines.append(f"ceph osd pg-upmap-items {pg} {pairs}")
        if lines:  # clean_pg_upmaps already mutated m
            emit_upmap(lines)
            m.epoch += 1

    if upmap:
        from ceph_tpu_torch.balancer import calc_pg_upmaps

        print(f"upmap, max-count {upmap_max}, max deviation "
              f"{upmap_deviation}")
        pool_ids: list[int] = []
        if upmap_pools:
            for name in upmap_pools:
                found = [pid for pid, n in m.pool_name.items() if n == name]
                if not found:
                    print(f" pool {name} does not exist", file=sys.stderr)
                    return 1
                pool_ids += found
            print(f" limiting to pools {upmap_pools} ({pool_ids})")
        else:
            pool_ids = sorted(m.pools)
        if not pool_ids:
            print("No pools available")
        else:
            print("pools " + " ".join(
                m.pool_name.get(i, str(i)) for i in pool_ids
            ) + " ")
            total_did = 0
            left = upmap_max
            lines: list[str] = []
            saved_items = {pg: list(v) for pg, v in m.pg_upmap_items.items()}
            for pid in pool_ids:
                res = calc_pg_upmaps(
                    m,
                    max_deviation=upmap_deviation,
                    max_iter=left,
                    only_pools={pid},
                    use_tpu=(backend != "ref"),
                    aggressive=aggressive,
                    device=device,
                )
                for pg in sorted(res.old_pg_upmap_items):
                    lines.append(f"ceph osd rm-pg-upmap-items {pg}")
                for pg, items in sorted(res.new_pg_upmap_items.items()):
                    pairs = " ".join(f"{f} {t}" for f, t in items)
                    lines.append(f"ceph osd pg-upmap-items {pg} {pairs}")
                total_did += res.num_changed
                left -= res.num_changed
                if left <= 0:
                    break
            print(f"prepared {total_did}/{upmap_max} changes")
            if total_did > 0:
                emit_upmap(lines)
                if save:
                    m.epoch += 1
                    modified = True
                else:
                    # reference only applies pending_inc when saving
                    m.pg_upmap_items = saved_items
            else:
                print("Unable to find further optimization, or distribution"
                      " is already perfect")

    if upmap_fd is not None:
        upmap_fd.close()

    if import_crush:
        from ceph_tpu_torch.crush.codec import (
            encode_crushmap,
            looks_like_crushmap,
        )
        from ceph_tpu_torch.osd.incremental import (
            Incremental,
            apply_incremental,
        )
        from ceph_tpu_torch.osd.io import load_crush_text

        with open(import_crush, "rb") as f:
            raw = f.read()
        cw = load_crush_text(import_crush)
        if cw.max_devices > m.max_osd:
            print(f"{ME}: crushmap max_devices {cw.max_devices} > "
                  f"osdmap max_osd {m.max_osd}", file=sys.stderr)
            return 1
        blob = raw if looks_like_crushmap(raw) else encode_crushmap(cw)
        inc = Incremental(epoch=m.epoch + 1)
        inc.crush = blob
        m = apply_incremental(m, inc)
        print(f"{ME}: imported {len(blob)} byte crush map from "
              f"{import_crush}")
        modified = True

    if export_crush:
        from ceph_tpu_torch.crush.codec import encode_crushmap

        with open(export_crush, "wb") as f:
            f.write(encode_crushmap(m.crush))
        print(f"{ME}: exported crush map to {export_crush}")

    if test_map_object:
        from ceph_tpu_torch.core.intmath import pg_mask_for, stable_mod
        from ceph_tpu_torch.core.rjenkins import str_hash_rjenkins

        if pool == -1:
            print(f"{ME}: assuming pool 1 (use --pool to override)")
            pool = 1
        if pool not in m.pools:
            print(f"There is no pool {pool}", file=sys.stderr)
            return 1
        pp = m.pools[pool]
        ps = str_hash_rjenkins(test_map_object.encode())
        seed = int(stable_mod(torch.tensor(ps), pp.pg_num,
                              pg_mask_for(pp.pg_num)))
        pgid = PgId(pool, seed)
        _, _, acting, _ = m.pg_to_up_acting_osds(pgid)
        print(f" object '{test_map_object}' -> {pgid} -> {_vec(acting)}")

    if test_map_pg:
        try:
            pg = PgId.parse(test_map_pg)
        except Exception:
            print(f"{ME}: failed to parse pg '{test_map_pg}",
                  file=sys.stderr)
            print(USAGE, end="", file=sys.stderr)
            return 1
        print(f" parsed '{test_map_pg}' -> {pg}")
        up, upp, acting, actp = m.pg_to_up_acting_osds(pg)
        print(
            f"{pg} raw ({_vec(up)}, p{upp}) "
            f"up ({_vec(up)}, p{upp}) acting ({_vec(acting)}, p{actp})"
        )

    if test_map_pgs_mode:
        if pool != -1 and pool not in m.pools:
            print(f"There is no pool {pool}", file=sys.stderr)
            return 1
        if pg_num > 0 and pool in m.pools:
            m.pools[pool].pg_num = pg_num
        test_map_pgs(
            m,
            only_pool=pool,
            dump=None if test_map_pgs_mode == "stats" else test_map_pgs_mode,
            backend=backend,
            device=device,
        )

    no_action = not (
        do_print or tree or modified or write_out or export_crush
        or import_crush or test_map_pg or test_map_object
        or test_map_pgs_mode or adjust_crush_weight or upmap
        or upmap_cleanup
    )
    if no_action:
        print(f"{ME}: no action specified?", file=sys.stderr)
        print(USAGE, end="", file=sys.stderr)
        return 1

    if modified:
        m.epoch += 1

    if do_print:
        from ceph_tpu_torch.osd.print import print_osdmap

        if print_format:
            from ceph_tpu_torch.osd.io import osdmap_to_dict

            d = osdmap_to_dict(m)
            d.pop("crush", None)
            print(json.dumps(d, indent=4))
        else:
            print_osdmap(m, sys.stdout)

    if tree:
        from ceph_tpu_torch.osd.print import print_tree_plain, tree_json

        if tree_format:
            print(json.dumps(tree_json(m), indent=4))
            print()
        else:
            print_tree_plain(m, sys.stdout)

    if modified or write_out:
        from ceph_tpu_torch.osd.io import save_osdmap

        if "modified" in getattr(m, "wire", {}) and (createsimple
                                                     or create_from_conf):
            m.wire["modified"] = _now_utime()
        print(f"{ME}: writing epoch {m.epoch} to {fn}")
        save_osdmap(m, fn)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
