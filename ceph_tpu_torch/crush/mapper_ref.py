"""Pure-Python reference CRUSH mapper — the host-side semantic oracle.

The port's copy of `ceph_tpu/crush/mapper_ref.py`: a bit-exact
re-implementation of the mapping algorithm of the C reference (reference
src/crush/mapper.c): rule interpreter (crush_do_rule), the five bucket
choose functions (uniform with the C's stateful permutation), firstn/indep
replica selection with the full reject/collision/retry semantics, all
tunables (the legacy local retries included) and the choose_tries
histogram, and the decision-recorder hooks `crush/explain.py` replays
a placement through (`do_rule(recorder=...)`; with no recorder the walk
and its result are the same).

This is NOT the fast path (that is ceph_tpu_torch.crush.mapper's rule
kernel); the CLIs' single-PG paths (`osdmaptool --test-map-pg`,
`--test-map-object`), `crushtool explain`, `--locate-divergence`'s host
half and the tester's `ref` backend run it.

All arithmetic uses Python ints with explicit 32/64-bit wrapping to mirror C
integer semantics.
"""

from __future__ import annotations

from ceph_tpu_torch.core.intmath import div_trunc_int
from ceph_tpu_torch.core.lntable import crush_ln_np
from ceph_tpu_torch.core.rjenkins import hash2_int, hash3_int, hash4_int
from ceph_tpu_torch.crush.types import (
    Bucket,
    BucketAlg,
    ChooseArgs,
    CrushMap,
    ITEM_NONE,
    ITEM_UNDEF,
    RuleOp,
)

S64_MIN = -(1 << 63)


_h2, _h3, _h4 = hash2_int, hash3_int, hash4_int



class _PermState:
    """Per-bucket memoized Fisher-Yates permutation state
    (struct crush_work_bucket, reference src/crush/crush.h:539-547)."""

    __slots__ = ("perm_x", "perm_n", "perm")

    def __init__(self):
        self.perm_x = 0
        self.perm_n = 0
        self.perm: list[int] = []


class WorkSpace:
    """crush_work equivalent: per-bucket perm state, reset per map
    (reference src/crush/mapper.c:858-887)."""

    def __init__(self):
        self.work: dict[int, _PermState] = {}

    def for_bucket(self, bucket_id: int) -> _PermState:
        st = self.work.get(bucket_id)
        if st is None:
            st = self.work[bucket_id] = _PermState()
        return st


def bucket_perm_choose(bucket: Bucket, work: _PermState, x: int, r: int) -> int:
    """reference src/crush/mapper.c:73-131."""
    pr = r % bucket.size
    if work.perm_x != (x & 0xFFFFFFFF) or work.perm_n == 0:
        work.perm_x = x & 0xFFFFFFFF
        if pr == 0:
            s = _h3(x, bucket.id, 0) % bucket.size
            work.perm = [0] * bucket.size
            work.perm[0] = s
            work.perm_n = 0xFFFF  # magic: only slot 0 is valid
            return bucket.items[s]
        work.perm = list(range(bucket.size))
        work.perm_n = 0
    elif work.perm_n == 0xFFFF:
        # clean up after the r=0 fast path
        s = work.perm[0]
        work.perm = list(range(bucket.size))
        work.perm[0] = s
        work.perm[s] = 0
        work.perm_n = 1

    while work.perm_n <= pr:
        p = work.perm_n
        if p < bucket.size - 1:
            i = _h3(x, bucket.id, p) % (bucket.size - p)
            if i:
                work.perm[p + i], work.perm[p] = work.perm[p], work.perm[p + i]
        work.perm_n += 1
    return bucket.items[work.perm[pr]]


def bucket_list_choose(bucket: Bucket, x: int, r: int) -> int:
    """reference src/crush/mapper.c:141-164."""
    assert bucket.sum_weights is not None
    for i in range(bucket.size - 1, -1, -1):
        w = _h4(x, bucket.items[i], r, bucket.id) & 0xFFFF
        w = (w * bucket.sum_weights[i]) >> 16
        if w < bucket.weights[i]:
            return bucket.items[i]
    return bucket.items[0]


def bucket_tree_choose(bucket: Bucket, x: int, r: int) -> int:
    """reference src/crush/mapper.c:195-222."""
    nw = bucket.node_weights
    assert nw is not None
    n = len(nw) >> 1  # root
    while not (n & 1):
        w = nw[n]
        t = (_h4(x, n, r, bucket.id) * w) >> 32
        h = 0
        m = n
        while (m & 1) == 0:
            h += 1
            m >>= 1
        left = n - (1 << (h - 1))
        n = left if t < nw[left] else n + (1 << (h - 1))
    return bucket.items[n >> 1]


def bucket_straw_choose(bucket: Bucket, x: int, r: int) -> int:
    """reference src/crush/mapper.c:227-245."""
    assert bucket.straws is not None
    high = 0
    high_draw = 0
    for i in range(bucket.size):
        draw = (_h3(x, bucket.items[i], r) & 0xFFFF) * bucket.straws[i]
        if i == 0 or draw > high_draw:
            high = i
            high_draw = draw
    return bucket.items[high]


def _exp_draw(x: int, y: int, z: int, weight: int) -> int:
    """generate_exponential_distribution (reference src/crush/mapper.c:334-359):
    table-driven -ln(U)/w in 64-bit fixed point."""
    u = _h3(x, y, z) & 0xFFFF
    ln = int(crush_ln_np(u)) - 0x1000000000000
    return div_trunc_int(ln, weight)


def bucket_straw2_choose(
    bucket: Bucket,
    x: int,
    r: int,
    arg_weights: list[int] | None,
    arg_ids: list[int] | None,
) -> int:
    """reference src/crush/mapper.c:361-384."""
    weights = arg_weights if arg_weights is not None else bucket.weights
    ids = arg_ids if arg_ids is not None else bucket.items
    high = 0
    high_draw = 0
    for i in range(bucket.size):
        if weights[i]:
            draw = _exp_draw(x, ids[i], r, weights[i])
        else:
            draw = S64_MIN
        if i == 0 or draw > high_draw:
            high = i
            high_draw = draw
    return bucket.items[high]


def _choose_arg_for(
    choose_args: ChooseArgs | None, bucket: Bucket, position: int
) -> tuple[list[int] | None, list[int] | None]:
    """get_choose_arg_weights/_ids (reference src/crush/mapper.c:309-326)."""
    if choose_args is None:
        return None, None
    ws = choose_args.weight_sets.get(bucket.id)
    ids = choose_args.ids.get(bucket.id)
    w = None
    if ws:
        pos = min(position, len(ws) - 1)
        w = ws[pos]
    return w, ids


def crush_bucket_choose(
    map_: CrushMap,
    work: WorkSpace,
    bucket: Bucket,
    x: int,
    r: int,
    choose_args: ChooseArgs | None,
    position: int,
    recorder=None,
) -> int:
    """reference src/crush/mapper.c:387-418.

    recorder: optional decision recorder (crush.explain.ExplainRecorder
    protocol).  With `recorder.detail`, straw2 draws are re-derived and
    emitted per item — the winner/loser view `crushtool explain` prints.
    Never changes the choice."""
    assert bucket.size > 0
    if bucket.alg == BucketAlg.UNIFORM:
        return bucket_perm_choose(bucket, work.for_bucket(bucket.id), x, r)
    if bucket.alg == BucketAlg.LIST:
        return bucket_list_choose(bucket, x, r)
    if bucket.alg == BucketAlg.TREE:
        return bucket_tree_choose(bucket, x, r)
    if bucket.alg == BucketAlg.STRAW:
        return bucket_straw_choose(bucket, x, r)
    if bucket.alg == BucketAlg.STRAW2:
        aw, ai = _choose_arg_for(choose_args, bucket, position)
        item = bucket_straw2_choose(bucket, x, r, aw, ai)
        if recorder is not None and recorder.detail:
            weights = aw if aw is not None else bucket.weights
            draws = [
                (bucket.items[i],
                 _exp_draw(x, (ai if ai is not None else bucket.items)[i],
                           r, weights[i]) if weights[i] else S64_MIN)
                for i in range(bucket.size)
            ]
            recorder.emit(ev="straw2", bucket=bucket.id, r=r,
                          winner=item, draws=draws)
        return item
    return bucket.items[0]


def is_out(map_: CrushMap, weight: list[int], item: int, x: int) -> bool:
    """reference src/crush/mapper.c:424-438."""
    if item >= len(weight):
        return True
    w = weight[item]
    if w >= 0x10000:
        return False
    if w == 0:
        return True
    return (_h2(x, item) & 0xFFFF) >= w


def crush_choose_firstn(
    map_: CrushMap,
    work: WorkSpace,
    bucket: Bucket,
    weight: list[int],
    x: int,
    numrep: int,
    type_: int,
    out: list[int],
    outpos: int,
    out_size: int,
    tries: int,
    recurse_tries: int,
    local_retries: int,
    local_fallback_retries: int,
    recurse_to_leaf: bool,
    vary_r: int,
    stable: int,
    out2: list[int] | None,
    parent_r: int,
    choose_args: ChooseArgs | None,
    choose_tries_hist: list[int] | None = None,
    recorder=None,
) -> int:
    """reference src/crush/mapper.c:460-648.

    recorder: optional decision recorder; one `draw` event per attempt
    (item, r, final status), `place` on success, `leaf_enter`/`leaf_exit`
    around chooseleaf recursions.  Pure observation — the walk itself is
    untouched."""
    count = out_size
    rep = 0 if stable else outpos
    while rep < numrep and count > 0:
        ftotal = 0
        skip_rep = False
        item = 0
        retry_descent = True
        while retry_descent:
            retry_descent = False
            in_ = bucket
            flocal = 0
            retry_bucket = True
            while retry_bucket:
                retry_bucket = False
                collide = False
                r = rep + parent_r + ftotal

                def _draw(status, it=None, bkt=None):
                    if recorder is not None:
                        recorder.emit(
                            ev="draw", rep=rep, r=r, ftotal=ftotal,
                            bucket=in_.id if bkt is None else bkt,
                            item=it, status=status,
                        )

                if in_.size == 0:
                    reject = True
                    _draw("empty")
                else:
                    if (
                        local_fallback_retries > 0
                        and flocal >= (in_.size >> 1)
                        and flocal > local_fallback_retries
                    ):
                        item = bucket_perm_choose(
                            in_, work.for_bucket(in_.id), x, r
                        )
                    else:
                        item = crush_bucket_choose(
                            map_, work, in_, x, r, choose_args, outpos,
                            recorder=recorder,
                        )
                    if item >= map_.max_devices:
                        skip_rep = True
                        _draw("skip_device_id", item)
                        break

                    child = map_.buckets.get(item) if item < 0 else None
                    if item < 0 and child is None:
                        # dangling bucket id ("bad item type" path; C skips
                        # when -1-item >= max_buckets)
                        skip_rep = True
                        _draw("skip_dangling", item)
                        break
                    itemtype = child.type if item < 0 else 0

                    if itemtype != type_:
                        if item >= 0:
                            skip_rep = True
                            _draw("skip_type", item)
                            break
                        _draw("descend", item)
                        in_ = child
                        retry_bucket = True
                        continue

                    for i in range(outpos):
                        if out[i] == item:
                            collide = True
                            break

                    reject = False
                    reject_why = None
                    if not collide and recurse_to_leaf:
                        if item < 0:
                            sub_r = (r >> (vary_r - 1)) if vary_r else 0
                            if recorder is not None:
                                recorder.emit(ev="leaf_enter", rep=rep,
                                              bucket=item, r=sub_r)
                                recorder.depth += 1
                            got = crush_choose_firstn(
                                map_,
                                work,
                                map_.buckets[item],
                                weight,
                                x,
                                1 if stable else outpos + 1,
                                0,
                                out2,  # type: ignore[arg-type]
                                outpos,
                                count,
                                recurse_tries,
                                0,
                                local_retries,
                                local_fallback_retries,
                                False,
                                vary_r,
                                stable,
                                None,
                                sub_r,
                                choose_args,
                                choose_tries_hist,
                                recorder=recorder,
                            )
                            if recorder is not None:
                                recorder.depth -= 1
                                recorder.emit(ev="leaf_exit", rep=rep,
                                              ok=got > outpos)
                            if got <= outpos:
                                reject = True
                                reject_why = "reject_leaf"
                        else:
                            while len(out2) <= outpos:  # type: ignore[arg-type]
                                out2.append(ITEM_NONE)  # type: ignore[union-attr]
                            out2[outpos] = item  # type: ignore[index]

                    if not reject and not collide:
                        if itemtype == 0:
                            reject = is_out(map_, weight, item, x)
                            if reject:
                                reject_why = "out"
                    _draw("collide" if collide
                          else (reject_why or "ok") if reject else "ok",
                          item)

                if reject or collide:
                    ftotal += 1
                    flocal += 1
                    if collide and flocal <= local_retries:
                        retry_bucket = True
                    elif (
                        local_fallback_retries > 0
                        and flocal <= in_.size + local_fallback_retries
                    ):
                        retry_bucket = True
                    elif ftotal < tries:
                        retry_descent = True
                        break  # leave retry_bucket loop
                    else:
                        skip_rep = True
                        break

        if skip_rep:
            rep += 1
            continue

        # extend out if needed (C writes into caller-sized scratch)
        while len(out) <= outpos:
            out.append(ITEM_NONE)
        out[outpos] = item
        outpos += 1
        count -= 1
        if choose_tries_hist is not None and ftotal <= len(choose_tries_hist) - 1:
            choose_tries_hist[ftotal] += 1
        if recorder is not None:
            recorder.emit(ev="place", rep=rep, item=item, ftotal=ftotal,
                          outpos=outpos - 1)
        rep += 1

    return outpos


def crush_choose_indep(
    map_: CrushMap,
    work: WorkSpace,
    bucket: Bucket,
    weight: list[int],
    x: int,
    left: int,
    numrep: int,
    type_: int,
    out: list[int],
    outpos: int,
    tries: int,
    recurse_tries: int,
    recurse_to_leaf: bool,
    out2: list[int] | None,
    parent_r: int,
    choose_args: ChooseArgs | None,
    choose_tries_hist: list[int] | None = None,
    recorder=None,
) -> None:
    """reference src/crush/mapper.c:655-843."""
    endpos = outpos + left
    while len(out) < endpos:
        out.append(ITEM_NONE)
    if out2 is not None:
        while len(out2) < endpos:
            out2.append(ITEM_NONE)

    for rep in range(outpos, endpos):
        out[rep] = ITEM_UNDEF
        if out2 is not None:
            out2[rep] = ITEM_UNDEF

    ftotal = 0
    while left > 0 and ftotal < tries:
        for rep in range(outpos, endpos):
            if out[rep] != ITEM_UNDEF:
                continue
            in_ = bucket
            while True:
                r = rep + parent_r
                if in_.alg == BucketAlg.UNIFORM and in_.size % numrep == 0:
                    r += (numrep + 1) * ftotal
                else:
                    r += numrep * ftotal

                def _draw(status, it=None):
                    if recorder is not None:
                        recorder.emit(
                            ev="draw", rep=rep, r=r, ftotal=ftotal,
                            bucket=in_.id, item=it, status=status,
                        )

                if in_.size == 0:
                    _draw("empty")
                    break

                item = crush_bucket_choose(
                    map_, work, in_, x, r, choose_args, outpos,
                    recorder=recorder,
                )
                if item >= map_.max_devices:
                    out[rep] = ITEM_NONE
                    if out2 is not None:
                        out2[rep] = ITEM_NONE
                    left -= 1
                    _draw("skip_device_id", item)
                    break

                child = map_.buckets.get(item) if item < 0 else None
                if item < 0 and child is None:
                    out[rep] = ITEM_NONE
                    if out2 is not None:
                        out2[rep] = ITEM_NONE
                    left -= 1
                    _draw("skip_dangling", item)
                    break
                itemtype = child.type if item < 0 else 0

                if itemtype != type_:
                    if item >= 0:
                        out[rep] = ITEM_NONE
                        if out2 is not None:
                            out2[rep] = ITEM_NONE
                        left -= 1
                        _draw("skip_type", item)
                        break
                    _draw("descend", item)
                    in_ = child
                    continue

                collide = False
                for i in range(outpos, endpos):
                    if out[i] == item:
                        collide = True
                        break
                if collide:
                    _draw("collide", item)
                    break

                if recurse_to_leaf:
                    if item < 0:
                        if recorder is not None:
                            recorder.emit(ev="leaf_enter", rep=rep,
                                          bucket=item, r=r)
                            recorder.depth += 1
                        crush_choose_indep(
                            map_,
                            work,
                            map_.buckets[item],
                            weight,
                            x,
                            1,
                            numrep,
                            0,
                            out2,  # type: ignore[arg-type]
                            rep,
                            recurse_tries,
                            0,
                            False,
                            None,
                            r,
                            choose_args,
                            choose_tries_hist,
                            recorder=recorder,
                        )
                        if recorder is not None:
                            recorder.depth -= 1
                            recorder.emit(
                                ev="leaf_exit", rep=rep,
                                ok=not (out2 is not None
                                        and out2[rep] == ITEM_NONE),
                            )
                        if out2 is not None and out2[rep] == ITEM_NONE:
                            _draw("reject_leaf", item)
                            break
                    elif out2 is not None:
                        out2[rep] = item

                if itemtype == 0 and is_out(map_, weight, item, x):
                    _draw("out", item)
                    break

                out[rep] = item
                left -= 1
                _draw("ok", item)
                if recorder is not None:
                    recorder.emit(ev="place", rep=rep, item=item,
                                  ftotal=ftotal, outpos=rep)
                break
        ftotal += 1
        if left <= 0:
            break

    # C increments ftotal in the for(;;ftotal++) header even on the
    # iteration that breaks via left==0; the loop above mirrors that.
    for rep in range(outpos, endpos):
        if out[rep] == ITEM_UNDEF:
            out[rep] = ITEM_NONE
        if out2 is not None and out2[rep] == ITEM_UNDEF:
            out2[rep] = ITEM_NONE
    if choose_tries_hist is not None and ftotal <= len(choose_tries_hist) - 1:
        choose_tries_hist[ftotal] += 1


def find_rule(map_: CrushMap, ruleset: int, type_: int, size: int) -> int:
    """reference src/crush/mapper.c:41-54."""
    for i, r in enumerate(map_.rules):
        if (
            r is not None
            and r.ruleset == ruleset
            and r.type == type_
            and r.min_size <= size <= r.max_size
        ):
            return i
    return -1


def do_rule(
    map_: CrushMap,
    ruleno: int,
    x: int,
    result_max: int,
    weight: list[int],
    choose_args: ChooseArgs | int | str | None = None,
    collect_choose_tries: bool = False,
    recorder=None,
) -> list[int]:
    """crush_do_rule (reference src/crush/mapper.c:900-1105).

    Returns the result vector (length <= result_max).  `weight` is the
    per-device 16.16 in/out weight vector (not the crush tree weights).

    recorder: optional decision recorder (crush.explain.ExplainRecorder)
    — emits take/choose/draw/place/emit events and books the post-step
    work vector after every choose step (`recorder.step_result`), the
    host half of the jax-vs-host first-divergence locator.
    """
    if isinstance(choose_args, (int, str)):
        choose_args = map_.choose_args.get(choose_args)

    if ruleno < 0 or ruleno >= len(map_.rules) or map_.rules[ruleno] is None:
        return []
    rule = map_.rules[ruleno]
    t = map_.tunables

    work = WorkSpace()
    hist = None
    if collect_choose_tries:
        if map_.choose_tries_histogram is None:
            map_.choose_tries_histogram = [0] * (t.choose_total_tries + 1)
        hist = map_.choose_tries_histogram

    choose_tries = t.choose_total_tries + 1  # off-by-one compat
    choose_leaf_tries = 0
    choose_local_retries = t.choose_local_tries
    choose_local_fallback_retries = t.choose_local_fallback_tries
    vary_r = t.chooseleaf_vary_r
    stable = t.chooseleaf_stable

    result: list[int] = []
    w: list[int] = []
    o: list[int] = []
    c: list[int] = []
    wsize = 0

    for op, arg1, arg2 in rule.steps:
        firstn = False
        if op == RuleOp.TAKE:
            if (0 <= arg1 < map_.max_devices) or (arg1 < 0 and arg1 in map_.buckets):
                w = [arg1]
                wsize = 1
            if recorder is not None:
                recorder.emit(ev="take", item=arg1, valid=wsize == 1)
        elif op == RuleOp.SET_CHOOSE_TRIES:
            if arg1 > 0:
                choose_tries = arg1
        elif op == RuleOp.SET_CHOOSELEAF_TRIES:
            if arg1 > 0:
                choose_leaf_tries = arg1
        elif op == RuleOp.SET_CHOOSE_LOCAL_TRIES:
            if arg1 >= 0:
                choose_local_retries = arg1
        elif op == RuleOp.SET_CHOOSE_LOCAL_FALLBACK_TRIES:
            if arg1 >= 0:
                choose_local_fallback_retries = arg1
        elif op == RuleOp.SET_CHOOSELEAF_VARY_R:
            if arg1 >= 0:
                vary_r = arg1
        elif op == RuleOp.SET_CHOOSELEAF_STABLE:
            if arg1 >= 0:
                stable = arg1
        elif op in (
            RuleOp.CHOOSELEAF_FIRSTN,
            RuleOp.CHOOSE_FIRSTN,
            RuleOp.CHOOSELEAF_INDEP,
            RuleOp.CHOOSE_INDEP,
        ):
            if op in (RuleOp.CHOOSELEAF_FIRSTN, RuleOp.CHOOSE_FIRSTN):
                firstn = True
            if wsize == 0:
                continue
            recurse_to_leaf = op in (
                RuleOp.CHOOSELEAF_FIRSTN,
                RuleOp.CHOOSELEAF_INDEP,
            )
            if recorder is not None:
                recorder.emit(ev="choose", op=int(op), firstn=firstn,
                              leafy=recurse_to_leaf, numrep=arg1,
                              type=arg2, sources=list(w[:wsize]))
            osize = 0
            o = []
            c = []
            for i in range(wsize):
                numrep = arg1
                if numrep <= 0:
                    numrep += result_max
                    if numrep <= 0:
                        continue
                if w[i] >= 0 or w[i] not in map_.buckets:
                    continue  # bad take value / ITEM_NONE
                bucket = map_.buckets[w[i]]
                if firstn:
                    if choose_leaf_tries:
                        recurse_tries = choose_leaf_tries
                    elif t.chooseleaf_descend_once:
                        recurse_tries = 1
                    else:
                        recurse_tries = choose_tries
                    while len(o) < osize:
                        o.append(ITEM_NONE)
                    while len(c) < osize:
                        c.append(ITEM_NONE)
                    sub_o = o[osize:]
                    sub_c = c[osize:]
                    n = crush_choose_firstn(
                        map_,
                        work,
                        bucket,
                        weight,
                        x,
                        numrep,
                        arg2,
                        sub_o,
                        0,
                        result_max - osize,
                        choose_tries,
                        recurse_tries,
                        choose_local_retries,
                        choose_local_fallback_retries,
                        recurse_to_leaf,
                        vary_r,
                        stable,
                        sub_c,
                        0,
                        choose_args,
                        hist,
                        recorder=recorder,
                    )
                    o = o[:osize] + sub_o
                    c = c[:osize] + sub_c
                    osize += n
                else:
                    out_size = min(numrep, result_max - osize)
                    sub_o: list[int] = []
                    sub_c: list[int] = []
                    crush_choose_indep(
                        map_,
                        work,
                        bucket,
                        weight,
                        x,
                        out_size,
                        numrep,
                        arg2,
                        sub_o,
                        0,
                        choose_tries,
                        choose_leaf_tries if choose_leaf_tries else 1,
                        recurse_to_leaf,
                        sub_c,
                        0,
                        choose_args,
                        hist,
                        recorder=recorder,
                    )
                    o = o[:osize] + sub_o
                    c = c[:osize] + sub_c
                    osize += out_size
            if recurse_to_leaf:
                c = c + [ITEM_NONE] * (osize - len(c))
                o = list(c[:osize]) + o[osize:]
            w = o
            wsize = osize
            if recorder is not None:
                recorder.step_result(list(w[:wsize]))
        elif op == RuleOp.EMIT:
            for i in range(wsize):
                if len(result) >= result_max:
                    break
                result.append(w[i])
            wsize = 0
            if recorder is not None:
                recorder.emit(ev="emit", result=list(result))

    return result
