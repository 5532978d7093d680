"""Sort-based hash join.

Reference behavior: be/src/exec/hash_joiner.h:192 + join_hash_map.h —
build/probe hash join with INNER/LEFT OUTER/SEMI/ANTI and build-side runtime
filters. The JAX package's design, carried over operator for operator:

- multi-column keys pack into one int64 by the planner's bit widths
  (pack_keys), or into a splitmix64 fingerprint ("hash" mode);
- unique build keys (PK-FK joins): output rows = probe rows, pure gather —
  through a sorted build + torch.searchsorted (`join_probe_strategy =
  auto`), the sorted build + the lower-bound kernel of ops/kernels.py
  (`pallas_sorted`), the open-addressing table of ops/kernels.py
  (`pallas`), or a direct-address row LUT for stats-bounded single keys
  (hash_join_lut);
- duplicate build keys: run-length expansion with a static output capacity
  and a true-size return for the executor's overflow retry.

NULL join keys never match (SQL equality semantics). Every gather clamps and
every scatter drops out-of-range indices, as JAX's do.
"""

from __future__ import annotations

import dataclasses

import torch

from ..column.column import Chunk, Schema
from . import kernels
from .common import GOLDEN, argsort_stable, eval_keys, mix64, scatter_set, shr64

INNER = "inner"
LEFT_OUTER = "left_outer"
LEFT_SEMI = "left_semi"
LEFT_ANTI = "left_anti"

_I64MAX = (1 << 63) - 1
_I64MIN = -(1 << 63)


def _pack_evals(keys, live, capacity: int, bit_widths):
    """Pack evaluated key EVals into one int64 per row (see pack_keys)."""
    dev = live.device
    ok = live
    for k in keys:
        if k.valid is not None:
            ok = ok & k.valid
    if len(keys) == 1 and bit_widths is None:
        packed = keys[0].data.to(torch.int64)
    elif bit_widths == "hash":
        h = torch.zeros((capacity,), dtype=torch.int64, device=dev)
        cols = []
        for k in keys:
            kd = k.data
            if kd.ndim == 2:  # rank-2 (DECIMAL128 limbs): hash each limb
                cols.extend(kd[:, j] for j in range(kd.shape[1]))
                continue
            if kd.is_floating_point() or kd.dtype == torch.bool:
                # non-integer keys hash their float64 bit pattern
                kd = kd.to(torch.float64)
                kd = torch.where(kd == 0, 0.0, kd)  # -0.0 == +0.0 in SQL
                kd = kd.contiguous().view(torch.int64)
            cols.append(kd)
        for kd in cols:
            kh = mix64(kd.to(torch.int64))
            # boost hash_combine: order-sensitive, avalanched
            h = mix64(h ^ (kh + GOLDEN + (h << 6) + shr64(h, 2)))
        packed = h
        # keep the NULL/dead sentinel unambiguous
        packed = torch.where(packed == _I64MAX, _I64MAX - 1, packed)
    else:
        if bit_widths is None or len(bit_widths) != len(keys):
            raise ValueError("multi-key join requires planner-provided bit widths")
        packed = torch.zeros((capacity,), dtype=torch.int64, device=dev)
        for k, w in zip(keys, bit_widths):
            kd = k.data.to(torch.int64)
            packed = (packed << w) | (kd & ((1 << w) - 1))
    return torch.where(ok, packed, _I64MAX), ok


def pack_keys(chunk: Chunk, key_exprs, bit_widths=None):
    """Evaluate key exprs and pack them into one int64 per row.

    NULL any-key or dead row -> sentinel INT64 MAX. Returns (packed[cap]
    int64, ok[cap] bool) where ok = live & all keys valid. SINGLE-side
    callers only: dict-encoded string keys pack RAW codes; anything
    comparing two chunks' keys must go through pack_key_pair."""
    keys = eval_keys(chunk, key_exprs)
    return _pack_evals(keys, chunk.sel_mask(), chunk.capacity, bit_widths)


def _remap_codes(codes, remap, dict_len: int):
    lut = torch.from_numpy(remap.astype("int64")).to(codes.device)
    return lut[codes.to(torch.int64).clamp(0, max(dict_len - 1, 0))]


def _align_dict_keys(pks, bks):
    """Remap dict-encoded key pairs onto a shared merged dictionary, so code
    equality means string equality across the two sides."""
    out_p, out_b = [], []
    for p, b in zip(pks, bks):
        if p.dict is not None and b.dict is not None and p.dict is not b.dict:
            m, rp, rb = p.dict.merge(b.dict)
            pd = (_remap_codes(p.data, rp, len(p.dict)) if len(p.dict)
                  else p.data.to(torch.int64))
            bd = (_remap_codes(b.data, rb, len(b.dict)) if len(b.dict)
                  else b.data.to(torch.int64))
            p = dataclasses.replace(p, data=pd, dict=m)
            b = dataclasses.replace(b, data=bd, dict=m)
        out_p.append(p)
        out_b.append(b)
    return out_p, out_b


def pack_key_pair(probe: Chunk, build: Chunk, probe_keys, build_keys,
                  bit_widths=None):
    """pack_keys for a probe/build pair: aligns string dictionaries between
    the sides before packing. Returns (pk, p_ok, bk, b_ok)."""
    pks = eval_keys(probe, probe_keys)
    bks = eval_keys(build, build_keys)
    pks, bks = _align_dict_keys(pks, bks)
    pk, p_ok = _pack_evals(pks, probe.sel_mask(), probe.capacity, bit_widths)
    bk, b_ok = _pack_evals(bks, build.sel_mask(), build.capacity, bit_widths)
    return pk, p_ok, bk, b_ok


def align_chunk_dicts(lc: Chunk, rc: Chunk, probe_keys, build_keys):
    """Rewrite dict-encoded join-key COLUMNS of both chunks onto merged
    dictionaries (Col keys only). Needed where the two sides are routed
    independently — the distributed hash shuffle packs each side's codes
    separately, so equal strings must carry equal codes BEFORE the
    exchange, not just inside the join."""
    from ..exprs.ir import Col

    for pk, bk in zip(probe_keys, build_keys):
        if not (isinstance(pk, Col) and isinstance(bk, Col)):
            continue
        fi = lc.schema.index(pk.name)
        gi = rc.schema.index(bk.name)
        fp, fb = lc.schema.fields[fi], rc.schema.fields[gi]
        if fp.dict is None or fb.dict is None or fp.dict is fb.dict:
            continue
        m, rp, rb = fp.dict.merge(fb.dict)

        def remap(chunk, i, f, lut, old_len, merged):
            codes = chunk.data[i]
            if old_len:
                codes = _remap_codes(codes, lut, old_len)
            data = chunk.data[:i] + (codes,) + chunk.data[i + 1:]
            fields = list(chunk.schema.fields)
            fields[i] = dataclasses.replace(f, dict=merged)
            return Chunk(Schema(tuple(fields)), data, chunk.valid, chunk.sel,
                         chunk.device)

        lc = remap(lc, fi, fp, rp, len(fp.dict), m)
        rc = remap(rc, gi, fb, rb, len(fb.dict), m)
    return lc, rc


def _presence(bk, b_ok, lo: int, size: int):
    """Dense presence bitmap of the build keys over [lo, lo + size)."""
    return scatter_set(size, torch.where(b_ok, bk - lo, size), 1, 0,
                       torch.uint8)


def _shard_pairs(probe, build):
    """(probe, build) chunk pairs of a runtime filter over a mesh: `build`
    is a tuple of per-shard chunks; `probe` a tuple too, or one REPLICATED
    chunk, which then pairs with every build shard."""
    ps = probe if isinstance(probe, tuple) else (probe,) * len(build)
    return list(zip(ps, build))


def _per_probe(probe, masks):
    """Per-shard masks back in the probe's placement."""
    return tuple(masks) if isinstance(probe, tuple) else masks[0]


def runtime_filter_mask(probe: Chunk, build: Chunk, probe_keys, build_keys,
                        bit_widths=None, axis=None,
                        dense_range: tuple | None = None):
    """Build-side runtime filter applied to the probe (reference:
    be/src/exec_primitive/runtime_filter/ + the global merge of
    orchestration/runtime_filter_worker.h:41). EXACT membership through a
    dense presence bitmap when the planner bounds the key range
    (`dense_range=(lo, hi)`), else the build's min/max range. With `axis`
    (a parallel.mesh.Mesh) the build is a tuple of per-shard chunks whose
    summaries merge across the shards before any probe uses them — pmin/
    pmax for the range, bitwise OR (pmax) for the bitmap — and the probe is
    a tuple of shards or one REPLICATED chunk; the masks come back in the
    probe's placement. Only valid for INNER/LEFT SEMI joins."""
    if axis is None:
        pairs = [(probe, build)]
    else:
        pairs = _shard_pairs(probe, build)
    packed = [pack_key_pair(p, b, probe_keys, build_keys, bit_widths)
              for p, b in pairs]
    if dense_range is not None:
        lo, hi = dense_range
        size = int(hi - lo + 1)
        present = [_presence(bk, b_ok, lo, size) for _, _, bk, b_ok in packed]
        present = present[0] if axis is None else axis.pmax(present)
        masks = []
        for pk, _, _, _ in packed:
            idx = pk - lo
            in_range = (idx >= 0) & (idx < size)
            here = present if axis is None else axis.to(present, pk.device)
            masks.append(in_range & (here[idx.clamp(0, size - 1)] == 1))
    else:
        bmin = [torch.where(b_ok, bk, _I64MAX).min()
                for _, _, bk, b_ok in packed]
        bmax = [torch.where(b_ok, bk, _I64MIN).max()
                for _, _, bk, b_ok in packed]
        if axis is None:
            bmin, bmax = bmin[0], bmax[0]
        else:
            bmin, bmax = axis.pmin(bmin), axis.pmax(bmax)
        # An all-NULL (or empty) build leaves bmin > bmax: the mask is
        # all-false, the intended INNER/SEMI semantics (an empty key set
        # matches nothing).
        if axis is not None:  # the merged bounds, on each probe's device
            masks = [(pk >= axis.to(bmin, pk.device))
                     & (pk <= axis.to(bmax, pk.device))
                     for pk, _, _, _ in packed]
        else:
            masks = [(pk >= bmin) & (pk <= bmax) for pk, _, _, _ in packed]
    if axis is None:
        return masks[0]
    return _per_probe(probe, masks)


_BLOOM_SALT = GOLDEN  # golden-ratio odd constant (2nd probe)


def bloom_build_bitset(bk, b_ok, bits: int, axis=None):
    """Build-side half of the bloom runtime filter: hash packed keys into a
    power-of-2 bit array (one uint8 lane per bit) via TWO splitmix64 probes.
    With `axis` (a parallel.mesh.Mesh) `bk`/`b_ok` are sequences of
    per-shard tensors whose bitsets OR-merge across the shards (pmax) —
    the global-RF collective."""
    if bits & (bits - 1):
        raise ValueError("bloom bit count must be a power of 2")
    if axis is not None:
        return axis.pmax([bloom_build_bitset(k, ok, bits)
                          for k, ok in zip(bk, b_ok)])
    h1 = mix64(bk)
    h2 = mix64(h1 ^ _BLOOM_SALT)
    i1 = torch.where(b_ok, h1 & (bits - 1), bits)
    i2 = torch.where(b_ok, h2 & (bits - 1), bits)
    bitset = scatter_set(bits, i1, 1, 0, torch.uint8)
    bitset = torch.maximum(bitset, scatter_set(bits, i2, 1, 0, torch.uint8))
    return bitset


def bloom_probe_bitset(bitset, pk, p_ok):
    """Probe-side half: a row survives iff BOTH of its key's bloom probes
    are set — never a false negative; collisions only keep extra rows,
    which the join itself re-verifies."""
    bits = bitset.shape[0]
    h1 = mix64(pk)
    h2 = mix64(h1 ^ _BLOOM_SALT)
    g1 = bitset[h1 & (bits - 1)]
    g2 = bitset[h2 & (bits - 1)]
    return p_ok & (pk != _I64MAX) & (g1 == 1) & (g2 == 1)


def bloom_filter_mask(probe: Chunk, build: Chunk, probe_keys, build_keys,
                      bit_widths=None, axis=None, bits: int = 1 << 20):
    """Bloom-bitset runtime filter: near-exact membership for ANY key range,
    on the SAME packed keys the join compares. With `axis` the per-shard
    build bitsets OR-merge across the mesh first (runtime_filter_mask's
    placements). INNER/LEFT SEMI only."""
    if axis is None:
        pk, p_ok, bk, b_ok = pack_key_pair(
            probe, build, probe_keys, build_keys, bit_widths)
        return bloom_probe_bitset(bloom_build_bitset(bk, b_ok, bits), pk, p_ok)
    packed = [pack_key_pair(p, b, probe_keys, build_keys, bit_widths)
              for p, b in _shard_pairs(probe, build)]
    bitset = bloom_build_bitset([k[2] for k in packed],
                                [k[3] for k in packed], bits, axis)
    return _per_probe(probe, [
        bloom_probe_bitset(axis.to(bitset, pk.device), pk, p_ok)
        for pk, p_ok, _, _ in packed])


def dense_semi_anti_mask(probe: Chunk, build: Chunk, probe_keys, build_keys,
                         dense_range, anti: bool):
    """EXACT SEMI/ANTI join as one presence-bitmap test for a stats-bounded
    single key. NULL probe keys never match (kept by ANTI, dropped by SEMI)."""
    pk, p_ok, bk, b_ok = pack_key_pair(probe, build, probe_keys, build_keys)
    lo, hi = dense_range
    size = int(hi - lo + 1)
    present = _presence(bk, b_ok, lo, size)
    idx = pk - lo
    in_range = (idx >= 0) & (idx < size)
    member = p_ok & in_range & (present[idx.clamp(0, size - 1)] == 1)
    return ~member if anti else member


def _merge_schemas(left: Chunk, right: Chunk, right_names) -> tuple:
    lnames = set(left.schema.names)
    out_fields = list(left.schema.fields)
    for n in right_names:
        f = right.schema.field(n)
        if n in lnames:
            raise ValueError(f"duplicate output column {n!r} in join")
        out_fields.append(f)
    return tuple(out_fields)


def hash_probe_rows(bk, pk, bcap: int, p_ok):
    """Open-addressing hash-table build+probe (`SET join_probe_strategy =
    'pallas'`): replaces the build sort + searchsorted with the kernel pair
    of ops/kernels.py. NULL/dead rows on both sides carry the int64-max
    sentinel, which doubles as the table's empty-slot marker, so they never
    insert and never match. Returns (match [P] bool, build_row [P] clipped)."""
    table_size = 1 << (max(2 * bcap, 16) - 1).bit_length()
    tkey, trow = kernels.hash_build(bk.contiguous(), table_size)
    row = kernels.hash_probe(tkey, trow, pk.contiguous())
    match = (row >= 0) & p_ok & (pk != _I64MAX)
    return match, row.to(torch.int64).clamp(0, bcap - 1)


def _probe_strategy() -> str:
    from ..runtime.config import config as _cfg

    s = _cfg.get("join_probe_strategy")
    if s not in ("auto", "pallas", "pallas_sorted"):
        raise ValueError(f"join_probe_strategy={s!r}: expected auto | "
                         "pallas | pallas_sorted")
    return s


def _probe_searchsorted(bk_sorted, pk, strategy: str):
    """The unique-join probe's lower bound: the hand-written kernel under
    `join_probe_strategy = 'pallas_sorted'` (ops/kernels.probe_searchsorted;
    its plain torch ladder on CPU tensors), torch.searchsorted otherwise."""
    if strategy == "pallas_sorted":
        return kernels.probe_searchsorted(bk_sorted.contiguous(),
                                          pk.contiguous())
    return torch.searchsorted(bk_sorted, pk)


def hash_join_unique(probe: Chunk, build: Chunk, probe_keys, build_keys,
                     join_type: str = INNER, payload=None, bit_widths=None,
                     build_order=None):
    """Join where build keys are unique (validated by planner/caller).

    Output chunk has probe's capacity: probe columns + gathered build payload.
    """
    payload = list(payload if payload is not None else build.schema.names)
    pk, p_ok, bk, _b_ok = pack_key_pair(
        probe, build, probe_keys, build_keys, bit_widths
    )  # build NULL/dead rows pack to the sentinel
    bcap = build.capacity

    strategy = _probe_strategy()
    if strategy == "pallas":
        # sort-free path: the open-addressing table (the cached build_order,
        # a sort artifact, is simply unused here)
        match, build_row = hash_probe_rows(bk, pk, bcap, p_ok)
        return _unique_join_epilogue(
            probe, build, payload, match, build_row, join_type)

    order = build_order if build_order is not None else argsort_stable(bk)
    bk_sorted = bk[order]
    pos = _probe_searchsorted(bk_sorted, pk, strategy)
    pos_c = pos.to(torch.int64).clamp(0, bcap - 1)
    match = (bk_sorted[pos_c] == pk) & p_ok & (pk != _I64MAX)
    build_row = order[pos_c]
    return _unique_join_epilogue(
        probe, build, payload, match, build_row, join_type)


def _unique_join_epilogue(probe, build, payload, match, build_row, join_type):
    """Shared tail of the 1:N join kernels (sorted, hash table, LUT): gather
    the build payload by matched row, NULL-mask non-matches for LEFT OUTER,
    and apply the join-type selection semantics at probe capacity."""
    data = list(probe.data)
    valid = list(probe.valid)
    for n in payload:
        i = build.schema.index(n)
        d = build.data[i][build_row]
        v = build.valid[i]
        v = None if v is None else v[build_row]
        if join_type == LEFT_OUTER:
            # non-matching rows carry NULL build columns
            v = match if v is None else (v & match)
        data.append(d)
        valid.append(v)

    sel = probe.sel_mask()
    if join_type == INNER:
        sel = sel & match
    elif join_type == LEFT_SEMI:
        return probe.and_sel(match)
    elif join_type == LEFT_ANTI:
        return probe.and_sel(~match)
    elif join_type != LEFT_OUTER:
        raise NotImplementedError(join_type)
    out_fields = _merge_schemas(probe, build, payload)
    return Chunk(Schema(out_fields), tuple(data), tuple(valid), sel,
                 probe.device)


def hash_join_lut(probe: Chunk, build: Chunk, probe_keys, build_keys,
                  lo: int, size: int, join_type: str = INNER, payload=None):
    """Direct-addressing join for a unique build side whose (single) key
    range is bounded by catalog stats: build rows scatter into a dense
    row-lookup table indexed by key-lo, probes gather their match in O(1)
    (the reference's DirectMappingJoinHashMap analog)."""
    payload = list(payload if payload is not None else build.schema.names)
    pk, p_ok, bk, b_ok = pack_key_pair(probe, build, probe_keys, build_keys)

    # dead/NULL build rows land in the spill slot (dropped)
    idxb = torch.where(b_ok, bk - lo, size)
    rows = torch.arange(build.capacity, dtype=torch.int32, device=bk.device)
    lut = scatter_set(size, idxb, rows, -1, torch.int32)
    idxp = pk - lo
    in_range = p_ok & (idxp >= 0) & (idxp < size)
    row = lut[idxp.clamp(0, size - 1)]
    match = in_range & (row >= 0)
    build_row = row.to(torch.int64).clamp(0, build.capacity - 1)
    return _unique_join_epilogue(
        probe, build, payload, match, build_row, join_type)


def repeat_rows(counts: torch.Tensor, out_capacity: int) -> torch.Tensor:
    """jnp.repeat(arange(len(counts)), counts, total_repeat_length=L):
    row i repeated counts[i] times, cut at L; slots past the total repeat
    the last row. Computed without a host sync (no data-dependent shape)."""
    n = counts.shape[0]
    starts = torch.cumsum(counts, 0) - counts  # exclusive prefix sums
    ind = torch.zeros((out_capacity + 1,), dtype=torch.int64,
                      device=counts.device)
    ind.index_add_(0, starts.clamp(max=out_capacity),
                   torch.ones((n,), dtype=torch.int64, device=counts.device))
    return torch.cumsum(ind[:out_capacity], 0) - 1


def hash_join_expand(probe: Chunk, build: Chunk, probe_keys, build_keys,
                     out_capacity: int, join_type: str = INNER, payload=None,
                     bit_widths=None, build_order=None):
    """General join allowing duplicate build keys.

    Expands matches by run-length: for probe row r matching build run
    [start_r, end_r), emits (r, start_r + j) pairs. Static out_capacity with
    true output size returned for host overflow handling.
    Returns (chunk, true_rows).
    """
    payload = list(payload if payload is not None else build.schema.names)
    pk, p_ok, bk, _b_ok = pack_key_pair(
        probe, build, probe_keys, build_keys, bit_widths
    )  # build NULL/dead rows pack to the sentinel
    dev = probe.device

    order = build_order if build_order is not None else argsort_stable(bk)
    bk_sorted = bk[order]
    bcap = build.capacity

    probe_ok = p_ok & (pk != _I64MAX)
    start = torch.searchsorted(bk_sorted, pk, side="left")
    end = torch.searchsorted(bk_sorted, pk, side="right")
    counts = torch.where(probe_ok, end - start, 0)

    if join_type == LEFT_SEMI:
        out = probe.and_sel(counts > 0)
        return out, out.num_rows()
    if join_type == LEFT_ANTI:
        out = probe.and_sel(counts == 0)
        return out, out.num_rows()
    if join_type == LEFT_OUTER:
        counts = torch.where(probe.sel_mask() & (counts == 0), 1, counts)
    elif join_type != INNER:
        raise NotImplementedError(join_type)

    total = counts.sum()
    probe_rows = repeat_rows(counts, out_capacity)
    # offset of each output slot within its probe row's run
    run_start = torch.cumsum(counts, 0) - counts
    slots = torch.arange(out_capacity, device=dev)
    offs = slots - run_start[probe_rows]
    build_pos = (start[probe_rows] + offs).clamp(0, bcap - 1)
    build_row = order[build_pos]
    out_live = slots < total
    if join_type == LEFT_OUTER:
        # a NULL-key probe row must not "match" the build side's sentinel
        # run, so its payload stays NULL
        had_match = (probe_ok & ((end - start) > 0))[probe_rows]
    else:
        had_match = torch.ones((out_capacity,), dtype=torch.bool, device=dev)

    taken = probe.take(probe_rows)
    data = list(taken.data)
    valid = list(taken.valid)
    out_fields = _merge_schemas(probe, build, payload)
    for n in payload:
        i = build.schema.index(n)
        d = build.data[i][build_row]
        v = build.valid[i]
        v = None if v is None else v[build_row]
        if join_type == LEFT_OUTER:
            v = had_match if v is None else (v & had_match)
        data.append(d)
        valid.append(v)
    sel = out_live if taken.sel is None else (out_live & taken.sel)
    return (Chunk(Schema(out_fields), tuple(data), tuple(valid), sel, dev),
            total)
