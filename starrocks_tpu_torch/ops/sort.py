"""ORDER BY / TopN / LIMIT operators.

Reference behavior: be/src/exec/chunks_sorter.h:44 (full sort) and
chunks_sorter_topn.h:26 (heap TopN). The JAX package's design, unchanged:

- packed-key sort: bounded keys (dict codes, bools, stats-bounded ints)
  encode into ONE order-preserving int64 (descending via complement, NULLS
  FIRST/LAST via a sentinel bit per nullable key, dead rows -> INT64_MAX),
  so the multi-operand lexsort collapses to a single stable sort;
- threshold TopN: ORDER BY .. LIMIT k over a packed key runs a partial
  select — a stable top-k, or the per-block selection kernel of
  ops/kernels.py behind `SET topn_strategy='pallas'` — and the output
  capacity SHRINKS to ~k.

Row order is part of the answer after ORDER BY .. LIMIT, so every sort here
is stable and breaks ties by the lower row index, as jnp.argsort,
jnp.lexsort and lax.top_k do.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from ..column.column import Chunk, pad_capacity
from . import kernels
from .common import argsort_stable, eval_keys, lexsort
from .dec128 import cmp_limbs

_I64MAX = (1 << 63) - 1

# threshold top-N only pays while k stays far below the input size; past
# this the full packed sort is at least as good
TOPN_MAX_K = 4096


def sort_operands(keys, sort_keys) -> list:
    """lexsort operand list (least-significant first, WITHOUT the liveness
    operand) for evaluated sort keys."""
    ops = []
    for k, (_, asc, nulls_first) in zip(reversed(keys),
                                        reversed(list(sort_keys))):
        if k.type.is_decimal128:
            for limb in reversed(cmp_limbs(k.data)):  # ls-first operands
                ops.append(limb if asc else (0xFFFFFFFF - limb))
            if k.valid is not None:
                ops.append((k.valid if nulls_first else ~k.valid).to(torch.int8))
            continue
        d = k.data
        if d.dtype == torch.bool:
            d = d.to(torch.int8)
        ops.append(d if asc else -d)
        if k.valid is not None:
            # the flag is more significant than the value (appended later);
            # ascending sort puts 0 first, so: nulls_first -> valid flag
            ops.append((k.valid if nulls_first else ~k.valid).to(torch.int8))
    return ops


def packed_order_key(keys, sort_keys, live):
    """ONE order-preserving int64 per row encoding (live-first, key order),
    or None when a key is unbounded / the widths overflow 62 bits."""
    from ..runtime.config import config as _cfg

    if not keys or not _cfg.get("enable_packed_sort_keys"):
        return None
    from .aggregate import _key_domain

    parts = []
    total_bits = 0
    for k, (_, asc, nulls_first) in zip(keys, sort_keys):
        dom = _key_domain(k)
        if dom is None:
            return None
        base, lo = dom
        base = max(int(base), 1)
        w = max((base - 1).bit_length(), 1)
        code = (k.data.to(torch.int64) - lo).clamp(0, base - 1)
        if not asc:
            code = (base - 1) - code
        if k.valid is not None:
            # sentinel bit above the value bits: NULLs form one block at
            # the requested end, value bits of NULL rows zero out
            null_bit = 0 if nulls_first else 1
            bit = torch.where(k.valid, 1 - null_bit, null_bit).to(torch.int64)
            code = torch.where(k.valid, code, 0) | (bit << w)
            w += 1
        parts.append((code, w))
        total_bits += w
        if total_bits > 62:
            return None
    packed = torch.zeros((live.shape[0],), dtype=torch.int64,
                         device=live.device)
    for code, w in parts:
        packed = (packed << w) | code
    return torch.where(live, packed, _I64MAX)


def first_kk_desc(x, kk: int):
    """The first kk indices of a stable descending sort of `x` ([N] int64):
    value descending, then index ascending — what the reference's
    lax.top_k returns. Only the rows at or above a threshold are sorted,
    and the threshold is at most the kk-th largest value: the first kk
    all lie there, and the compaction keeps index order, so ties come out
    as the full sort has them. Where `x` has at least kk blocks of 1024
    rows, the kk-th largest block maximum is such a threshold (kk blocks
    hold a row at or above it) and costs one pass over `x`; else the
    kk-th largest value itself. torch.topk gives the threshold only; its
    order of ties is unspecified."""
    n = x.shape[0]
    if kk >= n:
        return torch.sort(x, descending=True, stable=True).indices[:kk]
    if n % 1024 == 0 and n // 1024 >= kk:
        top = torch.topk(x.view(-1, 1024).amax(dim=1), kk, sorted=False)
    else:
        top = torch.topk(x, kk, sorted=False)
    pos = torch.nonzero(x >= top.values.min()).flatten()
    return pos[torch.sort(x[pos], descending=True,
                          stable=True).indices[:kk]]


def topn_order(packed, kk: int):
    """Indices of the kk smallest packed keys, ascending, stable on ties
    (lower index first). `~packed` reverses int64 order exactly."""
    from ..runtime.config import config as _cfg

    neg = ~packed
    strategy = _cfg.get("topn_strategy")
    if strategy == "pallas" and packed.shape[0] % 1024 == 0 and kk <= 1024:
        with record_function("topn::select"):
            cv, ci = kernels.topn_select(neg.contiguous(), kk)
        # the candidates lie in block order, each block in (value desc,
        # row asc) order, so candidate order is row order on ties
        with record_function("topn::reduce"):
            return ci[first_kk_desc(cv, kk)].to(torch.int64)
    with record_function("topn::reduce"):
        return first_kk_desc(neg, kk)


def sort_chunk(chunk: Chunk, sort_keys, limit: int | None = None,
               counters: dict | None = None) -> Chunk:
    """sort_keys: tuple of (expr, asc: bool, nulls_first: bool).

    Dead rows always sort last; output sel marks the first n (or limit) rows.
    With a packable key and a small LIMIT the output capacity SHRINKS to
    ~pad_capacity(limit). `counters` (when given) receives device scalars the
    executor turns into profile counters ('topn_rows_pruned')."""
    cap = chunk.capacity
    dev = chunk.device
    live = chunk.sel_mask()
    keys = eval_keys(chunk, tuple(e for e, _, _ in sort_keys))
    n = live.sum(dtype=torch.int64)

    from ..runtime.config import config as _cfg

    strategy = _cfg.get("topn_strategy")
    if strategy not in ("auto", "lexsort", "pallas"):
        raise ValueError(f"unknown topn_strategy {strategy!r}")
    with record_function("sort::pack"):
        packed = None if strategy == "lexsort" else packed_order_key(
            keys, sort_keys, live)
    if packed is not None:
        if (limit is not None and 0 < limit <= TOPN_MAX_K
                and pad_capacity(limit) < cap):
            kk = pad_capacity(limit)
            order = topn_order(packed, kk)
            with record_function("topn::gather"):
                out = chunk.take(order)
            k = torch.clamp(n, max=limit)
            if counters is not None:
                counters["topn_rows_pruned"] = torch.clamp(n - limit, min=0)
            return out.with_sel(torch.arange(kk, device=dev) < k)
        order = argsort_stable(packed)
    else:
        ops = sort_operands(keys, sort_keys)
        ops.append((~live).to(torch.int8))  # live rows first
        order = lexsort(ops)

    out = chunk.take(order)
    k = n if limit is None else torch.clamp(n, max=limit)
    return out.with_sel(torch.arange(cap, device=dev) < k)


def limit_chunk(chunk: Chunk, limit: int, offset: int = 0) -> Chunk:
    """Keep `limit` live rows after skipping `offset` (row order = physical)."""
    live = chunk.sel_mask()
    rank = torch.cumsum(live, 0) - 1  # rank among live rows
    keep = live & (rank >= offset) & (rank < offset + limit)
    return chunk.with_sel(keep)
