"""Python scalar UDFs, called on the host from the expression compiler.

Reference behavior: be/src/exprs/udf/python/ (Python UDFs executed out of
process over Arrow batches) and the CREATE FUNCTION DDL
(fe sql/ast/CreateFunctionStmt.java). The JAX package runs the body through
`jax.pure_callback` mid-program; the port evaluates eagerly, so the same
design is a direct host call: per call site and run, ONE device-to-host
copy of the arguments and the live mask, the Python body per live row, and
ONE host-to-device copy of the result. The host seconds add up in
`udf_seconds()` (the profile's `udf_s`).

Semantics (the reference's):
- strict NULLs: the result is NULL where any argument is NULL, and the
  Python body may also return None for a NULL result;
- string arguments arrive as Python str (dictionary codes decode against
  the plan-time dictionary);
- return types: numeric / boolean / date (strings would need a
  data-dependent output dictionary).

The registry is process-wide, like the single shared catalog; every
create/drop bumps `registry_epoch()`, which keys the executor's plan cache
so a redefined function is never served from a stale plan.
"""

from __future__ import annotations

import dataclasses
import datetime
import threading
import time

import numpy as np
import torch

from .. import types as T


@dataclasses.dataclass
class UdfDef:
    name: str
    params: tuple  # tuple[(name, LogicalType)]
    ret: T.LogicalType
    fn: object  # the compiled python callable
    source: str


_REGISTRY: dict = {}
_EPOCH: int = 0
_UDF_SECONDS = threading.local()


def registry_epoch() -> int:
    return _EPOCH


def udf_seconds() -> float:
    """Host seconds this thread has spent in UDF bodies (and their copies)."""
    return getattr(_UDF_SECONDS, "s", 0.0)


def create_udf(name: str, params, ret: T.LogicalType, source: str,
               replace: bool = False):
    key = name.lower()
    if key in _REGISTRY and not replace:
        raise ValueError(f"function {name!r} already exists")
    if ret.is_string or ret.is_wide:
        raise NotImplementedError(
            f"UDF return type {ret!r} not supported (needs a data-dependent "
            "output dictionary; return numerics/bool/date)")
    ns: dict = {}
    exec(source, ns)  # noqa: S102 — UDF bodies are operator-provided code
    fn = ns.get(name)
    if fn is None:
        # accept a single unambiguous callable under a different name;
        # multiple candidates would bind an arbitrary one silently
        cands = [v for k, v in ns.items() if callable(v)
                 and not k.startswith("__")]
        fn = cands[0] if len(cands) == 1 else None
    if not callable(fn):
        raise ValueError(
            f"UDF source must define a function named {name!r}")
    _REGISTRY[key] = UdfDef(key, tuple(params), ret, fn, source)
    global _EPOCH
    _EPOCH += 1
    return _REGISTRY[key]


def drop_udf(name: str, if_exists: bool = False):
    if _REGISTRY.pop(name.lower(), None) is None and not if_exists:
        raise ValueError(f"unknown function {name!r}")
    global _EPOCH
    _EPOCH += 1


def get_udf(name: str):
    return _REGISTRY.get(name.lower())


def list_udfs():
    return sorted(_REGISTRY)


_EPOCH_DAY = datetime.date(1970, 1, 1)
_EPOCH_US = datetime.datetime(1970, 1, 1)


def _decoder(t: T.LogicalType, d):
    """Host value of one argument cell of type `t` (dict `d` for strings)."""
    if t.is_string and d is not None:
        vals = d.values
        return lambda c: str(vals[int(c)])
    if t.is_decimal:
        scale = 10 ** t.scale
        return lambda x: int(x) / scale
    if t.is_float:
        return float
    if t.kind is T.TypeKind.BOOLEAN:
        return bool
    if t.kind is T.TypeKind.DATE:
        return lambda v: _EPOCH_DAY + datetime.timedelta(days=int(v))
    if t.kind is T.TypeKind.DATETIME:
        return lambda us: _EPOCH_US + datetime.timedelta(microseconds=int(us))
    return int


def _encoder(ret: T.LogicalType):
    """Stored value of one Python result of type `ret`."""
    if ret.kind is T.TypeKind.DATE:
        return lambda v: ((v - _EPOCH_DAY).days
                          if isinstance(v, datetime.date) else v)
    if ret.kind is T.TypeKind.DATETIME:
        return lambda v: ((v - _EPOCH_US) // datetime.timedelta(microseconds=1)
                          if isinstance(v, datetime.datetime) else v)
    if ret.is_decimal:
        rs = 10 ** ret.scale
        return lambda v: int(round(float(v) * rs))
    return lambda v: v


def _i64_bits(d: torch.Tensor) -> torch.Tensor:
    if d.is_floating_point():
        return d.to(torch.float64).view(torch.int64)
    return d.to(torch.int64)


def eval_udf(cc, udef: UdfDef, args):
    """Evaluate a UDF call over the compiler's chunk on the host."""
    from ..exprs.compile import EVal, _and_valid, as_tensor
    from .lifecycle import checkpoint

    # the host round trip below is a stage of its own: a KILL or deadline
    # lands before it, in every loop that evaluates expressions
    checkpoint("udf::eval")
    if len(args) != len(udef.params):
        raise TypeError(
            f"{udef.name} takes {len(udef.params)} arguments, "
            f"got {len(args)}")
    t0 = time.perf_counter()
    cap, dev = cc.chunk.capacity, cc.device
    datas = [as_tensor(0 if isinstance(a.data, str) else a.data,
                       a.type.dtype, dev).expand(cap) for a in args]
    decoders = []
    for a in args:
        if a.type.is_string and isinstance(a.data, str):
            s = a.data
            decoders.append(lambda _c, s=s: s)
        else:
            decoders.append(_decoder(a.type, a.dict))
    all_valid = _and_valid(*[a.valid for a in args])
    sel = cc.chunk.sel_mask()
    mask = sel if all_valid is None else (sel & all_valid.expand(cap))
    # one device-to-host copy of the mask and the arguments, as int64 rows
    # (float arguments travel as their float64 bit patterns)
    host = torch.stack([mask.to(torch.int64)]
                       + [_i64_bits(d) for d in datas]).cpu().numpy()
    ok = host[0].astype(bool)
    cols = [h.view(np.float64) if d.is_floating_point() else h
            for d, h in zip(datas, host[1:])]
    out = np.zeros(cap, dtype=udef.ret.np_dtype)
    encode = _encoder(udef.ret)
    fn = udef.fn
    for i in np.nonzero(ok)[0]:
        v = fn(*[dec(col[i]) for dec, col in zip(decoders, cols)])
        if v is None:
            ok[i] = False
        else:
            out[i] = encode(v)
    # one host-to-device copy of the result and its validity
    res = torch.from_numpy(out).to(dev)
    okd = torch.from_numpy(ok).to(dev)
    _UDF_SECONDS.s = udf_seconds() + time.perf_counter() - t0
    valid = okd if all_valid is None else (okd & all_valid)
    return EVal(res, valid, udef.ret)
