"""Expression compiler: IR -> torch ops over a Chunk.

Reference behavior: be/src/exprs/ (vectorized evaluators). The JAX package
evaluates an Expr tree at jit-trace time into XLA ops; the port evaluates it
eagerly into torch ops on the chunk's device. The value rules are the JAX
package's, function for function: the same types, the same decimal rescale
rules, the same 3-valued NULL logic, the same dictionary tricks for strings.

Evaluation value: EVal(data, valid, type, dict, bounds)
- data: tensor [capacity], a 0-d tensor, or a host scalar for literals
  (int/float/bool/str — broadcast where an operator needs a column)
- valid: bool tensor | None (None = never NULL)
- type: LogicalType
- dict: StringDict | None for VARCHAR values

The port registers the reference compiler's 51 core functions, and
`nullif` of its function waves: the arithmetic (scaled DECIMAL(18) and
128-bit DECIMAL(38) limbs, `ops/dec128.py`), comparisons (dictionary
codes for strings), AND/OR/NOT with 3-valued NULLs, NULL tests,
CASE/IF/COALESCE, IN lists, the date parts and date arithmetic, the string
functions as dictionary LUTs and remaps (LIKE, substr, upper, trim,
replace, concat of one column, length, ...) and the maths functions.
Anything else raises: the parser builds a registry call only for names
registered in `_FUNCTIONS`, and the compiler raises KeyError for any other
call. String-valued CASE, IF and COALESCE raise NotImplementedError (the
reference returns dictionary codes there, or fails), and so do string
casts. Negating a DECIMAL(38) value and its absolute value are two's
complement limb operations here; the reference negates each limb.
"""

from __future__ import annotations

import dataclasses
import datetime
import decimal
import re
from typing import Optional

import numpy as np
import torch

from .. import types as T
from ..column.column import Chunk
from ..column.dict_encoding import StringDict
from ..column.host_table import _int_to_dec128
from .ir import AggExpr, Call, Case, Cast, Col, Expr, InList, Lit


@dataclasses.dataclass
class EVal:
    data: object
    valid: Optional[torch.Tensor]
    type: T.LogicalType
    dict: Optional[StringDict] = None
    # static (lo, hi) value bounds known at plan time (from catalog stats),
    # propagated through a few closed-form functions; None = unbounded
    bounds: Optional[tuple] = None


def _and_valid(*valids):
    out = None
    for v in valids:
        if v is None:
            continue
        out = v if out is None else (out & v)
    return out


def div_scalar(x: torch.Tensor, s) -> torch.Tensor:
    """x / s, correctly rounded on every device. CUDA divides a float
    tensor by a host scalar as x * (1 / s), up to an ulp off the quotient
    the CPU (and XLA) give, which reorders rows that an ORDER BY on such a
    value ties; a 0-d divisor on x's device takes the true division."""
    return x / torch.full((), s, dtype=x.dtype, device=x.device)


def as_tensor(x, dtype: torch.dtype, device) -> torch.Tensor:
    """`x` (a tensor or a host scalar) as a tensor of `dtype` on `device`:
    the port's `jnp.asarray(x, dtype)`. Float to int truncates, as JAX's
    conversion does."""
    if isinstance(x, torch.Tensor):
        return x if x.dtype == dtype else x.to(dtype)
    return torch.tensor(x, dtype=dtype, device=device)


# --- literal handling -------------------------------------------------------


def _infer_lit(value, ltype: T.LogicalType | None) -> tuple:
    """Returns (host_value, LogicalType). Dates given as 'YYYY-MM-DD' strings
    with an explicit DATE type, or via date literal auto-detection."""
    if ltype is not None and ltype.kind is T.TypeKind.DATE and isinstance(value, str):
        d = datetime.date.fromisoformat(value)
        return (d - datetime.date(1970, 1, 1)).days, ltype
    if ltype is not None and ltype.kind is T.TypeKind.DATETIME and isinstance(value, str):
        dt = datetime.datetime.fromisoformat(value.replace(" ", "T"))
        us = (dt - datetime.datetime(1970, 1, 1)) // datetime.timedelta(microseconds=1)
        return us, ltype
    if value is None:
        # typed or not, a NULL literal is NULL; callers branch on value None
        return 0, T.NULLTYPE
    if isinstance(value, bool):
        return value, ltype or T.BOOLEAN
    if isinstance(value, int):
        if ltype is not None and ltype.is_decimal:
            return value * 10 ** ltype.scale, ltype
        if abs(value) >= (1 << 63):
            # beyond int64: the literal rides as DECIMAL128 limbs
            return _int_to_dec128(value), T.DECIMAL(38, 0)
        return value, ltype or T.BIGINT
    if isinstance(value, float):
        if ltype is not None and ltype.is_decimal:
            return int(round(value * 10 ** ltype.scale)), ltype
        return value, ltype or T.DOUBLE
    if isinstance(value, decimal.Decimal):
        if ltype is not None and ltype.is_decimal:
            return int(value.scaleb(ltype.scale,
                                    decimal.Context(prec=60))), ltype
        exp = -value.as_tuple().exponent
        s = max(int(exp), 0)
        unscaled = int(value.scaleb(s, decimal.Context(prec=60)))
        if abs(unscaled) >= (1 << 63):
            # beyond int64/float64 exactness: carry the literal as
            # DECIMAL128 limbs so dec128 comparisons stay exact
            return _int_to_dec128(unscaled), T.DECIMAL(38, s)
        return float(value), ltype or T.DOUBLE
    if isinstance(value, datetime.date):
        return (value - datetime.date(1970, 1, 1)).days, T.DATE
    if isinstance(value, str):
        # bare string literal; typed when it meets a dict column
        return value, ltype or T.VARCHAR
    raise TypeError(f"unsupported literal {value!r}")


_DATE_RE = re.compile(r"^\d{4}-\d{2}-\d{2}$")
_DATETIME_RE = re.compile(r"^\d{4}-\d{2}-\d{2}[ T]\d{2}:\d{2}(:\d{2}(\.\d+)?)?$")


def _lit_as_date_if_str(v: EVal) -> EVal:
    """Promote 'YYYY-MM-DD' / 'YYYY-MM-DD HH:MM[:SS]' string literals to
    DATE / DATETIME. Callers apply this only in TEMPORAL context (the other
    operand is a date/datetime) so ordinary string comparisons are untouched;
    unparseable look-alikes fall through unchanged."""
    if v.type.is_string and isinstance(v.data, str):
        if _DATE_RE.match(v.data):
            try:
                d = datetime.date.fromisoformat(v.data)
            except ValueError:
                return v
            return EVal((d - datetime.date(1970, 1, 1)).days, v.valid, T.DATE)
        if _DATETIME_RE.match(v.data):
            try:
                dt = datetime.datetime.fromisoformat(v.data.replace(" ", "T"))
            except ValueError:
                return v
            us = (dt - datetime.datetime(1970, 1, 1)) // datetime.timedelta(
                microseconds=1
            )
            return EVal(us, v.valid, T.DATETIME)
    if v.type.is_string and v.dict is not None:
        raise NotImplementedError(
            "string columns in temporal context are not in the port yet")
    return v


def _promote_temporal_literals(a: EVal, b: EVal):
    """Context coercion: string literals become dates/datetimes only when the
    OTHER operand is temporal (never hijack string-vs-string comparisons)."""
    if b.type.is_temporal:
        a = _lit_as_date_if_str(a)
    if a.type.is_temporal:
        b = _lit_as_date_if_str(b)
    return a, b


# --- numeric coercion -------------------------------------------------------


def _to_numeric(v: EVal, target: T.LogicalType, device) -> torch.Tensor:
    """Cast v.data to target's representation (handles decimal rescale and
    temporal unit conversion)."""
    if v.type.is_decimal128 and target.is_float:
        f = d128.to_f64(as_tensor(v.data, torch.int64, device))
        return div_scalar(f, 10 ** v.type.scale).to(target.dtype)
    if v.type.is_decimal128 and target.is_decimal128:
        if target.scale < v.type.scale:
            raise NotImplementedError("DECIMAL128 downscale cast")
        return d128.rescale(as_tensor(v.data, torch.int64, device),
                            target.scale - v.type.scale)
    if target.is_decimal128:
        return _to_dec128(v, target.scale or 0, device)
    if v.type.is_decimal128:
        # the reference reads the limbs as one int64 column here
        raise NotImplementedError(f"{v.type!r} to {target!r} casts")
    if v.type.kind is T.TypeKind.DATE and target.kind is T.TypeKind.DATETIME:
        return as_tensor(v.data, torch.int64, device) * 86_400_000_000
    if v.type.kind is T.TypeKind.DATETIME and target.kind is T.TypeKind.DATE:
        return (as_tensor(v.data, torch.int64, device)
                // 86_400_000_000).to(torch.int32)
    if v.type.is_decimal and target.is_decimal:
        d = as_tensor(v.data, torch.int64, device)
        if v.type.scale < target.scale:
            d = d * (10 ** (target.scale - v.type.scale))
        elif v.type.scale > target.scale:
            d = d // (10 ** (v.type.scale - target.scale))
        return d
    if v.type.is_decimal and target.is_float:
        return div_scalar(as_tensor(v.data, target.dtype, device),
                          10 ** v.type.scale)
    if (not v.type.is_decimal) and target.is_decimal:
        return as_tensor(v.data, torch.int64, device) * (10 ** target.scale)
    return as_tensor(v.data, target.dtype, device)


def _common(a: EVal, b: EVal) -> T.LogicalType:
    if a.type.is_temporal or b.type.is_temporal:
        if a.type.kind == b.type.kind:
            return a.type
        if {a.type.kind, b.type.kind} == {T.TypeKind.DATE, T.TypeKind.DATETIME}:
            return T.DATETIME
        raise TypeError(f"cannot compare {a.type} and {b.type}")
    if a.type.is_string and b.type.is_string:
        return T.VARCHAR
    if a.type.kind is T.TypeKind.BOOLEAN and b.type.kind is T.TypeKind.BOOLEAN:
        return T.BOOLEAN
    return T.common_numeric_type(a.type, b.type)


# --- the compiler -----------------------------------------------------------


class ExprCompiler:
    """Compiles Expr trees against one Chunk. Stateless; cheap to construct."""

    def __init__(self, chunk: Chunk):
        self.chunk = chunk
        self.device = chunk.device

    def eval(self, e: Expr) -> EVal:
        if isinstance(e, Col):
            data, valid = self.chunk.col(e.name)
            f = self.chunk.field(e.name)
            return EVal(data, valid, f.type, f.dict, bounds=f.bounds)
        if isinstance(e, Lit):
            hv, lt = _infer_lit(e.value, e.type)
            if lt.kind is T.TypeKind.NULL:
                return EVal(
                    torch.tensor(0, dtype=torch.int32, device=self.device),
                    torch.zeros((self.chunk.capacity,), dtype=torch.bool,
                                device=self.device),
                    lt,
                )
            if lt.is_decimal128:  # [4] limbs
                hv = torch.tensor(hv, dtype=torch.int64, device=self.device)
            # literals stay host scalars (strings and numbers alike);
            # compute sites coerce them with as_tensor where needed
            return EVal(hv, None, lt)
        if isinstance(e, Cast):
            return self._cast(self.eval(e.arg), e.to)
        if isinstance(e, Case):
            return self._case(e)
        if isinstance(e, InList):
            return self._in_list(e)
        if isinstance(e, Call):
            fn = _FUNCTIONS.get(e.fn)
            if fn is None:
                raise KeyError(f"unknown function {e.fn!r} (not in the port)")
            return fn(self, *[self.eval(a) for a in e.args])
        if isinstance(e, EVal):
            return e  # pre-evaluated argument (cc.call composition)
        if isinstance(e, AggExpr):
            raise TypeError("aggregate expression in scalar context")
        raise TypeError(f"cannot evaluate {e!r}")

    def call(self, name: str, *vals):
        """Invoke a registered builtin on already-evaluated EVals."""
        f = _FUNCTIONS.get(name)
        if f is None:
            raise KeyError(f"unknown function {name!r} (not in the port)")
        return f(self, *[v for v in vals if v is not None])

    def eval_predicate(self, e: Expr) -> torch.Tensor:
        """Boolean mask for filters: NULL -> False (SQL WHERE semantics)."""
        v = self.eval(e)
        if v.type.kind is not T.TypeKind.BOOLEAN:
            raise TypeError(f"predicate has type {v.type}")
        m = as_tensor(v.data, torch.bool, self.device).expand(
            self.chunk.capacity)
        if v.valid is not None:
            m = m & v.valid
        return m

    # --- casts --------------------------------------------------------------
    def _cast(self, v: EVal, to: T.LogicalType) -> EVal:
        if v.type == to:
            return v
        if v.type.is_string and not to.is_string:
            raise NotImplementedError("string->x casts not supported on device")
        if to.is_string:
            raise NotImplementedError("x->string casts not supported on device")
        # DATE<->DATETIME conversion is handled inside _to_numeric
        return EVal(_to_numeric(v, to, self.device), v.valid, to)

    # --- CASE ---------------------------------------------------------------
    def _case(self, e: Case) -> EVal:
        branches = [(self.eval(c), self.eval(v)) for c, v in e.whens]
        orelse = self.eval(e.orelse) if e.orelse is not None else None
        # result type = common type of all branch values
        vals = [bv for _, bv in branches] + ([orelse] if orelse else [])
        out_t = vals[0].type
        for v in vals[1:]:
            out_t = _common_valued(out_t, v.type)
        out_dict = None
        if out_t.is_string:
            out_dict = _one_dict(vals)
        cap, dev = self.chunk.capacity, self.device
        if orelse is not None:
            acc = _to_numeric(orelse, out_t, dev).expand(cap)
            acc_valid = (torch.ones((cap,), dtype=torch.bool, device=dev)
                         if orelse.valid is None else orelse.valid)
        else:
            acc = torch.zeros((cap,), dtype=out_t.dtype, device=dev)
            acc_valid = torch.zeros((cap,), dtype=torch.bool, device=dev)
        # apply WHENs last-to-first so the first true condition wins
        for cond, val in reversed(branches):
            c = as_tensor(cond.data, torch.bool, dev).expand(cap)
            if cond.valid is not None:
                c = c & cond.valid
            acc = torch.where(c, _to_numeric(val, out_t, dev).expand(cap), acc)
            bv = (torch.ones((cap,), dtype=torch.bool, device=dev)
                  if val.valid is None else val.valid.expand(cap))
            acc_valid = torch.where(c, bv, acc_valid)
        return EVal(acc, acc_valid, out_t, out_dict)

    # --- IN list ------------------------------------------------------------
    def _in_list(self, e: InList) -> EVal:
        v = self.eval(e.arg)
        cap, dev = self.chunk.capacity, self.device
        has_null = any(x is None for x in e.values)
        values = [x for x in e.values if x is not None]
        if v.type.is_decimal128:
            # OR of exact limb equalities (the 128-bit compare kernels)
            ctx = decimal.Context(prec=60)
            m = torch.zeros((cap,), dtype=torch.bool, device=dev)
            for x in values:
                scaled = decimal.Decimal(str(x)).scaleb(v.type.scale, ctx)
                if scaled != scaled.to_integral_value(decimal.ROUND_FLOOR,
                                                      ctx):
                    continue  # inexact at this scale: can never match
                lit = torch.tensor(_int_to_dec128(int(scaled)),
                                   dtype=torch.int64, device=dev)
                m = m | d128.eq(v.data, lit)
        elif v.type.is_string:
            if v.dict is None:
                raise TypeError("IN over strings needs a dict column")
            codes = {v.dict.encode_one(str(x)) for x in values}
            codes.discard(-1)
            if not codes:
                m = torch.zeros((cap,), dtype=torch.bool, device=dev)
            else:
                lut = np.zeros((max(len(v.dict), 1),), dtype=np.bool_)
                lut[sorted(codes)] = True
                m = torch.from_numpy(lut).to(dev)[
                    as_tensor(v.data, torch.int64, dev).clamp(0, len(lut) - 1)]
        else:
            m = torch.zeros((cap,), dtype=torch.bool, device=dev)
            d = as_tensor(v.data, v.type.dtype, dev).expand(cap)
            for x in values:
                hv, _ = _infer_lit(x, v.type if not v.type.is_float else None)
                m = m | (d == as_tensor(hv, v.type.dtype, dev))
        # SQL: 'x IN (a, NULL)' is TRUE on match, NULL otherwise (never FALSE);
        # NOT IN flips the value, validity is unchanged.
        valid = v.valid
        if has_null:
            valid = m if valid is None else (valid & m)
        return EVal(~m if e.negated else m, valid, T.BOOLEAN)


def _one_dict(vals) -> StringDict:
    """The dictionary of a string-valued CASE whose values are columns of
    ONE dictionary (or NULL): its codes are then the result's codes, as in
    TPC-DS q36/q86's `case when grouping(c) = 0 then i_category end`.
    Branches over two dictionaries or string literals need a branch merge
    the port does not have (the reference answers them with raw codes or
    fails: ROADMAP.md, reference defects), so they raise."""
    strs = [v for v in vals if v.type.kind is not T.TypeKind.NULL]
    dicts = {id(v.dict) for v in strs}
    if (any(v.dict is None or isinstance(v.data, str) for v in strs)
            or len(dicts) != 1):
        raise NotImplementedError(
            "string-valued CASE over string literals or more than one "
            "dictionary is not in the port yet")
    return strs[0].dict


def _common_valued(a: T.LogicalType, b: T.LogicalType) -> T.LogicalType:
    if a.kind is T.TypeKind.NULL:
        return b
    if b.kind is T.TypeKind.NULL:
        return a
    if a == b:
        return a
    return T.common_numeric_type(a, b)


# --- function registry ------------------------------------------------------

_FUNCTIONS = {}


def function(name):
    def deco(f):
        _FUNCTIONS[name] = f
        return f

    return deco


def _binary_numeric(cc: ExprCompiler, a: EVal, b: EVal, op):
    a, b = _promote_temporal_literals(a, b)
    ct = _common(a, b)
    da, db = _to_numeric(a, ct, cc.device), _to_numeric(b, ct, cc.device)
    return op(da, db), _and_valid(a.valid, b.valid), ct


def _scale_of(t: T.LogicalType) -> int:
    return t.scale if (t.is_decimal or t.is_decimal128) else 0


def _is_dec128_pair(a, b):
    nonfloat = all(t.is_decimal or t.is_decimal128 or t.is_integer
                   or t.kind is T.TypeKind.BOOLEAN for t in (a.type, b.type))
    return nonfloat and (a.type.is_decimal128 or b.type.is_decimal128)


def _to_dec128(v: EVal, scale: int, device):
    """v's data as [.., 4] limbs at `scale` (exact widening casts only)."""
    if v.type.is_decimal128:
        if v.type.scale > scale:
            raise NotImplementedError("DECIMAL128 downscale in comparison")
        return d128.rescale(as_tensor(v.data, torch.int64, device),
                            scale - v.type.scale)
    if v.type.is_decimal:
        d = d128.from_i64(as_tensor(v.data, torch.int64, device))
        return d128.rescale(d, scale - v.type.scale)
    if v.type.is_integer or v.type.kind is T.TypeKind.BOOLEAN:
        return d128.rescale(
            d128.from_i64(as_tensor(v.data, torch.int64, device)), scale)
    if v.type.is_float and isinstance(v.data, float):
        # concrete float literal: exact iff it round-trips at this scale
        # (decimal literals small enough for float64 always do)
        iv = int(round(v.data * (10 ** scale)))
        if iv / (10 ** scale) == v.data and abs(iv) < (1 << 63):
            return d128.from_i64(torch.tensor(iv, dtype=torch.int64,
                                              device=device))
    raise NotImplementedError(
        f"cannot widen {v.type!r} to DECIMAL128 exactly (cast to DOUBLE)")


def _dec128_addsub(a: EVal, b: EVal, is_sub: bool, device) -> EVal:
    s = max(_scale_of(a.type), _scale_of(b.type))
    da, db = _to_dec128(a, s, device), _to_dec128(b, s, device)
    out = d128.sub(da, db) if is_sub else d128.add(da, db)
    return EVal(out, _and_valid(a.valid, b.valid), T.DECIMAL(38, s))


@function("add")
def _f_add(cc, a, b):
    if _is_dec128_pair(a, b):
        return _dec128_addsub(a, b, False, cc.device)
    d, v, t = _binary_numeric(cc, a, b, torch.add)
    return EVal(d, v, t)


@function("subtract")
def _f_sub(cc, a, b):
    if _is_dec128_pair(a, b):
        return _dec128_addsub(a, b, True, cc.device)
    d, v, t = _binary_numeric(cc, a, b, torch.sub)
    return EVal(d, v, t)


def _dec128_mul(a: EVal, b: EVal, device) -> EVal:
    sa, sb = _scale_of(a.type), _scale_of(b.type)
    if sa + sb > 38:
        raise NotImplementedError(f"decimal multiply scale {sa + sb} > 38")
    out = d128.mul(_to_dec128(a, sa, device), _to_dec128(b, sb, device))
    return EVal(out, _and_valid(a.valid, b.valid), T.DECIMAL(38, sa + sb))


@function("multiply")
def _f_mul(cc, a, b):
    a, b = _promote_temporal_literals(a, b)
    if _is_dec128_pair(a, b):
        return _dec128_mul(a, b, cc.device)
    ct = _common(a, b)
    if ct.is_decimal:
        sa = a.type.scale if a.type.is_decimal else 0
        sb = b.type.scale if b.type.is_decimal else 0
        out_s = sa + sb
        if out_s > 18:
            # product scale overflows DECIMAL64: promote to the 128-bit path
            return _dec128_mul(a, b, cc.device)
        da = (as_tensor(a.data, torch.int64, cc.device) if a.type.is_decimal
              else _to_numeric(a, T.DECIMAL(18, 0), cc.device))
        db = (as_tensor(b.data, torch.int64, cc.device) if b.type.is_decimal
              else _to_numeric(b, T.DECIMAL(18, 0), cc.device))
        return EVal(da * db, _and_valid(a.valid, b.valid), T.DECIMAL(18, out_s))
    da, db = _to_numeric(a, ct, cc.device), _to_numeric(b, ct, cc.device)
    return EVal(da * db, _and_valid(a.valid, b.valid), ct)


@function("divide")
def _f_div(cc, a, b):
    # SQL semantics: x/0 -> NULL. Result computed in DOUBLE.
    da = _to_numeric(a, T.DOUBLE, cc.device)
    db = _to_numeric(b, T.DOUBLE, cc.device)
    zero = db == 0.0
    d = da / torch.where(zero, 1.0, db)
    return EVal(d, _and_valid(a.valid, b.valid, ~zero), T.DOUBLE)


@function("mod")
def _f_mod(cc, a, b):
    # SQL MOD: truncated remainder (sign of the dividend), x % 0 -> NULL
    ct = _common(a, b)
    da, db = _to_numeric(a, ct, cc.device), _to_numeric(b, ct, cc.device)
    zero = db == 0
    safe_db = torch.where(zero, torch.ones_like(db), db)
    mag = torch.abs(da) % torch.abs(safe_db)
    d = torch.where(da < 0, -mag, mag)
    return EVal(d, _and_valid(a.valid, b.valid, ~zero), ct)


@function("negate")
def _f_neg(cc, a):
    if a.type.is_decimal128:
        return EVal(d128.neg(a.data), a.valid, a.type)
    return EVal(-as_tensor(a.data, a.type.dtype, cc.device), a.valid, a.type)


@function("abs")
def _f_abs(cc, a):
    if a.type.is_decimal128:
        d = as_tensor(a.data, torch.int64, cc.device)
        neg = (d[..., 0] >= 0x80000000).unsqueeze(-1)
        return EVal(torch.where(neg, d128.neg(d), d), a.valid, a.type)
    return EVal(torch.abs(as_tensor(a.data, a.type.dtype, cc.device)),
                a.valid, a.type)


_FLIPPED = {
    torch.eq: torch.eq,
    torch.ne: torch.ne,
    torch.lt: torch.gt,
    torch.le: torch.ge,
    torch.gt: torch.lt,
    torch.ge: torch.le,
}


def _compare_dec128(cc, a: EVal, b: EVal, op):
    s = max(_scale_of(a.type), _scale_of(b.type))
    da, db = _to_dec128(a, s, cc.device), _to_dec128(b, s, cc.device)
    if op is torch.eq:
        res = d128.eq(da, db)
    elif op is torch.ne:
        res = ~d128.eq(da, db)
    elif op is torch.lt:
        res = d128.lt(da, db)
    elif op is torch.le:
        res = ~d128.lt(db, da)
    elif op is torch.gt:
        res = d128.lt(db, da)
    else:  # ge
        res = ~d128.lt(da, db)
    return EVal(res, _and_valid(a.valid, b.valid), T.BOOLEAN)


def _compare(cc, a, b, op):
    if a.type.is_decimal128 or b.type.is_decimal128:
        return _compare_dec128(cc, a, b, op)
    a, b = _promote_temporal_literals(a, b)
    if a.type.is_string or b.type.is_string:
        return _compare_strings(cc, a, b, op)
    ct = _common(a, b)
    if ct.is_decimal:
        # compare at the max scale of both sides
        sa = a.type.scale if a.type.is_decimal else 0
        sb = b.type.scale if b.type.is_decimal else 0
        ct = T.DECIMAL(18, max(sa, sb))
    da, db = _to_numeric(a, ct, cc.device), _to_numeric(b, ct, cc.device)
    return EVal(op(da, db), _and_valid(a.valid, b.valid), T.BOOLEAN)


def _compare_strings(cc, a: EVal, b: EVal, op):
    dev = cc.device
    # column vs literal: compare codes against the literal's rank in the dict
    if a.dict is not None and isinstance(b.data, str):
        d = a.dict
        s = b.data
        codes = as_tensor(a.data, torch.int32, dev)
        if op in (torch.eq, torch.ne):
            code = d.encode_one(s)
            if code < 0:
                base = torch.zeros_like(codes, dtype=torch.bool)
                res = base if op is torch.eq else ~base
            else:
                res = op(codes, code)
            return EVal(res, a.valid, T.BOOLEAN)
        # order comparison: sorted dict => rank position is correct
        pos = int(np.searchsorted(d.values.astype(str), s))
        exists = pos < len(d) and str(d.values[pos]) == s
        code = pos  # insertion point (== rank whether or not s exists)
        if op is torch.lt:
            res = codes < code
        elif op is torch.le:
            res = codes < (code + 1 if exists else code)
        elif op is torch.gt:
            res = codes >= (code + 1 if exists else code)
        elif op is torch.ge:
            res = codes >= code
        else:
            raise AssertionError(op)
        return EVal(res, a.valid, T.BOOLEAN)
    if b.dict is not None and isinstance(a.data, str):
        return _compare_strings(cc, b, a, _FLIPPED[op])
    if a.dict is not None and b.dict is not None:
        if a.dict is b.dict:
            return EVal(op(a.data, b.data), _and_valid(a.valid, b.valid),
                        T.BOOLEAN)
        # remap both sides' codes into the merged dict's ordering
        _, ra, rb = a.dict.merge(b.dict)
        ra_t = torch.from_numpy(np.asarray(ra)).to(dev)
        rb_t = torch.from_numpy(np.asarray(rb)).to(dev)
        da = ra_t[a.data.long().clamp(0, len(ra) - 1)]
        db = rb_t[b.data.long().clamp(0, len(rb) - 1)]
        return EVal(op(da, db), _and_valid(a.valid, b.valid), T.BOOLEAN)
    if isinstance(a.data, str) and isinstance(b.data, str):
        # literal vs literal: rank both in a shared 2-entry dict
        m, _ = StringDict.from_strings([a.data, b.data])
        ra, rb = int(m.encode([a.data])[0]), int(m.encode([b.data])[0])
        return EVal(op(torch.tensor(ra, device=dev), rb),
                    _and_valid(a.valid, b.valid), T.BOOLEAN)
    raise NotImplementedError("string comparison without dictionaries")


@function("eq")
def _f_eq(cc, a, b):
    return _compare(cc, a, b, torch.eq)


@function("ne")
def _f_ne(cc, a, b):
    return _compare(cc, a, b, torch.ne)


@function("lt")
def _f_lt(cc, a, b):
    return _compare(cc, a, b, torch.lt)


@function("le")
def _f_le(cc, a, b):
    return _compare(cc, a, b, torch.le)


@function("gt")
def _f_gt(cc, a, b):
    return _compare(cc, a, b, torch.gt)


@function("ge")
def _f_ge(cc, a, b):
    return _compare(cc, a, b, torch.ge)


@function("and")
def _f_and(cc, a, b):
    # Kleene: F & NULL = F, T & NULL = NULL
    da = as_tensor(a.data, torch.bool, cc.device)
    db = as_tensor(b.data, torch.bool, cc.device)
    va, vb = a.valid, b.valid
    res = da & db
    if va is None and vb is None:
        return EVal(res, None, T.BOOLEAN)
    ta = da if va is None else (da & va)  # definitely true
    fa = ~da if va is None else (~da & va)  # definitely false
    tb = db if vb is None else (db & vb)
    fb = ~db if vb is None else (~db & vb)
    valid = fa | fb | (ta & tb)
    return EVal(ta & tb, valid, T.BOOLEAN)


@function("or")
def _f_or(cc, a, b):
    da = as_tensor(a.data, torch.bool, cc.device)
    db = as_tensor(b.data, torch.bool, cc.device)
    va, vb = a.valid, b.valid
    if va is None and vb is None:
        return EVal(da | db, None, T.BOOLEAN)
    ta = da if va is None else (da & va)
    fa = ~da if va is None else (~da & va)
    tb = db if vb is None else (db & vb)
    fb = ~db if vb is None else (~db & vb)
    valid = ta | tb | (fa & fb)
    return EVal(ta | tb, valid, T.BOOLEAN)


@function("not")
def _f_not(cc, a):
    return EVal(~as_tensor(a.data, torch.bool, cc.device), a.valid, T.BOOLEAN)


@function("is_null")
def _f_is_null(cc, a):
    cap, dev = cc.chunk.capacity, cc.device
    if a.valid is None:
        return EVal(torch.zeros((cap,), dtype=torch.bool, device=dev), None,
                    T.BOOLEAN)
    return EVal(~a.valid.expand(cap), None, T.BOOLEAN)


@function("is_not_null")
def _f_is_not_null(cc, a):
    cap, dev = cc.chunk.capacity, cc.device
    if a.valid is None:
        return EVal(torch.ones((cap,), dtype=torch.bool, device=dev), None,
                    T.BOOLEAN)
    return EVal(a.valid.expand(cap), None, T.BOOLEAN)


@function("null_of")
def _f_null_of(cc, a):
    # typed NULL column shaped like `a` (ROLLUP's grouping placeholder)
    cap, dev = cc.chunk.capacity, cc.device
    if isinstance(a.data, torch.Tensor):
        data = a.data.expand((cap,) + tuple(a.data.shape[1:]))
    else:
        data = torch.zeros((cap,), dtype=a.type.dtype, device=dev)
    return EVal(data, torch.zeros((cap,), dtype=torch.bool, device=dev),
                a.type, a.dict)


@function("coalesce")
def _f_coalesce(cc, *args):
    cap, dev = cc.chunk.capacity, cc.device
    out = args[-1]
    for v in reversed(args[:-1]):
        if v.valid is None:
            out = v
            continue
        ct = _common_valued(v.type, out.type)
        if ct.is_string:
            raise NotImplementedError(
                "coalesce over strings is not in the port yet")
        dv = _to_numeric(v, ct, dev).expand(cap)
        do = _to_numeric(out, ct, dev).expand(cap)
        ov = (torch.ones((cap,), dtype=torch.bool, device=dev)
              if out.valid is None else out.valid)
        out = EVal(torch.where(v.valid, dv, do), v.valid | ov, ct)
    return out


@function("nullif")
def _f_nullif(cc, a, b):
    """NULL when a == b else a (the reference's functions_ext.py)."""
    eq = _f_eq(cc, a, b)
    equal = as_tensor(eq.data, torch.bool, cc.device)
    if eq.valid is not None:
        equal = equal & eq.valid  # NULL comparison -> keep a
    v = ~equal if a.valid is None else (a.valid & ~equal)
    return EVal(a.data, v, a.type, a.dict)


@function("if")
def _f_if(cc, c, a, b):
    ct = _common_valued(a.type, b.type)
    if ct.is_string:
        # the reference returns dictionary codes here (ROADMAP: reference
        # defects, not ported)
        raise NotImplementedError("string-valued IF is not in the port")
    cap, dev = cc.chunk.capacity, cc.device
    cond = as_tensor(c.data, torch.bool, dev).expand(cap)
    if c.valid is not None:
        cond = cond & c.valid
    da = _to_numeric(a, ct, dev).expand(cap)
    db = _to_numeric(b, ct, dev).expand(cap)
    d = torch.where(cond, da, db)
    if a.valid is None and b.valid is None:
        return EVal(d, None, ct)
    ones = torch.ones((cap,), dtype=torch.bool, device=dev)
    va = ones if a.valid is None else a.valid.expand(cap)
    vb = ones if b.valid is None else b.valid.expand(cap)
    return EVal(d, torch.where(cond, va, vb), ct)


# --- dates ------------------------------------------------------------------
# civil-from-days (Howard Hinnant's algorithm), vectorized over int32 days.
# Integer `//` on torch tensors floors, as jnp's does.


def _civil_from_days(days):
    z = days.to(torch.int64) + 719_468
    era = torch.where(z >= 0, z, z - 146_096) // 146_097
    doe = z - era * 146_097
    yoe = (doe - doe // 1460 + doe // 36_524 - doe // 146_096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    y = torch.where(m <= 2, y + 1, y)
    return y.to(torch.int32), m.to(torch.int32), d.to(torch.int32)


def _as_days(v: EVal, device):
    if v.type.kind is T.TypeKind.DATE:
        return as_tensor(v.data, torch.int32, device)
    if v.type.kind is T.TypeKind.DATETIME:
        return (as_tensor(v.data, torch.int64, device)
                // 86_400_000_000).to(torch.int32)
    raise TypeError(f"expected date/datetime, got {v.type}")


def _py_year_of_days(days: int) -> int:
    """Host-side civil year of a days-since-epoch value (bounds math)."""
    return (datetime.date(1970, 1, 1)
            + datetime.timedelta(days=int(days))).year


def _date_bounds_days(a: EVal):
    """arg bounds as days-since-epoch, or None."""
    if a.bounds is None:
        return None
    lo, hi = a.bounds
    if a.type.kind is T.TypeKind.DATETIME:
        return (int(lo) // 86_400_000_000, int(hi) // 86_400_000_000)
    if a.type.kind is T.TypeKind.DATE:
        return (int(lo), int(hi))
    return None


@function("year")
def _f_year(cc, a):
    a = _lit_as_date_if_str(a)
    y, _, _ = _civil_from_days(_as_days(a, cc.device))
    db = _date_bounds_days(a)
    yb = ((_py_year_of_days(db[0]), _py_year_of_days(db[1]))
          if db is not None else None)
    return EVal(y, a.valid, T.INT, bounds=yb)


@function("month")
def _f_month(cc, a):
    a = _lit_as_date_if_str(a)
    _, m, _ = _civil_from_days(_as_days(a, cc.device))
    return EVal(m, a.valid, T.INT, bounds=(1, 12))


@function("day")
def _f_day(cc, a):
    a = _lit_as_date_if_str(a)
    _, _, d = _civil_from_days(_as_days(a, cc.device))
    return EVal(d, a.valid, T.INT, bounds=(1, 31))


@function("date_add_days")
def _f_date_add_days(cc, a, n):
    a = _lit_as_date_if_str(a)
    return EVal(
        as_tensor(a.data, torch.int32, cc.device)
        + as_tensor(n.data, torch.int32, cc.device),
        _and_valid(a.valid, n.valid),
        T.DATE,
    )


def _days_from_civil(y, m, d):
    yy = y.to(torch.int64) - (m <= 2).to(torch.int64)
    era = torch.where(yy >= 0, yy, yy - 399) // 400
    yoe = yy - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = (153 * mp + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return (era * 146_097 + doe - 719_468).to(torch.int32)


_DAYS_IN_MONTH = (31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31)


@function("date_add_months")
def _f_date_add_months(cc, a, n):
    """date + n months; the day clamps to the target month's end (Jan 31 +
    1 month = Feb 28, or Feb 29 in a leap year)."""
    a = _lit_as_date_if_str(a)
    dev = cc.device
    y, m, d = _civil_from_days(_as_days(a, dev))
    months = (y.to(torch.int64) * 12 + (m - 1)
              + as_tensor(n.data, torch.int64, dev))
    y2 = months // 12
    m2 = months % 12 + 1
    leap = ((y2 % 4 == 0) & ((y2 % 100 != 0) | (y2 % 400 == 0))).to(torch.int64)
    dim = torch.tensor(_DAYS_IN_MONTH, dtype=torch.int64, device=dev)[m2 - 1]
    dim = dim + torch.where(m2 == 2, leap, 0)
    d2 = torch.minimum(d.to(torch.int64), dim)
    return EVal(_days_from_civil(y2, m2, d2), _and_valid(a.valid, n.valid),
                T.DATE)


# --- strings (dict LUT machinery) -------------------------------------------


def _string_bool_fn(cc, a: EVal, pred) -> EVal:
    if a.dict is None and isinstance(a.data, str):
        return EVal(bool(pred(a.data)), a.valid, T.BOOLEAN)
    if a.dict is None:
        raise TypeError("string function needs a dict column")
    if not len(a.dict):
        return EVal(torch.zeros_like(a.data, dtype=torch.bool), a.valid,
                    T.BOOLEAN)
    lut = torch.from_numpy(a.dict.lut(pred)).to(cc.device)
    m = lut[a.data.long().clamp(0, len(a.dict) - 1)]
    return EVal(m, a.valid, T.BOOLEAN)


def like_to_regex(pattern: str) -> str:
    out = []
    i = 0
    while i < len(pattern):
        ch = pattern[i]
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        elif ch == "\\" and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 1
        else:
            out.append(re.escape(ch))
        i += 1
    return "^" + "".join(out) + "$"


@function("like")
def _f_like(cc, a, pat):
    if not isinstance(pat.data, str):
        raise TypeError("LIKE pattern must be a literal")
    rx = re.compile(like_to_regex(pat.data), re.S)
    return _string_bool_fn(cc, a, lambda s: rx.match(str(s)) is not None)


@function("not_like")
def _f_not_like(cc, a, pat):
    v = _f_like(cc, a, pat)
    return EVal(~as_tensor(v.data, torch.bool, cc.device), v.valid, T.BOOLEAN)


@function("starts_with")
def _f_starts_with(cc, a, pre):
    p = str(pre.data)
    return _string_bool_fn(cc, a, lambda s: str(s).startswith(p))


@function("ends_with")
def _f_ends_with(cc, a, suf):
    p = str(suf.data)
    return _string_bool_fn(cc, a, lambda s: str(s).endswith(p))


def _string_map_fn(cc, a: EVal, f) -> EVal:
    """string->string function via a constant remap into a fresh dict."""
    if a.dict is None and isinstance(a.data, str):
        return EVal(str(f(a.data)), a.valid, T.VARCHAR)
    if a.dict is None:
        raise TypeError("string function needs a dict column")
    mapped = [str(f(str(s))) for s in a.dict.values]
    if mapped:
        new_dict, codes = StringDict.from_strings(mapped)
    else:
        new_dict, codes = StringDict.from_values([]), np.zeros(1, np.int32)
    remap = torch.from_numpy(codes).to(cc.device)
    n = max(len(a.dict), 1)
    out = remap[as_tensor(a.data, torch.int64, cc.device).clamp(0, n - 1)]
    return EVal(out, a.valid, T.VARCHAR, new_dict)


@function("substr")
def _f_substr(cc, a, start, length=None):
    st = int(start.data)
    ln = None if length is None else int(length.data)

    def sub(s: str) -> str:
        # SQL semantics: 1-based; negative start counts from the end;
        # start 0 or |start| > len(s) yields ''
        if st == 0:
            return ""
        idx = st - 1 if st > 0 else len(s) + st
        if idx < 0 or idx >= len(s):
            return ""
        end = len(s) if ln is None else idx + max(ln, 0)
        return s[idx:end]

    return _string_map_fn(cc, a, sub)


@function("upper")
def _f_upper(cc, a):
    return _string_map_fn(cc, a, str.upper)


@function("lower")
def _f_lower(cc, a):
    return _string_map_fn(cc, a, str.lower)


@function("trim")
def _f_trim(cc, a):
    return _string_map_fn(cc, a, str.strip)


@function("ltrim")
def _f_ltrim(cc, a):
    return _string_map_fn(cc, a, str.lstrip)


@function("rtrim")
def _f_rtrim(cc, a):
    return _string_map_fn(cc, a, str.rstrip)


@function("replace")
def _f_replace(cc, a, old, new):
    o, n = str(old.data), str(new.data)
    return _string_map_fn(cc, a, lambda s: s.replace(o, n))


@function("concat")
def _f_concat(cc, *args):
    """Dict-remap concat: works when at most ONE argument is a (dict) column
    and the rest are literals — the common SQL pattern. Column-column
    concat would need a cross-product dictionary."""
    col_args = [a for a in args if a.dict is not None]
    if len(col_args) > 1:
        raise NotImplementedError("concat of multiple string columns")
    for a in args:
        if a.dict is None and not isinstance(a.data, (str, int, float, bool)):
            raise NotImplementedError(
                "concat requires string literals / one string column "
                f"(got a {a.type} column)")
    if not col_args:
        return EVal("".join(str(a.data) for a in args), None, T.VARCHAR)
    col = col_args[0]

    def f(s):
        return "".join(s if a is col else str(a.data) for a in args)

    return _string_map_fn(cc, col, f)


@function("length")
def _f_length(cc, a):
    if a.dict is None:
        raise TypeError("length() needs a string column")
    lens = np.fromiter((len(str(v)) for v in a.dict.values),
                       count=len(a.dict), dtype=np.int32)
    if not len(lens):
        lens = np.zeros(1, np.int32)
    lut = torch.from_numpy(lens).to(cc.device)
    n = max(len(a.dict), 1)
    return EVal(lut[as_tensor(a.data, torch.int64, cc.device).clamp(0, n - 1)],
                a.valid, T.INT)


# --- maths ------------------------------------------------------------------


@function("round")
def _f_round(cc, a, nd=None):
    digits = 0 if nd is None else int(nd.data)
    dev = cc.device
    if a.type.is_decimal:
        sc = a.type.scale
        if digits >= sc:
            return a
        q = 10 ** (sc - digits)
        d = as_tensor(a.data, torch.int64, dev)
        # round-half-away-from-zero on scaled ints
        r = torch.where(d >= 0, (d + q // 2) // q, -((-d + q // 2) // q)) * q
        return EVal(r, a.valid, a.type)
    d = as_tensor(a.data, torch.float64, dev)
    f = 10.0 ** digits
    # SQL rounds half away from zero (torch.round is half-to-even)
    r = div_scalar(torch.sign(d) * torch.floor(torch.abs(d) * f + 0.5), f)
    return EVal(r, a.valid, T.DOUBLE)


@function("floor")
def _f_floor(cc, a):
    return EVal(torch.floor(_to_numeric(a, T.DOUBLE, cc.device)), a.valid,
                T.DOUBLE)


@function("ceil")
def _f_ceil(cc, a):
    return EVal(torch.ceil(_to_numeric(a, T.DOUBLE, cc.device)), a.valid,
                T.DOUBLE)


@function("sqrt")
def _f_sqrt(cc, a):
    d = _to_numeric(a, T.DOUBLE, cc.device)
    neg = d < 0
    out = torch.sqrt(torch.where(neg, 0.0, d))
    return EVal(out, _and_valid(a.valid, ~neg), T.DOUBLE)


@function("power")
def _f_power(cc, a, b):
    da = _to_numeric(a, T.DOUBLE, cc.device)
    db = _to_numeric(b, T.DOUBLE, cc.device)
    return EVal(torch.pow(da, db), _and_valid(a.valid, b.valid), T.DOUBLE)


@function("exp")
def _f_exp(cc, a):
    return EVal(torch.exp(_to_numeric(a, T.DOUBLE, cc.device)), a.valid,
                T.DOUBLE)


@function("ln")
def _f_ln(cc, a):
    d = _to_numeric(a, T.DOUBLE, cc.device)
    bad = d <= 0
    return EVal(torch.log(torch.where(bad, 1.0, d)),
                _and_valid(a.valid, ~bad), T.DOUBLE)


def _extreme(cc, args, op):
    ct = args[0].type
    for x in args[1:]:
        ct = T.common_numeric_type(ct, x.type)
    d = _to_numeric(args[0], ct, cc.device)
    v = args[0].valid
    for x in args[1:]:
        d = op(d, _to_numeric(x, ct, cc.device))
        v = _and_valid(v, x.valid)
    return EVal(d, v, ct)


@function("greatest")
def _f_greatest(cc, *args):
    return _extreme(cc, args, torch.maximum)


@function("least")
def _f_least(cc, *args):
    return _extreme(cc, args, torch.minimum)


# --- date differences ---------------------------------------------------------


@function("datediff")
def _f_datediff(cc, a, b):
    a = _lit_as_date_if_str(a)
    b = _lit_as_date_if_str(b)
    return EVal(_as_days(a, cc.device) - _as_days(b, cc.device),
                _and_valid(a.valid, b.valid), T.INT)


@function("dayofweek")
def _f_dayofweek(cc, a):
    a = _lit_as_date_if_str(a)
    # 1970-01-01 was a Thursday; SQL convention: 1=Sunday .. 7=Saturday
    days = _as_days(a, cc.device).to(torch.int64)
    return EVal(((days + 4) % 7 + 1).to(torch.int32), a.valid, T.INT)


@function("quarter")
def _f_quarter(cc, a):
    a = _lit_as_date_if_str(a)
    _, m, _ = _civil_from_days(_as_days(a, cc.device))
    return EVal((m - 1) // 3 + 1, a.valid, T.INT)



def eval_expr(chunk: Chunk, e: Expr) -> EVal:
    return ExprCompiler(chunk).eval(e)


def eval_predicate(chunk: Chunk, e: Expr) -> torch.Tensor:
    return ExprCompiler(chunk).eval_predicate(e)


# the operators import this module, so the limb arithmetic comes last
from ..ops import dec128 as d128  # noqa: E402
