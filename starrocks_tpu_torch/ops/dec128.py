"""128-bit decimal limb arithmetic (DECIMAL(19..38) values).

Reference behavior: be/src/runtime/decimalv3.h + be/src/types/int128 paths
(int128 accumulators/compares in the vectorized engine). The layout is the
JAX package's: values live as 4x32-bit limbs in an int64 rank-2 tensor
[rows, 4], MOST significant limb first, two's complement mod 2^128 (the
same wrap-around contract as the reference's int128).

Every function is elementwise: compares are sign-adjusted lexicographic
cascades, and multiplication runs over 16-bit half-limbs so every partial
product and carry fits int64 exactly. torch's `>>` on int64 is arithmetic,
as jnp's is, so every limb is masked back to 32 bits after a shift.
"""

from __future__ import annotations

import torch

_MASK32 = 0xFFFFFFFF
_SIGN32 = 0x80000000


def _i64(x) -> torch.Tensor:
    return x.to(torch.int64) if isinstance(x, torch.Tensor) else torch.as_tensor(
        x, dtype=torch.int64)


def from_i64(x):
    """Sign-extend int64 -> [.., 4] limbs ms-first."""
    x = _i64(x)
    ext = torch.where(x < 0, _MASK32, 0).to(torch.int64)
    hi = (x >> 32) & _MASK32
    lo = x & _MASK32
    return torch.stack([ext, ext, hi, lo], dim=-1)


def to_f64(d):
    """Approximate float64 value of the signed 128-bit integer. The ms limb
    is signed BEFORE the weighted sum — computing (unsigned - 2^128) in
    float64 would cancel catastrophically (2^128 >> ulp of the result)."""
    d = _i64(d)
    ms = torch.where(d[..., 0] >= _SIGN32, d[..., 0] - (1 << 32), d[..., 0])
    f = [x.to(torch.float64) for x in (ms, d[..., 1], d[..., 2], d[..., 3])]
    return f[0] * (2.0 ** 96) + f[1] * (2.0 ** 64) + f[2] * (2.0 ** 32) + f[3]


def cmp_limbs(d):
    """Limbs with the sign bit flipped on the ms limb: unsigned
    lexicographic order over these == signed 128-bit order."""
    d = _i64(d)
    return (d[..., 0] ^ _SIGN32, d[..., 1], d[..., 2], d[..., 3])


def _lex_lt(a, b):
    shape = torch.broadcast_shapes(a[0].shape, b[0].shape)
    lt = torch.zeros(shape, dtype=torch.bool, device=a[0].device)
    decided = torch.zeros(shape, dtype=torch.bool, device=a[0].device)
    for ai, bi in zip(a, b):
        lt = lt | (~decided & (ai < bi))
        decided = decided | (ai != bi)
    return lt


def lt(a, b):
    return _lex_lt(cmp_limbs(a), cmp_limbs(b))


def eq(a, b):
    return torch.all(_i64(a) == _i64(b), dim=-1)


def add(a, b):
    """(a + b) mod 2^128, limbwise with carry propagation."""
    a, b = _i64(a), _i64(b)
    shape = torch.broadcast_shapes(a.shape, b.shape)[:-1]
    out = []
    carry = torch.zeros(shape, dtype=torch.int64, device=a.device)
    for i in (3, 2, 1, 0):  # least significant first
        tot = a[..., i] + b[..., i] + carry
        out.append(tot & _MASK32)
        carry = tot >> 32
    return torch.stack(out[::-1], dim=-1)


def neg(a):
    """Two's complement negation."""
    a = _i64(a)
    inv = (~a) & _MASK32
    one = torch.zeros_like(a)
    one[..., 3] = 1
    return add(inv, one)


def sub(a, b):
    return add(a, neg(b))


def _to_halves(d):
    """[.., 4] 32-bit limbs ms-first -> [.., 8] 16-bit half-limbs LS-first."""
    d = _i64(d)
    parts = []
    for i in (3, 2, 1, 0):
        parts.append(d[..., i] & 0xFFFF)
        parts.append((d[..., i] >> 16) & 0xFFFF)
    return torch.stack(parts, dim=-1)  # [.., 8] ls-first


def _from_halves(h):
    """[.., 8] LS-first half-limbs (already carry-normalized < 2^16) ->
    [.., 4] ms-first 32-bit limbs."""
    limbs = []
    for i in (3, 2, 1, 0):  # ms first
        limbs.append((h[..., 2 * i + 1] << 16) | h[..., 2 * i])
    return torch.stack(limbs, dim=-1)


def mul(a, b):
    """(a * b) mod 2^128. 16-bit half-limb schoolbook product: each partial
    sum is < 8 * 2^32 and every carry chain stays far below 2^63."""
    ha, hb = _to_halves(a), _to_halves(b)
    shape = torch.broadcast_shapes(ha.shape, hb.shape)[:-1]
    acc = [torch.zeros(shape, dtype=torch.int64, device=ha.device)
           for _ in range(8)]
    for i in range(8):
        for j in range(8 - i):
            acc[i + j] = acc[i + j] + ha[..., i] * hb[..., j]
    out = []
    carry = torch.zeros(shape, dtype=torch.int64, device=ha.device)
    for i in range(8):
        tot = acc[i] + carry
        out.append(tot & 0xFFFF)
        carry = tot >> 16
    return _from_halves(torch.stack(out, dim=-1))


def mul_small(a, c: int):
    """a * c for a host constant 0 <= c < 2^31 (single limb pass)."""
    a = _i64(a)
    out = []
    carry = torch.zeros(a.shape[:-1], dtype=torch.int64, device=a.device)
    for i in (3, 2, 1, 0):
        tot = a[..., i] * c + carry
        out.append(tot & _MASK32)
        carry = tot >> 32
    return torch.stack(out[::-1], dim=-1)


def rescale(a, k: int):
    """a * 10^k (k >= 0), chunked so each multiplier stays below 2^31."""
    while k > 0:
        step = min(k, 9)
        a = mul_small(a, 10 ** step)
        k -= step
    return a


def sort_ops(d, valid):
    """lexsort operand list (least-significant-first) for a dec128 key,
    mirroring key_sort_arrays' per-key convention."""
    ms, l1, l2, l3 = cmp_limbs(d)
    ops = [l3, l2, l1, ms]
    if valid is not None:
        ops.append((~valid).to(torch.int8))
    return ops
