"""Double-double (compensated f64-pair) arithmetic primitives.

Counterpart of ``tulip_tpu/ops/doubledouble.py``: a value is an
unevaluated sum ``hi + lo`` of two f64 tensors (~106-bit significand,
ε ≈ 2⁻¹⁰⁵), built from the error-free transforms (Knuth two-sum,
Dekker split/two-prod) and the double-word algorithms of Joldes, Muller
& Popescu (2017). Every function computes the reference's value bit for
bit: the same operations in the same order, and the same pairwise tree in
the reductions.

The transforms are exact only if each product and sum rounds on its own.
Each torch elementwise operator is one kernel that rounds its result, so
plain ``*``, ``+`` and ``-`` are safe on the CPU and on the card. A fused
multiply-add is not: ``torch.addcmul``, ``addmm``, ``baddbmm``, ``lerp``,
a matmul (cuBLAS and the tensor cores fuse the multiply and the add) or
``torch.compile`` (which may contract ``a*b - c`` into one FMA) must not
form a dd product here.

A dd value is a plain ``(hi, lo)`` tuple of equal-shape f64 tensors.
"""

from __future__ import annotations

from typing import Tuple

import torch

DD = Tuple[torch.Tensor, torch.Tensor]

# Dekker splitter for binary64: 2^27 + 1.
_SPLIT = 134217729.0


# ---------------------------------------------------------------------------
# Error-free transforms
# ---------------------------------------------------------------------------

def two_sum(a, b) -> DD:
    """s + e == a + b exactly, s = fl(a+b) (Knuth; no branch, no FMA)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def fast_two_sum(a, b) -> DD:
    """s + e == a + b exactly, REQUIRES |a| >= |b| (Dekker)."""
    s = a + b
    e = b - (s - a)
    return s, e


def _split(a) -> DD:
    c = _SPLIT * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b) -> DD:
    """p + e == a * b exactly (Dekker/Veltkamp product, FMA-free)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


# ---------------------------------------------------------------------------
# Double-word arithmetic (Joldes-Muller-Popescu accurate variants)
# ---------------------------------------------------------------------------

def from_f(a) -> DD:
    a = torch.as_tensor(a, dtype=torch.float64)
    return a, torch.zeros_like(a)


def to_f(x: DD) -> torch.Tensor:
    return x[0] + x[1]


def neg(x: DD) -> DD:
    return -x[0], -x[1]


def add(x: DD, y: DD) -> DD:
    """dd + dd (AccurateDWPlusDW, ~3u² relative error)."""
    sh, sl = two_sum(x[0], y[0])
    th, tl = two_sum(x[1], y[1])
    c = sl + th
    vh, vl = fast_two_sum(sh, c)
    w = tl + vl
    return fast_two_sum(vh, w)


def sub(x: DD, y: DD) -> DD:
    return add(x, neg(y))


def add_f(x: DD, b) -> DD:
    """dd + f64 (DWPlusFP, ~2u²)."""
    sh, sl = two_sum(x[0], b)
    v = x[1] + sl
    return fast_two_sum(sh, v)


def mul_ff(a, b) -> DD:
    """f64 * f64 -> exact dd."""
    return two_prod(a, b)


def mul_f(x: DD, b) -> DD:
    """dd * f64 (DWTimesFP3, ~2u²)."""
    ch, cl1 = two_prod(x[0], b)
    cl3 = x[1] * b + cl1
    return fast_two_sum(ch, cl3)


def mul(x: DD, y: DD) -> DD:
    """dd * dd (DWTimesDW, ~5u²)."""
    ch, cl1 = two_prod(x[0], y[0])
    tl = x[0] * y[1] + x[1] * y[0]
    cl2 = tl + cl1
    return fast_two_sum(ch, cl2)


def div(x: DD, y: DD) -> DD:
    """dd / dd (DWDivDW2, ~15u²): one f64 quotient + a dd residual
    correction."""
    th = x[0] / y[0]
    r = sub(x, mul_f(y, th))
    tl = r[0] / y[0]
    return fast_two_sum(th, tl)


def recip(y: DD) -> DD:
    """1 / dd."""
    th = 1.0 / y[0]
    r = sub(from_f(torch.ones_like(y[0])), mul_f(y, th))
    tl = r[0] / y[0]
    return fast_two_sum(th, tl)


def sqrt_(x: DD) -> DD:
    """sqrt of a nonnegative dd (one Newton/Heron correction of the f64
    root: s + (x − s²)/(2s), accurate to ~3u²). x <= 0 propagates the
    f64 sqrt's NaN/0 — callers treat NaN as factorization failure."""
    s = torch.sqrt(x[0])
    r = sub(x, mul_ff(s, s))
    t = r[0] / torch.where(s > 0, 2.0 * s, 1.0)
    return fast_two_sum(s, torch.where(s > 0, t, torch.zeros_like(t)))


# ---------------------------------------------------------------------------
# Reductions / linear algebra
# ---------------------------------------------------------------------------

def _pad_even(h, l, axis):
    """One zero appended along ``axis`` when its length is odd (the
    reference's ``jnp.pad``)."""
    if h.shape[axis] % 2:
        shape = list(h.shape)
        shape[axis] = 1
        h = torch.cat([h, h.new_zeros(shape)], dim=axis)
        l = torch.cat([l, l.new_zeros(shape)], dim=axis)
    return h, l


def sum_(x: DD, axis: int = -1) -> DD:
    """Compensated sum along ``axis``: pairwise dd-add tree, log₂(n)
    levels of full-width elementwise ops (element 2k added to 2k+1 at each
    level, as in the reference)."""
    h, l = x
    axis = axis % h.dim()
    while h.shape[axis] > 1:
        h, l = _pad_even(h, l, axis)
        n = h.shape[axis]
        h2 = h.unflatten(axis, (n // 2, 2))
        l2 = l.unflatten(axis, (n // 2, 2))
        h, l = add((h2.select(axis + 1, 0), l2.select(axis + 1, 0)),
                   (h2.select(axis + 1, 1), l2.select(axis + 1, 1)))
    return h.squeeze(axis), l.squeeze(axis)


def dot(a, b) -> DD:
    """Compensated inner product of two f64 vectors along the last axis
    (Dot2-grade accuracy: exact products + dd tree sum)."""
    p = two_prod(a, b)
    return sum_(p, axis=-1)


def matvec(A, x) -> DD:
    """A @ x with exact elementwise products and dd row sums.

    A: (..., m, n) f64, x: (..., n) f64 → dd (..., m). One broadcasted
    two-prod plus log₂(n) vector adds."""
    p = two_prod(A, x.unsqueeze(-2))
    return sum_(p, axis=-1)


def ewmul_vec(a, x) -> DD:
    """Elementwise a∘x of two f64 vectors as exact dd."""
    return two_prod(a, x)
