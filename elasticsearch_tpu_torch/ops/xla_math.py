"""XLA's CPU transcendentals, op by op, so that both devices give its bits.

XLA's CPU compiler does not call libm for f32 `exp`, `log`, `log1p`,
`tanh` and `expm1`: it inlines Eigen's polynomial approximations
(Cephes' constants) and its own rational tanh, expands `sinh`, `cosh`,
`log2` and `hypot` into those and plain ops, and its code generator
contracts each multiply whose only use is an add into one FMA.
`function_score` (its decay functions and the `field_value_factor`
modifiers) and device scripts run these inside the reference's compiled
segment program. The functions below repeat the same steps in f32 tensor
ops, every contracted pair as one correctly rounded FMA
(`ops/knn.fma_rn`), so the port's results equal the reference's on the
CPU and on the card alike; torch's own `exp` / `log` / `log1p` differ
from XLA's by an ulp on 9%, 7% and 11% of inputs, and CUDA's from both.
`sin`, `cos`, `tan`, `atan2` and `pow` are calls into the C library in
the reference; they are taken here in f64 and rounded once (1 ulp).

Subnormal results flush to zero as XLA's runtime flushes them
(`ops/ordered.ftz`); a subnormal input reads as zero. XLA's f32 `sqrt`
is correctly rounded, and torch's vectorized one on the CPU is not:
take it with `ops/knn.sqrt_rn`. Division is correctly rounded on both
devices.
"""

from __future__ import annotations

import numpy as np
import torch

from .knn import fma_rn, sqrt_rn
from .ordered import ftz


def _c(bits: int) -> float:
    """An f32 constant from the f64 hex spelling LLVM prints for it."""
    return float(np.float64(np.uint64(bits).view(np.float64)).astype(
        np.float32))


_EXP_LO = _c(0xC055F33340000000)        # -87.8
_EXP_HI = _c(0x4056333340000000)        # 88.8
_LOG2E = _c(0x3FF7154760000000)
_LN2_HI = _c(0x3FE6300000000000)        # 0.693359375
_LN2_LO = _c(0xBF2BD01060000000)        # -2.12194440e-4
_EXP_P = tuple(_c(b) for b in (0x3F2A0D2CE0000000, 0x3F56E879C0000000,
                               0x3F81112100000000, 0x3FA5553820000000,
                               0x3FC5555540000000))
_F32_MIN_NORMAL = _c(0x3810000000000000)
_SQRT_HALF = _c(0x3FE6A09E60000000)
_LOG_P = tuple(_c(b) for b in (
    0x3FB2043760000000, 0xBFBD7A3700000000, 0x3FBDE4A340000000,   # y
    0xBFBFCBA9E0000000, 0x3FC23D37E0000000, 0xBFC555CA00000000,   # y1
    0x3FC999D580000000, 0xBFCFFFFF80000000, 0x3FD5555540000000))  # y2
_LOG1P_SMALL = _c(0x3FDA8279A0000000)   # sqrt(2) - 1
_LOG1P_Q = tuple(_c(b) for b in (
    0x402E2035A0000000, 0x4054C30B60000000, 0x406BB865A0000000,
    0x4073519460000000, 0x406B0DB140000000, 0x404E0F3040000000))
_LOG1P_P = tuple(_c(b) for b in (
    0x3F07BC0960000000, 0x3FDFE818A0000000, 0x401A509F40000000,
    0x403DE97380000000, 0x404E798EC0000000, 0x404C8E75A0000000,
    0x40340A2020000000))
INV_LN10 = _c(0x3FDBCB7B20000000)       # 0.434294492, jnp.log10's factor


def _full(x: torch.Tensor, v: float) -> torch.Tensor:
    return torch.full_like(x, v)


def exp(x: torch.Tensor) -> torch.Tensor:
    """f32 exp as XLA's CPU code computes it (Cephes: x = n ln2 + a,
    a degree-5 polynomial for e^a, times 2^n built in the exponent)."""
    z, pow2n = exp_parts(x)
    return ftz(z * pow2n)


def _log_core(x: torch.Tensor) -> torch.Tensor:
    """Eigen's plog_float of a positive finite f32 (clamped to the
    smallest normal): frexp, the sqrt(1/2) fold, then the three
    interleaved polynomials."""
    x = torch.where(x > _F32_MIN_NORMAL, x, _full(x, _F32_MIN_NORMAL))
    bits = x.view(torch.int32)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    m = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32)
    small = m < _SQRT_HALF
    e = e - small.to(torch.float32)
    m = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    x2 = m * m
    x3 = x2 * m
    p = _LOG_P
    y = fma_rn(m, _full(m, p[0]), _full(m, p[1]))
    y1 = fma_rn(m, _full(m, p[3]), _full(m, p[4]))
    y2 = fma_rn(m, _full(m, p[6]), _full(m, p[7]))
    y = fma_rn(y, m, _full(m, p[2]))
    y1 = fma_rn(y1, m, _full(m, p[5]))
    y2 = fma_rn(y2, m, _full(m, p[8]))
    y = fma_rn(y, x3, y1)
    y = fma_rn(y, x3, y2)
    # fadd(fmul(y, x3), fmul(C2, e)): the first product is the one fused
    y = fma_rn(y, x3, e * _LN2_LO)
    r = fma_rn(_full(x2, -0.5), x2, m)
    r = r + y
    return fma_rn(e, _full(e, _LN2_HI), r)


def log(x: torch.Tensor) -> torch.Tensor:
    """f32 natural log as XLA's CPU code computes it; log(0) = -inf,
    log(inf) = inf, log of a negative or NaN = NaN."""
    x = ftz(x.to(torch.float32))
    r = _log_core(x)
    r = torch.where(x == 0, _full(r, float("-inf")), r)
    r = torch.where(x == float("inf"), _full(r, float("inf")), r)
    return torch.where((x < 0) | torch.isnan(x), _full(r, float("nan")), r)


def log10(x: torch.Tensor) -> torch.Tensor:
    """jnp.log10 as XLA compiles it: log(x) times f32(1 / ln 10)."""
    return log(x) * INV_LN10


def log1p(x: torch.Tensor) -> torch.Tensor:
    """f32 log1p as XLA's CPU code computes it: x - x^2/2 + x^3 P(x)/Q(x)
    below sqrt(2) - 1 in magnitude, log(1 + x) above."""
    x = ftz(x.to(torch.float32))
    big = log(x + 1.0)
    x2 = x * x
    q = fma_rn(_full(x, 1.0), x, _full(x, _LOG1P_Q[0]))
    for c in _LOG1P_Q[1:]:
        q = fma_rn(q, x, _full(x, c))
    p = fma_rn(_full(x, _LOG1P_P[0]), x, _full(x, _LOG1P_P[1]))
    for c in _LOG1P_P[2:]:
        p = fma_rn(p, x, _full(x, c))
    t = (x * x2) * (p / q)
    small = x + fma_rn(x2, _full(x2, -0.5), t)
    return torch.where(x.abs() < _LOG1P_SMALL, small, big)


def exp_parts(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """exp(x) as its last product (z, 2^n): the result is fl(z * 2^n),
    and XLA's code generator contracts that product into an add that
    takes the result as its only use (`exp` takes the product)."""
    x = ftz(x.to(torch.float32))
    x = torch.clamp(x, _EXP_LO, _EXP_HI)
    n = torch.floor(fma_rn(x, _full(x, _LOG2E), _full(x, 0.5)))
    n = torch.clamp(n, -127.0, 127.0)
    a = fma_rn(_full(n, -_LN2_HI), n, x)
    a = fma_rn(_full(n, -_LN2_LO), n, a)
    z = fma_rn(a, _full(a, _EXP_P[0]), _full(a, _EXP_P[1]))
    for p in _EXP_P[2:]:
        z = fma_rn(z, a, _full(a, p))
    z = fma_rn(z, a, _full(a, 0.5))
    z = fma_rn(z, ftz(a * a), a)
    z = ftz(1.0 + z)
    pow2n = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    return z, pow2n


# XLA's own f32 tanh: a rational function of the clamped input (its CPU
# code generator's approximation; constants as its LLVM IR prints them)
_TANH_TINY = _c(0x3F3A36E2E0000000)     # 0.0004: tanh(x) = x below
_TANH_CLAMP = _c(0x401FFEC880000000)    # 7.99881172
_TANH_NUM = tuple(_c(b) for b in (
    0xBCB3E4B800000000, 0x3D4C266FC0000000, 0xBDD7A6FFE0000000,
    0x3E6B800820000000, 0x3EEF286940000000, 0x3F44E1BDA0000000,
    0x3F740B3B80000000))
_TANH_DEN = tuple(_c(b) for b in (
    0x3EB41A7B00000000, 0x3F1F12BAC0000000, 0x3F629540A0000000,
    0x3F740B3BA0000000))
_LN2_F32 = _c(0x3FE62E4300000000)       # 0.693147182: sinh / cosh shift
INV_LN2 = _c(0x3FF7154760000000)        # 1.44269502, jnp.log2's factor


def tanh(x: torch.Tensor) -> torch.Tensor:
    """f32 tanh as XLA's CPU code computes it: x itself below 0.0004 in
    magnitude, +-1 from 20 on, else p(x) / q(x) on x clamped to
    +-7.99881172 (p odd of degree 13, q even of degree 6)."""
    x = x.to(torch.float32)
    xf = ftz(x)
    ax = xf.abs()
    xc = torch.clamp(xf, -_TANH_CLAMP, _TANH_CLAMP)
    x2 = ftz(xc * xc)
    p = fma_rn(x2, _full(x2, _TANH_NUM[0]), _full(x2, _TANH_NUM[1]))
    for c in _TANH_NUM[2:]:
        p = fma_rn(x2, ftz(p), _full(x2, c))
    num = ftz(xc * ftz(p))
    q = fma_rn(x2, _full(x2, _TANH_DEN[0]), _full(x2, _TANH_DEN[1]))
    for c in _TANH_DEN[2:]:
        q = fma_rn(x2, ftz(q), _full(x2, c))
    r = ftz(num / ftz(q))
    r = torch.where(ax < _TANH_TINY, x, r)
    return torch.where(ax >= 20.0, torch.copysign(torch.ones_like(x), x), r)


def expm1(x: torch.Tensor) -> torch.Tensor:
    """f32 expm1 as XLA's CPU code computes it: exp(x) - 1 above 0.5 in
    magnitude, else tanh(x / 2) * (exp(x) + 1); x itself where x / 2 is
    zero."""
    x = x.to(torch.float32)
    z, pow2n = exp_parts(x)
    e = ftz(z * pow2n)
    h = ftz(x * 0.5)
    small = ftz(tanh(h) * ftz(e + 1.0))
    r = torch.where(ftz(x).abs() > 0.5, ftz(e - 1.0), small)
    return torch.where(h == 0, x, r)


def sinh(x: torch.Tensor) -> torch.Tensor:
    """f32 sinh as XLA expands it: (r + r / (r + 1)) / 2 with r =
    expm1(x) below 1 in magnitude, else exp(x - ln2) - exp(-ln2 - x), the
    first exp's last product contracted into the subtraction."""
    x = x.to(torch.float32)
    r = expm1(x)
    small = ftz(ftz(r + ftz(r / ftz(r + 1.0))) * 0.5)
    za, pa = exp_parts(ftz(x - _LN2_F32))
    eb = exp(ftz(-_LN2_F32 - x))
    big = ftz(fma_rn(za, pa, -eb))
    return torch.where(ftz(x).abs() < 1.0, small, big)


def cosh(x: torch.Tensor) -> torch.Tensor:
    """f32 cosh as XLA expands it: exp(x - ln2) + exp(-ln2 - x), the
    first exp's last product contracted into the add."""
    x = x.to(torch.float32)
    za, pa = exp_parts(ftz(x - _LN2_F32))
    eb = exp(ftz(-_LN2_F32 - x))
    return ftz(fma_rn(za, pa, eb))


def log2(x: torch.Tensor) -> torch.Tensor:
    """jnp.log2 as XLA compiles it: log(x) times f32(1 / ln 2)."""
    return ftz(log(x) * INV_LN2)


def hypot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """jnp.hypot as XLA compiles it: m * sqrt((n / m)^2 + 1) of m = max,
    n = min of the magnitudes (the square contracted into the add), m
    where m is 0, inf where either is infinite."""
    ax = ftz(x.to(torch.float32)).abs()
    ay = ftz(y.to(torch.float32)).abs()
    inf = (ax == float("inf")) | (ay == float("inf"))
    mx = torch.maximum(ay, ax)
    mn = torch.minimum(ay, ax)
    zero = mx == 0
    d = ftz(mn / torch.where(zero, torch.ones_like(mx), mx))
    s = sqrt_rn(ftz(fma_rn(d, d, torch.ones_like(d))))
    r = torch.where(zero, mx, ftz(mx * s))
    return torch.where(inf, torch.full_like(r, float("inf")), r)


# ---------------------------------------------------------------------------
# libm calls. XLA's CPU code calls the C library's sinf, cosf, tanf,
# atan2f and powf (its LLVM IR keeps `llvm.sin` and the like, which the
# backend lowers to those calls). Their code is not repeated here: each is
# taken in f64 and rounded once to f32, which stays within 1 ulp of the
# library's result (the tests measure it on 2^20 seeded inputs a
# function). Subnormal inputs read as zero and subnormal results flush,
# as XLA's runtime has them.
# ---------------------------------------------------------------------------


def _f64_rounded(fn, *args: torch.Tensor) -> torch.Tensor:
    xs = [ftz(a.to(torch.float32)).to(torch.float64) for a in args]
    return ftz(fn(*xs).to(torch.float32))


def _subnormal(x: torch.Tensor) -> torch.Tensor:
    return (x != 0) & (x.abs() < _F32_MIN_NORMAL)


def sin(x: torch.Tensor) -> torch.Tensor:
    """sinf; a subnormal x comes back as it is (the library returns x
    itself below 2^-12, and no arithmetic flushes it)."""
    x = x.to(torch.float32)
    return torch.where(_subnormal(x), x, _f64_rounded(torch.sin, x))


def cos(x: torch.Tensor) -> torch.Tensor:
    return _f64_rounded(torch.cos, x)


def tan(x: torch.Tensor) -> torch.Tensor:
    """tanf; a subnormal x comes back as it is, as from sinf."""
    x = x.to(torch.float32)
    return torch.where(_subnormal(x), x, _f64_rounded(torch.tan, x))


def atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """atan2f as it runs under XLA's flush: a subnormal y over x == 1
    comes back as it is (the library's atanf(y) branch), and two
    subnormal arguments give NaN (their quotient reads as 0 / 0)."""
    y = y.to(torch.float32)
    x = x.to(torch.float32)
    r = _f64_rounded(torch.atan2, y, x)
    sy = _subnormal(y)
    r = torch.where(sy & (x == 1.0), y, r)
    return torch.where(sy & _subnormal(x), torch.full_like(r, float("nan")),
                       r)


def pow(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return _f64_rounded(torch.pow, x, y)


def atan(x: torch.Tensor) -> torch.Tensor:
    """jnp.arctan as XLA compiles it: atan2(x, 1)."""
    return atan2(x, torch.ones_like(x, dtype=torch.float32))


def _one_minus_sq_root(x: torch.Tensor) -> torch.Tensor:
    """sqrt((1 - x) * (x + 1)), each step rounded as XLA's program has it."""
    return sqrt_rn(ftz(ftz(1.0 - x) * ftz(x + 1.0)))


def asin(x: torch.Tensor) -> torch.Tensor:
    """jnp.arcsin as XLA expands it: 2 atan2(x, 1 + sqrt((1-x)(1+x)))."""
    x = ftz(x.to(torch.float32))
    a = atan2(x, ftz(_one_minus_sq_root(x) + 1.0))
    return ftz(a + a)


def acos(x: torch.Tensor) -> torch.Tensor:
    """jnp.arccos as XLA expands it: atan2(sqrt((1-x)(1+x)), x)."""
    x = ftz(x.to(torch.float32))
    return atan2(_one_minus_sq_root(x), x)
