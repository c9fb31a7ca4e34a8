"""XLA's CPU transcendentals, op by op, so that both devices give its bits.

XLA's CPU compiler does not call libm for f32 `exp`, `log` and `log1p`:
it inlines Eigen's polynomial approximations (Cephes' constants), and
its code generator contracts each multiply whose only use is an add into
one FMA. `function_score` (its decay functions and the
`field_value_factor` modifiers) runs these inside the reference's
compiled segment program. The functions below repeat the same steps in
f32 tensor ops, every contracted pair as one correctly rounded FMA
(`ops/knn.fma_rn`), so the port's results equal the reference's on the
CPU and on the card alike; torch's own `exp` / `log` / `log1p` differ
from XLA's by an ulp on 9%, 7% and 11% of inputs, and CUDA's from both.

Subnormal results flush to zero as XLA's runtime flushes them
(`ops/ordered.ftz`); a subnormal input reads as zero. XLA's f32 `sqrt`
is correctly rounded, and torch's vectorized one on the CPU is not:
take it with `ops/knn.sqrt_rn`. Division is correctly rounded on both
devices.
"""

from __future__ import annotations

import numpy as np
import torch

from .knn import fma_rn
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
    z = fma_rn(z, a * a, a)
    z = 1.0 + z
    pow2n = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
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
