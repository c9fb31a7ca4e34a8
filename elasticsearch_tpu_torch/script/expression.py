"""Script expressions: lexer, parser, AST and the interpreter.

Counterpart of `elasticsearch_tpu/script/expression.py` (ref:
script/ScriptService.java with the expression language of Lucene
expressions, plus the statement layer of update scripts). Scripts parse
to a closed AST that a tree-walking interpreter evaluates; the only
callables are the whitelisted math functions.

The AST evaluates on two backends:
  * device - `xp` is a `TorchBackend`: variables bind to whole doc-value
    columns [cap] and params [B, 1] on the searcher's device, and every
    operation gives the bits the reference's compiled XLA program gives
    (script query, script_score, script sort, script metric aggs);
  * host - `xp` is None: variables bind to Python scalars of one doc
    (script_fields, update scripts), exactly as in the reference.

On the device the reference's program is jnp traced into XLA, which
(a) types Python literals weakly, so they meet f32 columns as f32 and a
ternary of two int literals is int32; (b) rewrites a division by a
constant into a product with its f32 reciprocal and pow by the constants
0, 1, 2, 3, -1 into products; (c) contracts a product whose only use is
an add or a subtract into one FMA; (d) flushes subnormal results (its
CPU runtime runs with FTZ / DAZ); and (e) computes its transcendentals
with its own polynomials or the C library's (`ops/xla_math`). The
backend repeats all five: see `TorchBackend` and `_rich`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import ordered, xla_math
from ..ops.knn import fma_rn, sqrt_rn
from ..utils.errors import ScriptException

# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
# Lexer
# ---------------------------------------------------------------------------

_PUNCT2 = ("==", "!=", "<=", ">=", "&&", "||", "+=", "-=", "*=", "/=")
_PUNCT1 = "+-*/%()[].,;?:<>!=&|"


@dataclass
class Tok:
    kind: str   # num | str | name | punct | eof
    val: object
    pos: int


def tokenize(src: str) -> list[Tok]:
    toks: list[Tok] = []
    i, n = 0, len(src)
    while i < n:
        c = src[i]
        if c.isspace():
            i += 1
            continue
        if c.isdigit() or (c == "." and i + 1 < n and src[i + 1].isdigit()):
            j = i
            while j < n and (src[j].isdigit() or src[j] in ".eE" or
                             (src[j] in "+-" and src[j - 1] in "eE")):
                j += 1
            text = src[i:j]
            try:
                val = int(text)
            except ValueError:
                try:
                    val = float(text)
                except ValueError:
                    raise ScriptException(f"bad number [{text}] at {i}")
            toks.append(Tok("num", val, i))
            i = j
            continue
        if c in "'\"":
            j = i + 1
            while j < n and src[j] != c:
                j += 1
            if j >= n:
                raise ScriptException(f"unterminated string at {i}")
            toks.append(Tok("str", src[i + 1:j], i))
            i = j + 1
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (src[j].isalnum() or src[j] == "_"):
                j += 1
            toks.append(Tok("name", src[i:j], i))
            i = j
            continue
        if src[i:i + 2] in _PUNCT2:
            toks.append(Tok("punct", src[i:i + 2], i))
            i += 2
            continue
        if c in _PUNCT1:
            toks.append(Tok("punct", c, i))
            i += 1
            continue
        raise ScriptException(f"unexpected character [{c}] at {i}")
    toks.append(Tok("eof", None, n))
    return toks


# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Num:
    value: float


@dataclass(frozen=True)
class Str:
    value: str


@dataclass(frozen=True)
class Var:
    name: str


@dataclass(frozen=True)
class Attr:
    obj: object
    name: str


@dataclass(frozen=True)
class Index:
    obj: object
    key: object


@dataclass(frozen=True)
class Call:
    fn: object          # Var or Attr (Math.log)
    args: tuple


@dataclass(frozen=True)
class Unary:
    op: str
    x: object


@dataclass(frozen=True)
class Bin:
    op: str
    a: object
    b: object


@dataclass(frozen=True)
class Ternary:
    cond: object
    a: object
    b: object


@dataclass(frozen=True)
class Assign:
    target: object      # Var | Attr | Index
    op: str             # = += -= *= /=
    value: object


@dataclass(frozen=True)
class Block:
    stmts: tuple


class Parser:
    def __init__(self, src: str):
        self.toks = tokenize(src)
        self.i = 0

    def peek(self) -> Tok:
        return self.toks[self.i]

    def next(self) -> Tok:
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, val: str) -> None:
        t = self.next()
        if t.kind != "punct" or t.val != val:
            raise ScriptException(f"expected [{val}] at {t.pos}, got [{t.val}]")

    def parse_program(self):
        stmts = [self.parse_stmt()]
        while self.peek().kind == "punct" and self.peek().val == ";":
            self.next()
            if self.peek().kind == "eof":
                break
            stmts.append(self.parse_stmt())
        t = self.peek()
        if t.kind != "eof":
            raise ScriptException(f"unexpected [{t.val}] at {t.pos}")
        return stmts[0] if len(stmts) == 1 else Block(tuple(stmts))

    def parse_stmt(self):
        expr = self.parse_expr()
        t = self.peek()
        if t.kind == "punct" and t.val in ("=", "+=", "-=", "*=", "/="):
            self.next()
            if not isinstance(expr, (Var, Attr, Index)):
                raise ScriptException(f"invalid assignment target at {t.pos}")
            return Assign(expr, t.val, self.parse_expr())
        return expr

    def parse_expr(self):
        cond = self.parse_or()
        if self.peek().kind == "punct" and self.peek().val == "?":
            self.next()
            a = self.parse_expr()
            self.expect(":")
            b = self.parse_expr()
            return Ternary(cond, a, b)
        return cond

    def _binop(self, sub, ops):
        node = sub()
        while self.peek().kind == "punct" and self.peek().val in ops:
            op = self.next().val
            node = Bin(op, node, sub())
        return node

    def parse_or(self):
        return self._binop(self.parse_and, ("||",))

    def parse_and(self):
        return self._binop(self.parse_cmp, ("&&",))

    def parse_cmp(self):
        return self._binop(self.parse_add, ("==", "!=", "<", "<=", ">", ">="))

    def parse_add(self):
        return self._binop(self.parse_mul, ("+", "-"))

    def parse_mul(self):
        return self._binop(self.parse_unary, ("*", "/", "%"))

    def parse_unary(self):
        t = self.peek()
        if t.kind == "punct" and t.val in ("-", "!"):
            self.next()
            return Unary(t.val, self.parse_unary())
        return self.parse_postfix()

    def parse_postfix(self):
        node = self.parse_primary()
        while True:
            t = self.peek()
            if t.kind != "punct":
                return node
            if t.val == ".":
                self.next()
                name = self.next()
                if name.kind != "name":
                    raise ScriptException(f"expected name after '.' at {name.pos}")
                node = Attr(node, name.val)
            elif t.val == "[":
                self.next()
                key = self.parse_expr()
                self.expect("]")
                node = Index(node, key)
            elif t.val == "(":
                self.next()
                args = []
                if not (self.peek().kind == "punct" and self.peek().val == ")"):
                    args.append(self.parse_expr())
                    while self.peek().kind == "punct" and self.peek().val == ",":
                        self.next()
                        args.append(self.parse_expr())
                self.expect(")")
                node = Call(node, tuple(args))
            else:
                return node

    def parse_primary(self):
        t = self.next()
        if t.kind == "num":
            return Num(float(t.val))
        if t.kind == "str":
            return Str(t.val)
        if t.kind == "name":
            return Var(t.val)
        if t.kind == "punct" and t.val == "(":
            e = self.parse_expr()
            self.expect(")")
            return e
        raise ScriptException(f"unexpected token [{t.val}] at {t.pos}")


# ---------------------------------------------------------------------------
# Interpreter
# ---------------------------------------------------------------------------

_MATH1 = {
    "abs": abs, "ceil": math.ceil, "floor": math.floor, "exp": math.exp,
    "log": math.log, "ln": math.log, "log10": math.log10,
    "log2": lambda x: math.log2(x), "sqrt": math.sqrt, "sin": math.sin,
    "cos": math.cos, "tan": math.tan, "asin": math.asin, "acos": math.acos,
    "atan": math.atan, "sinh": math.sinh, "cosh": math.cosh,
    "tanh": math.tanh, "signum": lambda x: (x > 0) - (x < 0),
    "round": round, "log1p": math.log1p,
}
_MATH2 = {"pow": pow, "atan2": math.atan2, "min": min, "max": max,
          "hypot": math.hypot, "fmod": math.fmod}

# device variants: name -> method of TorchBackend (the reference's jnp names)
_XP1 = {"abs": "abs", "ceil": "ceil", "floor": "floor", "exp": "exp",
        "log": "log", "ln": "log", "log10": "log10", "log2": "log2",
        "sqrt": "sqrt", "sin": "sin", "cos": "cos", "tan": "tan",
        "asin": "arcsin", "acos": "arccos", "atan": "arctan",
        "sinh": "sinh", "cosh": "cosh", "tanh": "tanh", "signum": "sign",
        "round": "round", "log1p": "log1p"}
_XP2 = {"pow": "power", "atan2": "arctan2", "min": "minimum",
        "max": "maximum", "hypot": "hypot", "fmod": "fmod"}


# the functions whose last operation is a product that XLA may contract
# into a following add (jnp.exp: z * 2^n; log10 / log2: log(x) * c)
_PRODUCT_FNS = ("exp", "log10", "log2")


# ---------------------------------------------------------------------------
# Device backend
# ---------------------------------------------------------------------------

_RANK = {torch.bool: 0, torch.int32: 1, torch.float32: 2}


def _arrayish(v) -> bool:
    return isinstance(v, torch.Tensor)


def _dtype_of(v) -> torch.dtype:
    if isinstance(v, (_Prod, _Add)):
        return torch.float32
    if isinstance(v, torch.Tensor):
        return v.dtype
    if isinstance(v, bool):
        return torch.bool
    if isinstance(v, int):
        return torch.int32
    if isinstance(v, float):
        return torch.float32
    raise ScriptException(f"cannot use [{type(v).__name__}] in a device "
                          f"script")


class TorchBackend:
    """The evaluator's device backend (the reference's `xp = jnp`).

    Result dtypes follow JAX's promotion over the types a script can make
    (bool < int32 < float32, Python literals weak), so no int64 or f64
    tensor leaves the evaluator. Float adds, subtracts, multiplies and
    divides flush subnormal results (`ordered.ftz`); the math functions
    are XLA's (`ops/xla_math`)."""

    def __init__(self, device: torch.device):
        self.device = device

    # -- dtypes -------------------------------------------------------
    @staticmethod
    def result_dtype(*vals) -> torch.dtype:
        dt = torch.bool
        for v in vals:
            d = _dtype_of(v)
            if d not in _RANK:
                d = torch.float32 if d.is_floating_point else torch.int32
            if _RANK[d] > _RANK[dt]:
                dt = d
        return dt

    def cast(self, v, dtype: torch.dtype) -> torch.Tensor:
        if isinstance(v, torch.Tensor):
            return v if v.dtype == dtype else v.to(dtype)
        return torch.tensor(v, dtype=dtype, device=self.device)

    def f32(self, v) -> torch.Tensor:
        return self.cast(v, torch.float32)

    def operand(self, v, dtype: torch.dtype) -> torch.Tensor:
        """An arithmetic operand: f32 subnormals read as zero (DAZ)."""
        t = self.cast(v, dtype)
        return ordered.ftz(t) if dtype == torch.float32 else t

    # -- arithmetic ---------------------------------------------------
    def binary(self, op: str, a, b):
        dt = self.result_dtype(a, b)
        if op == "/":
            # true division (a constant divisor is a product by then:
            # `_dev_binop`)
            return ordered.ftz(self.operand(a, torch.float32)
                               / self.operand(b, torch.float32))
        if op == "%":
            return self.fmod(a, b)
        x, y = self.operand(a, dt), self.operand(b, dt)
        if dt == torch.bool:
            if op == "+":
                return x | y
            if op == "*":
                return x & y
            x, y = x.to(torch.int32), y.to(torch.int32)
            dt = torch.int32
        if op == "+":
            r = x + y
        elif op == "-":
            r = x - y
        elif op == "*":
            r = x * y
        else:
            raise ScriptException(f"unknown operator [{op}]")
        return ordered.ftz(r) if dt == torch.float32 else r

    def compare(self, op: str, a, b):
        dt = self.result_dtype(a, b)
        x, y = self.operand(a, dt), self.operand(b, dt)
        return {"==": torch.eq, "!=": torch.ne, "<": torch.lt,
                "<=": torch.le, ">": torch.gt, ">=": torch.ge}[op](x, y)

    def neg(self, v):
        return -v

    def fma(self, x, y, z) -> torch.Tensor:
        """fl(x * y + z), rounded once, flushed (a contracted pair)."""
        x, y, z = torch.broadcast_tensors(
            *(self.operand(v, torch.float32) for v in (x, y, z)))
        return ordered.ftz(fma_rn(x, y, z))

    def where(self, c, a, b):
        dt = self.result_dtype(a, b)
        return torch.where(c, self.cast(a, dt), self.cast(b, dt))

    def fmod(self, a, b):
        """The C library's fmodf (Java's %): exact, subnormals kept."""
        dt = self.result_dtype(a, b)
        return torch.fmod(self.cast(a, dt), self.cast(b, dt))

    # -- math functions (names of _XP1 / _XP2) ------------------------
    def _float(self, v) -> torch.Tensor:
        return self.operand(v, torch.float32)

    def abs(self, v):
        return torch.abs(v)

    def ceil(self, v):
        return v if v.dtype != torch.float32 \
            else torch.ceil(self.operand(v, torch.float32))

    def floor(self, v):
        return v if v.dtype != torch.float32 \
            else torch.floor(self.operand(v, torch.float32))

    def round(self, v):
        # jnp.round: half to even, like torch's
        return v if v.dtype != torch.float32 \
            else torch.round(self.operand(v, torch.float32))

    def sign(self, v):
        if v.dtype != torch.float32:
            return torch.sign(v)
        # jnp.sign keeps -0.0 and NaN; a subnormal reads as zero
        v = self.operand(v, torch.float32)
        one = torch.ones_like(v)
        return torch.where(v > 0, one, torch.where(v < 0, -one, v))

    def sqrt(self, v):
        return sqrt_rn(self._float(v))

    def exp(self, v):
        return xla_math.exp(self._float(v))

    def log(self, v):
        return xla_math.log(self._float(v))

    def log10(self, v):
        return ordered.ftz(xla_math.log10(self._float(v)))

    def log2(self, v):
        return xla_math.log2(self._float(v))

    def log1p(self, v):
        return xla_math.log1p(self._float(v))

    def sin(self, v):
        return xla_math.sin(self._float(v))

    def cos(self, v):
        return xla_math.cos(self._float(v))

    def tan(self, v):
        return xla_math.tan(self._float(v))

    def arcsin(self, v):
        return xla_math.asin(self._float(v))

    def arccos(self, v):
        return xla_math.acos(self._float(v))

    def arctan(self, v):
        return xla_math.atan(self._float(v))

    def sinh(self, v):
        return xla_math.sinh(self._float(v))

    def cosh(self, v):
        return xla_math.cosh(self._float(v))

    def tanh(self, v):
        return xla_math.tanh(self._float(v))

    def _pair(self, a, b) -> tuple[torch.Tensor, torch.Tensor]:
        return torch.broadcast_tensors(self._float(a), self._float(b))

    def power(self, a, b):
        prod = self.power_product(a, b)
        if prod is not None:
            return ordered.ftz(prod[0] * prod[1])
        if not _arrayish(b) and float(b) == 0.0:
            return torch.ones_like(self._float(a))
        if not _arrayish(b) and float(b) == 1.0:
            return self._float(a)
        if not _arrayish(b) and float(b) == -1.0:
            x = self._float(a)
            return ordered.ftz(torch.ones_like(x) / x)
        return xla_math.pow(*self._pair(a, b))

    def power_product(self, a, b):
        """XLA rewrites pow(x, 2) to x * x and pow(x, 3) to x * (x * x):
        -> the last product's operands, else None."""
        if _arrayish(b) or not _arrayish(a) or float(b) not in (2.0, 3.0):
            return None
        x = self._float(a)
        if float(b) == 2.0:
            return x, x
        return x, ordered.ftz(x * x)

    def rsqrt(self, v):
        """XLA's rsqrt (of a / sqrt(b)) runs the CPU's approximate
        reciprocal square root and Newton steps; the port takes the
        correctly rounded 1 / sqrt, within 1 ulp of it (ROADMAP
        departures)."""
        x = self._float(v).to(torch.float64)
        return ordered.ftz((1.0 / torch.sqrt(x)).to(torch.float32))

    def arctan2(self, a, b):
        return xla_math.atan2(*self._pair(a, b))

    def hypot(self, a, b):
        return xla_math.hypot(*self._pair(a, b))

    def minimum(self, a, b):
        dt = self.result_dtype(a, b)
        return torch.minimum(self.operand(a, dt), self.operand(b, dt))

    def maximum(self, a, b):
        dt = self.result_dtype(a, b)
        return torch.maximum(self.operand(a, dt), self.operand(b, dt))

    def product_parts(self, name: str, v) -> tuple:
        """(x, y) with fn(v) == fl(x * y) for the `_PRODUCT_FNS`."""
        v = self._float(v)
        if name == "exp":
            return xla_math.exp_parts(v)
        lg = xla_math.log(v)
        return lg, (xla_math.INV_LN10 if name == "log10"
                    else xla_math.INV_LN2)


# ---------------------------------------------------------------------------
# Interpreter
# ---------------------------------------------------------------------------


class DocAccessor:
    """`doc['field']` handle. Host backend: per-doc scalars; device
    backend: whole columns. Subclasses implement get()."""

    def get(self, field: str):  # -> object with .value/.empty
        raise NotImplementedError


class FieldHandle:
    __slots__ = ("value", "empty", "length", "lat", "lon", "rich")

    def __init__(self, value, empty, length=None, lat=None, lon=None,
                 rich=None):
        self.value = value
        self.empty = empty
        # device columns: (exists, column, 0.0), the select the value is
        self.rich = rich
        if length is None:
            # derive from `empty`: 0 when missing, 1 when present -
            # elementwise (int32) for device columns
            if isinstance(empty, torch.Tensor):
                length = 1 - empty.to(torch.int32)
            else:
                length = 0 if empty else 1
        self.length = length
        # geo accessors read 0.0 when absent (the same missing-as-zero
        # rule as .value) so scripts never see None
        self.lat = 0.0 if lat is None else lat
        self.lon = 0.0 if lon is None else lon


class Env:
    """Variable bindings for one evaluation."""

    def __init__(self, doc: DocAccessor | None = None,
                 params: dict | None = None, bindings: dict | None = None,
                 xp: TorchBackend | None = None):
        self.doc = doc
        self.params = params or {}
        self.bindings = bindings or {}
        self.locals: dict[str, object] = {}
        self.xp = xp  # None = pure-host scalars
        self.value_refs: dict[str, int] = {}

    def lookup(self, name: str):
        if name in self.locals:
            return self.locals[name]
        if name in self.bindings:
            return self.bindings[name]
        if name == "doc":
            if self.doc is None:
                raise ScriptException(
                    "doc values are not available in this context")
            return self.doc
        if name == "params":
            return self.params
        if name in self.params:
            return self.params[name]
        if name in ("Math", "math"):
            return _MATH_NS
        if name == "true":
            return True
        if name == "false":
            return False
        if name == "null":
            return None
        if name == "PI":
            return math.pi
        if name == "E":
            return math.e
        raise ScriptException(f"unknown variable [{name}]")


_MATH_NS = object()  # sentinel: Math.* namespace


def _truthy(v, xp):
    if xp is not None and _arrayish(v):
        return v if v.dtype == torch.bool else (v != 0)
    if isinstance(v, bool):
        return v
    if v is None:
        return False
    if isinstance(v, (int, float)):
        return v != 0
    return bool(v)


def _num(v):
    if isinstance(v, bool):
        return 1.0 if v else 0.0
    return v


@dataclass(frozen=True)
class _Const:
    """Pre-evaluated value wrapped as an AST node (compound assignment)."""
    value: object


def evaluate(node, env: Env):
    xp = env.xp
    if isinstance(node, _Const):
        return node.value
    if isinstance(node, Num):
        return node.value
    if isinstance(node, Str):
        return node.value
    if isinstance(node, Var):
        return env.lookup(node.name)
    if isinstance(node, Attr):
        obj = evaluate(node.obj, env)
        if obj is _MATH_NS:
            if node.name in ("PI",):
                return math.pi
            if node.name in ("E",):
                return math.e
            return ("__mathfn__", node.name)
        if isinstance(obj, FieldHandle):
            v = getattr(obj, node.name, None)
            if v is None and node.name not in ("lat", "lon"):
                raise ScriptException(
                    f"unknown doc-field property [{node.name}]")
            return v
        if isinstance(obj, DocAccessor):
            return obj.get(node.name)
        if isinstance(obj, dict):
            return obj.get(node.name)
        raise ScriptException(f"cannot access [.{node.name}]")
    if isinstance(node, Index):
        obj = evaluate(node.obj, env)
        key = evaluate(node.key, env)
        if isinstance(obj, DocAccessor):
            return obj.get(str(key))
        if isinstance(obj, dict):
            return obj.get(key)
        if isinstance(obj, (list, tuple)):
            return obj[int(key)]
        raise ScriptException("cannot index this value")
    if isinstance(node, Call):
        return _call(node, env)
    if isinstance(node, Unary):
        v = evaluate(node.x, env)
        if node.op == "-":
            v = _num(v)
            return xp.neg(v) if xp is not None and _arrayish(v) else -v
        t = _truthy(v, xp)
        if xp is not None and _arrayish(t):
            return ~t
        return not t
    if isinstance(node, Bin):
        return _binop(node, env)
    if isinstance(node, Ternary):
        c = _truthy(evaluate(node.cond, env), xp)
        if xp is not None and _arrayish(c):
            return xp.where(c, evaluate(node.a, env), evaluate(node.b, env))
        return evaluate(node.a, env) if c else evaluate(node.b, env)
    if isinstance(node, Assign):
        return _assign(node, env)
    if isinstance(node, Block):
        out = None
        for s in node.stmts:
            out = evaluate(s, env)
        return out
    raise ScriptException(f"cannot evaluate node {node!r}")


def _call_name(node: Call, env: Env) -> str:
    fn = node.fn
    if isinstance(fn, Var):
        return fn.name
    v = evaluate(fn, env)
    if isinstance(v, tuple) and len(v) == 2 and v[0] == "__mathfn__":
        return v[1]
    if callable(v):
        raise ScriptException("only math functions are callable")
    raise ScriptException("unknown function")


def _call(node: Call, env: Env):
    name = _call_name(node, env)
    args = [evaluate(a, env) for a in node.args]
    xp = env.xp
    arrayish = xp is not None and any(_arrayish(a) for a in args)
    if len(args) == 1 and name in _MATH1:
        if arrayish:
            return getattr(xp, _XP1[name])(args[0])
        return _MATH1[name](_num(args[0]))
    if len(args) == 2 and name in _MATH2:
        if arrayish:
            return getattr(xp, _XP2[name])(args[0], args[1])
        return _MATH2[name](_num(args[0]), _num(args[1]))
    raise ScriptException(f"unknown function [{name}/{len(args)}]")


# ---------------------------------------------------------------------------
# Device arithmetic with XLA's contraction
#
# The reference's program reaches LLVM as IR in which a doc value is
# select(exists, column, 0.0). Three rewrites decide which products end
# up fused into an FMA, and `_rich` repeats them:
#   * a product whose only use is an add or a subtract is contracted
#     (`_Prod` carries the product's operands until its use is known;
#     with two products the left one);
#   * an op with a constant on a select with a constant arm is moved into
#     the arms, select(c, y, k) op K -> select(c, y op K, k op K), when the
#     select has one use (LLVM's InstCombine; `_Sel`), so the product of
#     `doc['x'].value * K` sits inside an arm and fuses only with a
#     following constant add;
#   * x - select(c, y, 0.0) -> select(c, x - y, x), and likewise for the
#     other ops' identity constants (1.0 for * and /), which leaves x with
#     two uses and so unfused (LLVM's DAG combiner).
# ---------------------------------------------------------------------------


class _Prod:
    """A pending f32 product fl(x * y)."""

    __slots__ = ("x", "y")

    def __init__(self, x, y):
        self.x, self.y = x, y


class _Add:
    """A pending add of a constant, fl(x + k): XLA folds a second
    constant into k ((x + k1) + k2 -> x + fl(k1 + k2))."""

    __slots__ = ("x", "k")

    def __init__(self, x, k):
        self.x, self.k = x, k


class _Sel:
    """select(c, arm, k) of a Python constant k (in the false arm, or in
    the true arm when `flip`); `single`: the select has one use."""

    __slots__ = ("c", "arm", "k", "flip", "single")

    def __init__(self, c, arm, k, flip=False, single=True):
        self.c, self.arm, self.k, self.flip, self.single = \
            c, arm, k, flip, single


def _is_const(v) -> bool:
    return isinstance(v, (bool, int, float)) and not isinstance(v, _Prod)


def _mat(v, xp):
    """A rich device value -> a tensor or Python scalar."""
    if isinstance(v, _Prod):
        x, y = torch.broadcast_tensors(xp.operand(v.x, torch.float32),
                                       xp.operand(v.y, torch.float32))
        return ordered.ftz(x * y)
    if isinstance(v, _Add):
        return _mat(_dev_binop("+", v.x, xp.f32(v.k), xp), xp)
    if isinstance(v, _Sel):
        arm = _mat(v.arm, xp)
        return xp.where(v.c, v.k, arm) if v.flip else \
            xp.where(v.c, arm, v.k)
    return v


def _const_op(op: str, a, b) -> float:
    """A constant arm's op, folded in f32 (flushed) as LLVM folds it."""
    x, y = np.float32(a), np.float32(b)
    with np.errstate(all="ignore"):
        r = {"+": x + y, "-": x - y, "*": x * y, "/": x / y}[op]
    return float(ordered.ftz_np(np.asarray([r], np.float32))[0])


_IDENTITY = {"-": (0.0, False), "+": (-0.0, True), "*": (1.0, True),
             "/": (1.0, False)}   # op -> (identity, also on the left)


def _is_identity(k, op: str) -> bool:
    ident = _IDENTITY[op][0]
    return _is_const(k) and float(k) == ident and \
        math.copysign(1.0, float(k)) == math.copysign(1.0, ident)


def _row_invariant(v) -> bool:
    """Whether a value is the same for every doc of a row (params and
    constants): LLVM hoists its products out of the doc loop, where no
    add of a doc value can contract them."""
    if isinstance(v, _Prod):
        return _row_invariant(v.x) and _row_invariant(v.y)
    if isinstance(v, _Add):
        return _row_invariant(v.x)
    if isinstance(v, _Sel):
        return False
    return not _arrayish(v) or v.dim() == 0 or v.shape[-1] == 1


def _dev_binop(op: str, a, b, xp):
    """Device + - * / % on rich values (tensors, scalars, _Prod, _Add,
    _Sel), with XLA's and LLVM's rewrites."""
    if op == "-" and _is_const(b) and not _is_const(a):
        op, b = "+", _const_op("-", 0.0, b)      # XLA: x - k -> x + (-k)
    if op in ("*", "/") and _is_const(b) and float(b) == 1.0 \
            and _is_f32(a):
        return a                                 # XLA: x * 1, x / 1 -> x
    if op == "*" and _is_const(a) and float(a) == 1.0 and _is_f32(b):
        return b
    if op in ("+", "-", "*", "/"):
        # constant into a single-use select's arms (LLVM InstCombine)
        if isinstance(a, _Sel) and a.single and _is_const(b):
            if op == "/":
                op, b = "*", _const_op("/", 1.0, b)
            return _Sel(a.c, _dev_binop(op, a.arm, b, xp),
                        _const_op(op, a.k, b), a.flip)
        if isinstance(b, _Sel) and b.single and _is_const(a):
            return _Sel(b.c, _dev_binop(op, a, b.arm, xp),
                        _const_op(op, a, b.k), b.flip)
        # identity-constant select folds (LLVM's DAG combiner)
        for sel, other, left in ((b, a, False), (a, b, True)):
            if isinstance(sel, _Sel) and not _is_const(other) \
                    and _is_identity(sel.k, op) \
                    and (not left or _IDENTITY[op][1]):
                x = _mat(other, xp)
                arm = _mat(_dev_binop(op, sel.arm, x, xp) if left
                           else _dev_binop(op, x, sel.arm, xp), xp)
                return xp.where(sel.c, x, arm) if sel.flip \
                    else xp.where(sel.c, arm, x)
    if isinstance(a, _Sel):
        a = _mat(a, xp)
    if isinstance(b, _Sel):
        b = _mat(b, xp)
    if _is_const(a) and _is_const(b):
        return _binop_values(op, a, b, Env())
    # XLA folds a second constant: (x + k1) + k2, (x * k1) * k2
    if op == "+" and _is_const(b) and isinstance(a, _Add):
        return _Add(a.x, _const_op("+", a.k, b))
    if op == "+" and _is_const(a) and isinstance(b, _Add):
        return _Add(b.x, _const_op("+", b.k, a))
    if op == "*" and (_is_const(a) or _is_const(b)):
        k, x = (a, b) if _is_const(a) else (b, a)
        if isinstance(x, _Prod) and (_is_const(x.y) or _is_const(x.x)):
            kx, xx = (x.y, x.x) if _is_const(x.y) else (x.x, x.y)
            return _Prod(xx, _const_op("*", kx, k))
    if op in ("+", "-"):
        a = _mat(a, xp) if isinstance(a, _Add) else a
        b = _mat(b, xp) if isinstance(b, _Add) else b
    if op == "+" and (_is_const(a) or _is_const(b)) \
            and xp.result_dtype(a, b) == torch.float32:
        k, x = (a, b) if _is_const(a) else (b, a)
        return _Add(x, float(np.float32(k)))
    if op in ("+", "-") and (isinstance(a, _Prod) or isinstance(b, _Prod)):
        invariant = _row_invariant(a) and _row_invariant(b)
        if isinstance(a, _Prod) and (invariant or not _row_invariant(a)):
            z = _mat(b, xp)
            return xp.fma(a.x, a.y, xp.neg(xp.f32(z)) if op == "-" else z)
        if isinstance(b, _Prod) and (invariant or not _row_invariant(b)):
            x = b.x if op == "+" else -xp.f32(b.x)
            return xp.fma(x, b.y, _mat(a, xp))
    a, b = _mat(a, xp), _mat(b, xp)
    if op == "*" and xp.result_dtype(a, b) == torch.float32:
        return _Prod(_keep_const(a, xp), _keep_const(b, xp))
    if op == "/" and _is_const(b):
        return _Prod(xp.f32(a), _const_op("/", 1.0, b))
    return xp.binary(op, a, b)


def _is_f32(v) -> bool:
    return isinstance(v, (_Prod, _Add, _Sel)) or (
        _arrayish(v) and v.dtype == torch.float32)


def _keep_const(v, xp):
    return float(np.float32(v)) if _is_const(v) else xp.f32(v)


def _value_refs(ast) -> dict:
    """How many times the script reads each field's doc['f'].value: XLA
    merges the repeated selects into one of several uses."""
    refs: dict[str, int] = {}

    def visit(n):
        if isinstance(n, Attr) and n.name == "value" \
                and isinstance(n.obj, Index) and isinstance(n.obj.obj, Var) \
                and n.obj.obj.name == "doc" and isinstance(n.obj.key, Str):
            refs[n.obj.key.value] = refs.get(n.obj.key.value, 0) + 1

    _walk(ast, visit)
    return refs


def _rich(node, env: Env):
    """Evaluate a device operand keeping its product / select form."""
    xp = env.xp
    if isinstance(node, Bin) and node.op in ("+", "-", "*", "/", "%"):
        if node.op == "/":
            q = _rich_div(node, env)
            if q is not None:
                return q
        a = _rich(node.a, env)
        b = _rich(node.b, env)
        if isinstance(a, str) or isinstance(b, str) \
                or not (_is_device(a) or _is_device(b)):
            return _binop_values(node.op, _mat(a, xp), _mat(b, xp), env)
        return _dev_binop(node.op, _num(a), _num(b), xp)
    if isinstance(node, Attr) and node.name == "value":
        h = evaluate(node.obj, env)
        if isinstance(h, FieldHandle) and h.rich is not None:
            c, arm, k = h.rich
            key = node.obj.key.value if isinstance(node.obj, Index) \
                and isinstance(node.obj.key, Str) else None
            return _Sel(c, arm, k, single=env.value_refs.get(key, 0) == 1)
        return evaluate(node, env)
    if isinstance(node, Unary) and node.op == "-":
        v = _rich(node.x, env)
        if isinstance(v, _Prod):
            return _Prod(-xp.f32(v.x), v.y)
        if isinstance(v, _Sel) and v.single:
            inner = _rich_neg(v.arm, xp)
            return _Sel(v.c, inner, -float(v.k), v.flip)
        v = _num(_mat(v, xp))
        return xp.neg(v) if _arrayish(v) else -v
    if isinstance(node, Ternary):
        c = _truthy(evaluate(node.cond, env), xp)
        if _arrayish(c):
            a, b = _rich(node.a, env), _rich(node.b, env)
            for arm, k, flip in ((a, b, False), (b, a, True)):
                if _is_const(k) and not isinstance(k, bool) \
                        and _arrayish(_mat(arm, xp)) \
                        and _mat(arm, xp).dtype == torch.float32:
                    return _Sel(c, arm, float(k), flip)
            return xp.where(c, _mat(a, xp), _mat(b, xp))
        return _rich(node.a, env) if c else _rich(node.b, env)
    if isinstance(node, Call):
        name = _call_name(node, env)
        if name == "abs" and len(node.args) == 1:
            v = _rich(node.args[0], env)
            if isinstance(v, _Sel) and v.single:
                # LLVM folds fabs into a select of a constant arm
                return _Sel(v.c, xp.abs(_mat(v.arm, xp)), abs(v.k), v.flip)
            return _call(Call(Var(name), (_Const(_mat(v, xp)),)), env)
        if name in _PRODUCT_FNS + ("pow",) and len(node.args) \
                == (2 if name == "pow" else 1):
            args = [evaluate(a, env) for a in node.args]
            if name != "pow" and _arrayish(args[0]):
                return _Prod(*xp.product_parts(name, args[0]))
            if name == "pow":
                prod = xp.power_product(*args)
                if prod is not None:
                    return _Prod(*prod)
            return _call(Call(Var(name), tuple(_Const(a) for a in args)),
                         env)
    return evaluate(node, env)


def _is_device(v) -> bool:
    return isinstance(v, (_Prod, _Add, _Sel)) or _arrayish(v)


def _rich_div(node: Bin, env: Env):
    """XLA's division rewrites, where the quotient is a device value:
    a / (b / c) -> (a * c) / b, (a / b) / c -> a / (b * c) (c a doc
    value), a / exp(b) -> a * exp(-b), a / sqrt(b) -> a * rsqrt(b).
    None where none applies."""
    xp = env.xp
    na, nb = node.a, node.b
    if isinstance(nb, Bin) and nb.op == "/":
        a, b1, b2 = (_rich(n, env) for n in (na, nb.a, nb.b))
        if any(_is_device(v) for v in (a, b1, b2)) \
                and not any(isinstance(v, str) for v in (a, b1, b2)):
            return _dev_binop("/", _dev_binop("*", _num(a), _num(b2), xp),
                              _num(b1), xp)
        return None
    if isinstance(na, Bin) and na.op == "/":
        a1, a2, b = (_rich(n, env) for n in (na.a, na.b, nb))
        if _is_device(b) and not _row_invariant(b) \
                and not any(isinstance(v, str) for v in (a1, a2)):
            return _dev_binop("/", _num(a1),
                              _dev_binop("*", _num(a2), b, xp), xp)
        return None
    if isinstance(nb, Call) and len(nb.args) == 1:
        name = _call_name(nb, env)
        if name not in ("exp", "sqrt"):
            return None
        a = _rich(na, env)
        arg = evaluate(nb.args[0], env)
        if not _arrayish(arg) or isinstance(a, str):
            return None
        if name == "exp":
            den = xp.exp(xp.neg(xp.f32(arg)))
        else:
            den = xp.rsqrt(arg)
        return _dev_binop("*", _num(a), den, xp)
    return None


def _rich_neg(v, xp):
    if isinstance(v, _Prod):
        return _Prod(-xp.f32(v.x), v.y)
    v = _mat(v, xp)
    return xp.neg(v) if _arrayish(v) else -v


def _binop(node: Bin, env: Env):
    op = node.op
    xp = env.xp
    if op == "&&":
        a = _truthy(evaluate(node.a, env), xp)
        if xp is not None and _arrayish(a):
            return a & _truthy(evaluate(node.b, env), xp)
        return bool(a) and bool(_truthy(evaluate(node.b, env), xp))
    if op == "||":
        a = _truthy(evaluate(node.a, env), xp)
        if xp is not None and _arrayish(a):
            return a | _truthy(evaluate(node.b, env), xp)
        return bool(a) or bool(_truthy(evaluate(node.b, env), xp))
    if xp is not None and op in ("+", "-", "*", "/", "%"):
        return _mat(_rich(node, env), xp)
    return _binop_values(op, evaluate(node.a, env), evaluate(node.b, env),
                         env)


def _binop_values(op: str, a, b, env: Env):
    xp = env.xp
    device = xp is not None and (_arrayish(a) or _arrayish(b))
    if op in ("==", "!="):
        if device and not isinstance(a, str) and not isinstance(b, str) \
                and a is not None and b is not None:
            return xp.compare(op, _num(a), _num(b))
        return (a == b) if op == "==" else (a != b)
    if isinstance(a, str) or isinstance(b, str):
        if op == "+":
            return str(a) + str(b)
        if op in ("<", "<=", ">", ">="):
            pass  # fall through to comparisons below (string order)
        else:
            raise ScriptException(f"cannot apply [{op}] to strings")
    else:
        a = _num(a)
        b = _num(b)
    if device and op in ("+", "-", "*", "/", "%"):
        return xp.binary(op, a, b)
    if device and op in ("<", "<=", ">", ">="):
        return xp.compare(op, a, b)
    if op == "+":
        return a + b
    if op == "-":
        return a - b
    if op == "*":
        return a * b
    if op == "/":
        return a / b
    if op == "%":
        # Java remainder semantics (sign of dividend)
        return math.fmod(a, b)
    try:
        if op == "<":
            return a < b
        if op == "<=":
            return a <= b
        if op == ">":
            return a > b
        if op == ">=":
            return a >= b
    except TypeError:
        raise ScriptException(
            f"cannot compare [{type(a).__name__}] with "
            f"[{type(b).__name__}] using [{op}]")
    raise ScriptException(f"unknown operator [{op}]")


def _assign(node: Assign, env: Env):
    val = evaluate(node.value, env)
    tgt = node.target
    if node.op != "=":
        cur = evaluate(tgt, env)
        binop = node.op[0]
        val = _binop(Bin(binop, _Const(cur), _Const(val)), env)
    if isinstance(tgt, Var):
        env.locals[tgt.name] = val
        return val
    # resolve container then set
    obj = evaluate(tgt.obj, env)
    if isinstance(tgt, Attr):
        if isinstance(obj, dict):
            obj[tgt.name] = val
            return val
        raise ScriptException(f"cannot assign [.{tgt.name}]")
    key = evaluate(tgt.key, env)
    if isinstance(obj, dict):
        obj[key] = val
        return val
    if isinstance(obj, list):
        obj[int(key)] = val
        return val
    raise ScriptException("cannot assign to this target")


# ---------------------------------------------------------------------------
# Compiled script + field extraction
# ---------------------------------------------------------------------------


def _walk(node, visit) -> None:
    visit(node)
    for f in getattr(node, "__dataclass_fields__", {}):
        v = getattr(node, f)
        if isinstance(v, tuple):
            for x in v:
                if hasattr(x, "__dataclass_fields__"):
                    _walk(x, visit)
        elif hasattr(v, "__dataclass_fields__"):
            _walk(v, visit)


def referenced_fields(node) -> set[str]:
    """doc['field'] / doc.field references found in the AST."""
    out: set[str] = set()

    def visit(n):
        if isinstance(n, Index) and isinstance(n.obj, Var) \
                and n.obj.name == "doc" and isinstance(n.key, Str):
            out.add(n.key.value)
        if isinstance(n, Attr) and isinstance(n.obj, Var) \
                and n.obj.name == "doc":
            out.add(n.name)

    _walk(node, visit)
    return out


def uses_score(node) -> bool:
    found = []
    _walk(node, lambda n: found.append(1) if isinstance(n, Var)
          and n.name == "_score" else None)
    return bool(found)


class CompiledScript:
    """Parsed script ready to run against either backend."""

    def __init__(self, source: str):
        self.source = source
        self.ast = Parser(source).parse_program()
        self.fields = frozenset(referenced_fields(self.ast))
        self.needs_score = uses_score(self.ast)
        self.value_refs = _value_refs(self.ast)

    def run(self, *, doc: DocAccessor | None = None,
            params: dict | None = None, bindings: dict | None = None,
            xp: TorchBackend | None = None):
        env = Env(doc=doc, params=params, bindings=bindings, xp=xp)
        if xp is not None:
            env.value_refs = self.value_refs
            return _mat(_rich(self.ast, env), xp)
        return evaluate(self.ast, env)


def device_value(script: CompiledScript, doc: DocAccessor, params: dict,
                 bindings: dict, xp: TorchBackend, times=None):
    """Run a script on the device -> (value, None); with `times` (a
    function's weight), (value * times, its product operands (x, y) or
    None): the product is a bare one that XLA contracts into the add of a
    following function, unless LLVM moved it into a select's arm."""
    env = Env(doc=doc, params=params, bindings=bindings, xp=xp)
    env.value_refs = script.value_refs
    v = _rich(script.ast, env)
    if times is None:
        return _mat(v, xp), None
    v = _dev_binop("*", v, times, xp)
    if isinstance(v, _Prod):
        x, y = torch.broadcast_tensors(xp.operand(v.x, torch.float32),
                                       xp.operand(v.y, torch.float32))
        return ordered.ftz(x * y), (x, y)
    return _mat(v, xp), None


_COMPILE_CACHE: dict[str, CompiledScript] = {}


def compile_script(source: str) -> CompiledScript:
    """Compile with caching (ref: ScriptService compile cache)."""
    cs = _COMPILE_CACHE.get(source)
    if cs is None:
        if len(_COMPILE_CACHE) > 500:
            _COMPILE_CACHE.clear()
        cs = CompiledScript(source)
        _COMPILE_CACHE[source] = cs
    return cs
