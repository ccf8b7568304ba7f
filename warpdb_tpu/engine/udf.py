"""User-defined function registry.

JAX replacement for the reference's ``custom.cu`` convention
(jit.cpp:66-73: the file is slurped from the CWD at every JIT call and
prepended to the generated kernel source).  Here a UDF is any callable
over JAX arrays:

* ``register_udf(name, fn)`` — programmatic registration;
* a ``custom.py`` file in the working directory is auto-discovered, and
  every public top-level function in it is registered (the direct
  analogue of dropping ``__device__`` functions into ``custom.cu``,
  README.md:99-118) — Pallas kernels work here too, giving the same
  "escape hatch to raw kernels" the reference offered;
* the registry carries a version counter so compiled-plan caches are
  invalidated when UDFs change.

The stock ``discount(price, rate) = price * rate`` UDF from the
reference's shipped custom.cu is available as a fallback builtin.
"""

from __future__ import annotations

import os
import runpy
import threading
from typing import Callable, Optional

from ..errors import ValidationError

__all__ = ["register_udf", "resolve_udf", "registry_version", "load_custom_module"]

_lock = threading.Lock()
_registry: dict[str, Callable] = {}
_version = 0
_custom_py_mtime: Optional[float] = None


def _builtin_discount(price, rate):
    return price * rate


def _builtin_math() -> dict:
    """Standard scalar math builtins, lazily bound to jnp (user UDFs of
    the same name shadow them)."""
    import math

    import jax.numpy as jnp

    np_pi = math.pi

    def _coalesce(*args):
        if not args:
            raise ValidationError("COALESCE requires at least one argument")
        out = args[-1]
        for a in reversed(args[:-1]):
            out = jnp.where(jnp.isnan(a), out, a)
        return out

    def _nullif(a, b):
        return jnp.where(a == b, jnp.float32(float("nan")), a)

    def _fold(fn):
        def folded(*args):
            if not args:
                raise ValidationError("Function requires at least one argument")
            out = args[0]
            for a in args[1:]:
                out = fn(out, a)
            return out

        return folded

    def _round(x, n=None):
        # Two-arg SQL ROUND(x, n): n rides in as a traced f32 scalar, so
        # scale-round-unscale instead of jnp.round's static ``decimals``.
        if n is None:
            return jnp.round(x)
        p = jnp.power(jnp.float32(10.0), n)
        return jnp.round(x * p) / p

    def _trunc(x, n=None):
        if n is None:
            return jnp.trunc(x)
        p = jnp.power(jnp.float32(10.0), n)
        return jnp.trunc(x * p) / p

    def _log(a, b=None):
        # One arg: natural log (MySQL-style, kept for back-compat).
        # Two args: LOG(base, x) (PostgreSQL-style).
        if b is None:
            return jnp.log(a)
        return jnp.log(b) / jnp.log(a)

    return {
        "abs": jnp.abs,
        "sqrt": jnp.sqrt,
        "cbrt": jnp.cbrt,
        "log": _log,
        "ln": jnp.log,
        "log2": jnp.log2,
        "log10": jnp.log10,
        "exp": jnp.exp,
        "round": _round,
        "floor": jnp.floor,
        "ceil": jnp.ceil,
        "ceiling": jnp.ceil,
        "pow": jnp.power,
        "power": jnp.power,
        "sin": jnp.sin,
        "cos": jnp.cos,
        "tan": jnp.tan,
        "asin": jnp.arcsin,
        "acos": jnp.arccos,
        "atan": jnp.arctan,
        "atan2": jnp.arctan2,
        "sinh": jnp.sinh,
        "cosh": jnp.cosh,
        "tanh": jnp.tanh,
        "degrees": jnp.degrees,
        "radians": jnp.radians,
        "pi": lambda: jnp.float32(np_pi),
        "minimum": jnp.minimum,
        "maximum": jnp.maximum,
        # NULL handling (NaN is the engine's missing-value marker).
        "isnan": jnp.isnan,
        "nullval": lambda: jnp.float32(float("nan")),
        "coalesce": _coalesce,
        "nullif": _nullif,
        # CAST(x AS INT) lowers here (truncation toward zero, C-style);
        # the two-arg SQL form TRUNC(x, n) truncates to n decimals.
        "trunc": _trunc,
        "sign": jnp.sign,
        "fmod": jnp.fmod,
        "mod": jnp.fmod,
        # Variadic SQL spellings of min/max.
        "greatest": _fold(jnp.maximum),
        "least": _fold(jnp.minimum),
    }


_BUILTINS: dict[str, Callable] = {"discount": _builtin_discount}


def register_udf(name: str, fn: Optional[Callable]) -> None:
    """Register (or replace) a UDF callable over JAX arrays; ``fn=None``
    unregisters."""
    global _version
    with _lock:
        if fn is None:
            _registry.pop(name, None)
        else:
            _registry[name] = fn
        _version += 1


def load_custom_module(path: str = None) -> int:
    """(Re)load UDFs from a ``custom.py`` file if present and changed.

    Returns the number of functions registered.  Called lazily before each
    compile, mirroring the reference's read-custom.cu-per-JIT-call
    behavior — but cached on mtime so unchanged files cost one stat."""
    global _version, _custom_py_mtime
    if path is None:
        from ..config import get_config

        path = get_config().udf_module
    if not os.path.exists(path):
        return 0
    mtime = os.path.getmtime(path)
    with _lock:
        if mtime == _custom_py_mtime:
            return 0
        _custom_py_mtime = mtime
    ns = runpy.run_path(path)
    count = 0
    for name, obj in ns.items():
        if name.startswith("_"):
            continue
        if callable(obj) and getattr(obj, "__module__", None) != "builtins":
            register_udf(name, obj)
            count += 1
    return count


def resolve_udf(name: str) -> Callable:
    load_custom_module()
    with _lock:
        fn = _registry.get(name)
    if fn is None:
        fn = _BUILTINS.get(name) or _BUILTINS.get(name.lower())
    if fn is None:
        math = _builtin_math()
        fn = math.get(name) or math.get(name.lower())
    if fn is None:
        raise ValidationError(f"Unknown function: {name}")
    return fn


def registry_version() -> int:
    """Version stamp for kernel/memo cache keys.

    Loads ``custom.py`` first (mtime-cached — one stat when unchanged):
    without this, the FIRST query computed its memo keys at version 0,
    then ``resolve_udf``'s lazy load bumped the version mid-query, and
    every later identical query missed every version-keyed memo exactly
    once (observed as TPC-H q4 rebuilding its decorrelated EXISTS
    derived table and join on the second call)."""
    load_custom_module()
    with _lock:
        return _version
