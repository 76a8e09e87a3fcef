"""urn standard library (reference: src/urn.cpp:285-395, spec docs/lang.md).

Functions: ``+`` (binary op: numeric add / block concat), ``do``, ``reduce``,
``print``, ``func``, ``concat-all``, ``append``, ``collect-range``,
``block-format``.

Natives are represented the same way as the reference: a Func whose body is a
NativeValue, so the ordinary application machinery binds arguments into a
fresh scope and the native closure reads them back by name.
"""

from __future__ import annotations

import sys
from typing import List

from plubench.reference.urn.evaluator import EvalContext
from plubench.reference.urn.values import Kind, Value


def _native_fn(argnames, fn) -> Value:
    return Value.func(argnames, Value.native(fn))


def _plus(cx: EvalContext) -> Value:
    a = cx.named_value("a")
    b = cx.named_value("b")
    if a.kind is Kind.INT:
        if b.kind is Kind.INT:
            return Value.int_(a.payload + b.payload)
        if b.kind is Kind.FLOAT:
            return Value.float_(a.payload + b.payload)
    elif a.kind is Kind.FLOAT:
        if b.kind in (Kind.INT, Kind.FLOAT):
            return Value.float_(a.payload + b.payload)
    elif a.kind is Kind.BLOCK and b.kind is Kind.BLOCK:
        return Value.block(a.items + b.items)
    return Value.null()


def _do(cx: EvalContext) -> Value:
    return cx.eval(cx.named_value("v"))


def _reduce(cx: EvalContext) -> Value:
    return cx.reduce(cx.named_value("v"))


def _print(cx: EvalContext) -> Value:
    sys.stdout.write(str(cx.named_value("v")))
    return Value.null()


def _func(cx: EvalContext) -> Value:
    argnames = [v.get_var() for v in cx.named_value("args").items]
    return Value.func(argnames, cx.named_value("body"))


def _concat_all(cx: EvalContext) -> Value:
    out: List[Value] = []
    for v in cx.named_value("vs").items:
        out.extend(v.items)
    return Value.block(out)


def _append(cx: EvalContext) -> Value:
    block = cx.named_value("block")
    return Value.block(block.items + (cx.named_value("value"),))


def _collect_range(cx: EvalContext) -> Value:
    rng = cx.named_value("range").items
    start = rng[0].get_int()
    end = rng[1].get_int()
    var_id = cx.named_value("var").get_id()
    body = cx.named_value("body")
    cx.push_scope()
    try:
        out = []
        for i in range(start, end):
            cx.name_value(var_id, Value.int_(i))
            out.append(cx.eval(body))
        return Value.block(out)
    finally:
        cx.pop_scope()


def _block_format_rec(fmt, vals) -> Value:
    out: List[Value] = []
    for v in fmt:
        if v.kind is Kind.VAL:
            try:
                idx = int(v.payload)
            except ValueError:
                out.append(v)
            else:
                out.append(vals[idx])
        elif v.kind is Kind.BLOCK:
            out.append(_block_format_rec(v.items, vals))
        else:
            out.append(v)
    return Value.block(out)


def _block_format(cx: EvalContext) -> Value:
    fmt = cx.named_value("format").items
    vals = cx.reduce(cx.named_value("values")).items
    return _block_format_rec(fmt, vals)


def install_std_funcs(cx: EvalContext) -> None:
    cx.binary_ops.add("+")
    cx.name_value("+", _native_fn(("a", "b"), _plus))
    cx.name_value("do", _native_fn(("v",), _do))
    cx.name_value("reduce", _native_fn(("v",), _reduce))
    cx.name_value("print", _native_fn(("v",), _print))
    cx.name_value("func", _native_fn(("args", "body"), _func))
    cx.name_value("concat-all", _native_fn(("vs",), _concat_all))
    cx.name_value("append", _native_fn(("block", "value"), _append))
    cx.name_value("collect-range", _native_fn(("var", "range", "body"), _collect_range))
    cx.name_value("block-format", _native_fn(("format", "values"), _block_format))
