"""urn evaluator: scope stack, do/reduce semantics, infix binary ops.

Mirrors the reference eval_context (inc/urn.h:243-287, src/urn.cpp:197-279):

- ``eval1`` resolves Var/Val lookups and Def bindings but keeps Blocks inert;
  Groups evaluate exactly one expression.
- ``eval`` is urn's ``do``: a Block opens a scope and evaluates expressions
  until exhausted, returning the last result.
- ``reduce`` maps every expression in a Block into a new Block.
- ``evaluate_expr`` performs function application by arity (arguments are
  ``eval1``'d, so Blocks pass through unevaluated) and greedy infix folding
  over registered binary operators. As in the reference, a function
  application consumes exactly len(argnames) following values and returns
  immediately (no infix continuation after a call), and a head written as
  ``:name`` is never applied.
"""

from __future__ import annotations

from typing import Dict, List

from plubench.reference.urn.values import Func, Kind, UrnError, Value


class EvalContext:
    def __init__(self) -> None:
        self.scopes: List[Dict[str, Value]] = [{}]
        self.binary_ops: set = set()

    # ---- scopes ----
    def push_scope(self) -> None:
        self.scopes.append({})

    def pop_scope(self) -> None:
        self.scopes.pop()

    def name_value(self, name: str, v: Value) -> Value:
        self.scopes[-1][name] = v
        return v

    def named_value(self, name: str) -> Value:
        for sc in reversed(self.scopes):
            if name in sc:
                return sc[name]
        return Value.null()

    def is_binary_op(self, name: str) -> bool:
        return name in self.binary_ops

    # ---- evaluation ----
    def eval1(self, v: Value) -> Value:
        k = v.kind
        if k in (Kind.INT, Kind.STRING, Kind.FLOAT, Kind.ID, Kind.BLOCK):
            return v
        if k is Kind.GROUP:
            i = [0]
            rv = self._evaluate_expr(v.items, i)
            if i[0] < len(v.items):
                raise UrnError("group must contain exactly one expression")
            return rv
        if k in (Kind.VAR, Kind.VAL):
            return self.named_value(v.payload)
        if k is Kind.DEF:
            name, dv = v.payload
            return self.name_value(name, self.eval1(dv))
        if k is Kind.NATIVE:
            return v.payload(self)
        if k in (Kind.NULL, Kind.FUNC):
            return v
        raise AssertionError(k)

    def eval(self, v: Value) -> Value:
        """do-semantics: evaluate a block's expressions, return the last."""
        if v.kind is Kind.BLOCK:
            self.push_scope()
            try:
                rv = Value.null()
                i = [0]
                while i[0] < len(v.items):
                    rv = self._evaluate_expr(v.items, i)
                return rv
            finally:
                self.pop_scope()
        return self.eval1(v)

    def reduce(self, v: Value) -> Value:
        """reduce-semantics: evaluate each expression into a new block."""
        if v.kind is Kind.BLOCK:
            self.push_scope()
            try:
                rv: List[Value] = []
                i = [0]
                while i[0] < len(v.items):
                    rv.append(self._evaluate_expr(v.items, i))
                return Value.block(rv)
            finally:
                self.pop_scope()
        return self.eval1(v)

    def _evaluate_expr(self, vs, i: List[int]) -> Value:
        fv = self.eval1(vs[i[0]])
        # Function application happens when a *bare word* (Var) resolves to a
        # function. The reference instead applies whenever the evaluated head
        # is a Func and wasn't written `:name` (src/urn.cpp:251), which makes
        # `inc: (func [a] [a + 1]) inc 3` re-apply at the Def and diverge —
        # contradicting its own spec (docs/lang.md "func" examples). We follow
        # the spec; every scene file behaves identically either way.
        if vs[i[0]].kind is Kind.VAR and not fv.is_null and fv.kind is Kind.FUNC:
            # function application: bind args (eval1'd) and eval the body
            fn: Func = fv.payload
            self.push_scope()
            try:
                i[0] += 1
                j = 0
                while i[0] < len(vs) and j < len(fn.argnames):
                    self.name_value(fn.argnames[j], self.eval1(vs[i[0]]))
                    i[0] += 1
                    j += 1
                return self.eval(fn.body)
            finally:
                self.pop_scope()
        # infix fold over registered binary operators
        while i[0] + 1 < len(vs) and vs[i[0] + 1].kind is Kind.VAR:
            op = vs[i[0] + 1].payload
            if not self.is_binary_op(op):
                break
            i[0] += 1
            fn = self.named_value(op).get_func()
            self.push_scope()
            try:
                self.name_value(fn.argnames[0], fv)
                i[0] += 1
                self.name_value(fn.argnames[1], self.eval1(vs[i[0]]))
                fv = self.eval(fn.body)
            finally:
                self.pop_scope()
        i[0] += 1
        return fv

    # ---- stdlib ----
    def create_std_funcs(self) -> "EvalContext":
        from plubench.reference.urn.stdlib import install_std_funcs

        install_std_funcs(self)
        return self
