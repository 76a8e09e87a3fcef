"""urn recursive-descent parser: TokenStream -> Value.

Mirrors the reference's value(token_stream&) constructor (src/urn.cpp:7-65):
- num tokens with a '.' are Float, otherwise Int
- id tokens: leading ':' -> Val, leading '\'' -> Id, trailing ':' -> Def (whose
  payload is the *next* parsed value), otherwise Var
- '[' ... ']' -> Block, '(' ... ')' -> Group
"""

from __future__ import annotations

from typing import List

from plubench.reference.urn.tokenizer import Token, TokenStream, TokenType
from plubench.reference.urn.values import Kind, UrnError, Value

_CLOSERS = {"(": ")", "[": "]"}


def _parse_num(tok: Token) -> Value:
    if "." in tok.value:
        try:
            return Value.float_(float(tok.value))
        except ValueError:
            # atof semantics: parse the leading numeric prefix, else 0
            return Value.float_(_atof(tok.value))
    try:
        return Value.int_(int(tok.value))
    except ValueError:
        return Value.int_(_atoi(tok.value))


def _atof(s: str) -> float:
    for end in range(len(s), 0, -1):
        try:
            return float(s[:end])
        except ValueError:
            continue
    return 0.0


def _atoi(s: str) -> int:
    for end in range(len(s), 0, -1):
        try:
            return int(s[:end])
        except ValueError:
            continue
    return 0


def parse_one(ts: TokenStream) -> Value:
    """Parse a single value off the stream."""
    t = ts.next()
    if t.type is TokenType.NUM:
        return _parse_num(t)
    if t.type is TokenType.STR:
        return Value.string(t.value)
    if t.type is TokenType.ID:
        v = t.value
        if v.startswith(":"):
            return Value.val(v[1:])
        if v.startswith("'"):
            return Value.id_(v[1:])
        if v.endswith(":"):
            return Value.def_(v[:-1], parse_one(ts))
        return Value.var(v)
    if t.type is TokenType.CTRL:
        if t.value not in _CLOSERS:
            raise UrnError(f"line {t.line + 1}: unexpected '{t.value}'")
        end_char = _CLOSERS[t.value]
        kind = Kind.GROUP if t.value == "(" else Kind.BLOCK
        vs: List[Value] = []
        while ts.more():
            nt = ts.peek()
            if nt.type is TokenType.CTRL and nt.value == end_char:
                ts.next()
                break
            vs.append(parse_one(ts))
        return Value(kind, tuple(vs))
    raise AssertionError(t)


def parse(text: str) -> Value:
    """Parse a single top-level value from source text."""
    return parse_one(TokenStream(text))
