"""The urn configuration language (REBOL-like, homoiconic).

Pure-Python, host-side reimplementation of the reference's DSL
(inc/urn.h + src/urn.cpp + docs/lang.md): tokenizer, the 12-variant Value
ADT, the do/reduce evaluator with scope stack and infix binary operators,
and the standard library (+, do, reduce, print, func, concat-all, append,
collect-range, block-format).
"""

from plubench.reference.urn.values import Value, Kind, UrnError
from plubench.reference.urn.tokenizer import TokenStream, Token, TokenType
from plubench.reference.urn.evaluator import EvalContext
from plubench.reference.urn.parser import parse, parse_one

__all__ = [
    "Value",
    "Kind",
    "UrnError",
    "TokenStream",
    "Token",
    "TokenType",
    "EvalContext",
    "parse",
    "parse_one",
]
