"""urn lexer.

Token grammar (reference: inc/urn.h:33-111):
- reserved/terminator characters: ``[ ] ( )`` and whitespace
- numbers: a leading ``-`` or digit, continuing over digits and ``.``
- strings: double-quoted, no escapes, must close on the same line
- identifiers: any run of non-terminator characters (urn reserves *only*
  ``[]()`` plus the ``'``/``:`` identifier modifiers, which are handled at
  parse time, not lex time)
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Iterator, List, Optional


class TokenType(enum.Enum):
    ID = "id"
    NUM = "num"
    STR = "str"
    CTRL = "ctrl"


@dataclasses.dataclass(frozen=True)
class Token:
    line: int
    col: int
    type: TokenType
    value: str


_CTRL = frozenset("[]()")


def _is_term(c: str) -> bool:
    return c.isspace() or c in _CTRL


class TokenizeError(Exception):
    pass


def tokenize(text: str) -> List[Token]:
    """Lex the whole input into a token list."""
    toks: List[Token] = []
    for ln, line in enumerate(text.splitlines()):
        i = 0
        n = len(line)
        while i < n:
            c = line[i]
            if c.isspace():
                i += 1
                continue
            start = i
            if c in _CTRL:
                toks.append(Token(ln, start, TokenType.CTRL, c))
                i += 1
            elif c == "-" or c.isdigit():
                i += 1
                while i < n and (line[i] == "." or line[i].isdigit()):
                    i += 1
                toks.append(Token(ln, start, TokenType.NUM, line[start:i]))
            elif c == '"':
                i += 1
                j = i
                while j < n and line[j] != '"':
                    j += 1
                if j >= n:
                    raise TokenizeError(
                        f"line {ln + 1}: string literal didn't close"
                    )
                toks.append(Token(ln, start, TokenType.STR, line[i:j]))
                i = j + 1
            else:
                i += 1
                while i < n and not _is_term(line[i]):
                    i += 1
                toks.append(Token(ln, start, TokenType.ID, line[start:i]))
    return toks


class TokenStream:
    """Peekable stream over the token list (reference token_stream API)."""

    def __init__(self, text: str):
        self._toks = tokenize(text)
        self._pos = 0

    def next(self) -> Token:
        if self._pos >= len(self._toks):
            raise TokenizeError("unexpected end of input")
        t = self._toks[self._pos]
        self._pos += 1
        return t

    def peek(self, offset: int = 0) -> Optional[Token]:
        idx = self._pos + offset
        if idx >= len(self._toks):
            return None
        return self._toks[idx]

    def more(self) -> bool:
        return self._pos < len(self._toks)

    def __iter__(self) -> Iterator[Token]:
        while self.more():
            yield self.next()
