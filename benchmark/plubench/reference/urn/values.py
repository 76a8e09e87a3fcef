"""The urn Value ADT.

Twelve variants (reference: inc/urn.h:123-216):

==========  =====================  ==========================================
Kind        written as             payload
==========  =====================  ==========================================
NULL        --                     None
INT         ``123``                int
FLOAT       ``1.23``               float
STRING      ``"hi"``               str
VAR         ``thing``              str (name)
ID          ``'thing``             str (name)
DEF         ``thing: <v>``         (str, Value)
VAL         ``:thing``             str (name)
BLOCK       ``[ ... ]``            list[Value]
GROUP       ``( ... )``            list[Value]
FUNC        ``func [a] [a + 1]``   Func(argnames, body)
NATIVE      built-in               callable(EvalContext) -> Value
==========  =====================  ==========================================
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Sequence, Tuple


class UrnError(Exception):
    """Raised on malformed urn values or evaluation errors."""


class Kind(enum.Enum):
    NULL = "null"
    INT = "int"
    FLOAT = "float"
    STRING = "string"
    VAR = "var"
    ID = "id"
    DEF = "def"
    VAL = "val"
    BLOCK = "block"
    GROUP = "group"
    FUNC = "func"
    NATIVE = "native"


@dataclasses.dataclass(frozen=True)
class Func:
    argnames: Tuple[str, ...]
    body: "Value"


@dataclasses.dataclass(frozen=True)
class Value:
    kind: Kind
    payload: Any = None

    # ---- constructors ----
    @staticmethod
    def null() -> "Value":
        return _NULL

    @staticmethod
    def int_(v: int) -> "Value":
        return Value(Kind.INT, int(v))

    @staticmethod
    def float_(v: float) -> "Value":
        return Value(Kind.FLOAT, float(v))

    @staticmethod
    def string(v: str) -> "Value":
        return Value(Kind.STRING, v)

    @staticmethod
    def var(name: str) -> "Value":
        return Value(Kind.VAR, name)

    @staticmethod
    def id_(name: str) -> "Value":
        return Value(Kind.ID, name)

    @staticmethod
    def val(name: str) -> "Value":
        return Value(Kind.VAL, name)

    @staticmethod
    def def_(name: str, v: "Value") -> "Value":
        return Value(Kind.DEF, (name, v))

    @staticmethod
    def block(vs: Sequence["Value"]) -> "Value":
        return Value(Kind.BLOCK, tuple(vs))

    @staticmethod
    def group(vs: Sequence["Value"]) -> "Value":
        return Value(Kind.GROUP, tuple(vs))

    @staticmethod
    def func(argnames: Sequence[str], body: "Value") -> "Value":
        return Value(Kind.FUNC, Func(tuple(argnames), body))

    @staticmethod
    def native(fn: Callable[..., "Value"]) -> "Value":
        return Value(Kind.NATIVE, fn)

    # ---- accessors ----
    @property
    def is_null(self) -> bool:
        return self.kind is Kind.NULL

    def _expect(self, kind: Kind) -> Any:
        if self.kind is not kind:
            raise UrnError(f"expected value of type {kind.value}, got {self.kind.value}")
        return self.payload

    def get_int(self) -> int:
        return self._expect(Kind.INT)

    def get_str(self) -> str:
        return self._expect(Kind.STRING)

    def get_var(self) -> str:
        return self._expect(Kind.VAR)

    def get_id(self) -> str:
        return self._expect(Kind.ID)

    def get_def(self) -> Tuple[str, "Value"]:
        return self._expect(Kind.DEF)

    def get_func(self) -> Func:
        return self._expect(Kind.FUNC)

    def get_num(self) -> float:
        """Int or Float as a Python float (reference value::get_num)."""
        if self.kind is Kind.INT:
            return float(self.payload)
        if self.kind is Kind.FLOAT:
            return self.payload
        raise UrnError(f"expected value of type Int or Float, got {self.kind.value}")

    @property
    def items(self) -> Tuple["Value", ...]:
        """Children of a Block or Group."""
        if self.kind not in (Kind.BLOCK, Kind.GROUP):
            raise UrnError(
                f"expected value of type Block or Group, got {self.kind.value}"
            )
        return self.payload

    def __getitem__(self, ix: int) -> "Value":
        return self.items[ix]

    def __len__(self) -> int:
        return len(self.items)

    # ---- block utilities (reference value::named_block_val) ----
    def named_block_val(self, name: str) -> "Value":
        """Find ``name: <v>`` in this block and return ``<v>`` (Null if absent)."""
        for v in self.items:
            if v.kind is Kind.DEF and v.payload[0] == name:
                return v.payload[1]
        return _NULL

    def has_block_val_named(self, name: str) -> bool:
        return any(
            v.kind is Kind.DEF and v.payload[0] == name for v in self.items
        )

    # ---- printing (matches reference operator<<) ----
    def __str__(self) -> str:
        k = self.kind
        if k is Kind.NULL:
            return ""
        if k is Kind.INT:
            return str(self.payload)
        if k is Kind.FLOAT:
            return _fmt_float(self.payload)
        if k is Kind.STRING:
            return f'"{self.payload}"'
        if k is Kind.VAR:
            return self.payload
        if k is Kind.VAL:
            return f":{self.payload}"
        if k is Kind.ID:
            return f"'{self.payload}"
        if k is Kind.DEF:
            return f"{self.payload[0]}:{self.payload[1]}"
        if k is Kind.BLOCK:
            return "[ " + "".join(f"{x} " for x in self.payload) + "]"
        if k is Kind.GROUP:
            return "( " + "".join(f"{x} " for x in self.payload) + ")"
        if k is Kind.FUNC:
            fn = self.payload
            return (
                "func [ " + "".join(f"{n} " for n in fn.argnames) + "] " + str(fn.body)
            )
        if k is Kind.NATIVE:
            return "<native value>"
        raise AssertionError(k)

    def __repr__(self) -> str:
        return f"Value<{self}>"


def _fmt_float(f: float) -> str:
    # C++ default ostream formatting: 6 significant digits, no trailing zeros
    s = f"{f:.6g}"
    return s


_NULL = Value(Kind.NULL, None)
