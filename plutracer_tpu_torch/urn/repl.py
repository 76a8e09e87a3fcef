"""Interactive urn REPL (reference: src/main.cpp:125-142, the ``/i`` flag).

Commands: ``:!q`` quits the REPL (continues to the renderer if a scene path
was given), ``:!x`` exits the process with status 42.
"""

from __future__ import annotations

import sys

from plutracer_tpu_torch.urn.evaluator import EvalContext
from plutracer_tpu_torch.urn.parser import parse
from plutracer_tpu_torch.urn.values import Kind, UrnError


def run_repl(stdin=None, stdout=None) -> None:
    stdin = stdin if stdin is not None else sys.stdin
    stdout = stdout if stdout is not None else sys.stdout
    cx = EvalContext().create_std_funcs()
    while True:
        stdout.write("urn> ")
        stdout.flush()
        line = stdin.readline()
        if not line:
            break
        if not line.strip():
            continue
        try:
            v = parse(line)
            if v.kind is Kind.VAL:
                cmd = v.get_val()
                if cmd == "!q":
                    break
                if cmd == "!x":
                    sys.exit(42)
            stdout.write(str(cx.eval(v)) + "\n")
        except (UrnError, Exception) as e:  # noqa: BLE001 - REPL keeps going
            if isinstance(e, SystemExit):
                raise
            stdout.write(f"error: {e}\n")
