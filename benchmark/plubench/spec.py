"""The benchmark's cells, found by name.

``BENCHMARK.json`` at the root of the checkout names each cell's
configuration and traffic mix. Everything that belongs to one of them sits
in a file of its own under the benchmark's folder, found by its name:

- ``configs/<config>.json``: the configuration's file, as BENCHMARK.json's
  ``configs[].file`` names it (the scene, its sizes, what was assumed);
- ``traffic/<mix>.json``: the traffic mix, parameters only: its ``kind``
  names the general generator that reads it, ``traffic/<kind>.py`` (a
  class ``Loop``), and every other key is a parameter of that generator,
  which overrides the configuration's key of the same name (a preview mix
  sets its own ``n``);
- ``metrics/<metric>.py``: the reader of one per-layer metric, a function
  ``read(ctx)`` that returns the value or None where it finds nothing.

Adding a cell, a mix or a metric is then new files plus entries.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import sys
from typing import Callable, Dict, List, Optional

HERE = pathlib.Path(__file__).resolve().parent.parent  # the benchmark's folder


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    workloads: Optional[List[str]]  # the cells that report it; None: every cell
    layer: Optional[str] = None  # per-layer metrics only
    moves: Optional[str] = None
    bound: Optional[float] = None  # end-to-end metrics only

    def in_cell(self, cell: str) -> bool:
        return self.workloads is None or cell in self.workloads


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration's file, with "name" and "path" added
    traffic: dict  # the mix's file, with "name" added
    end_to_end: List[Metric]
    per_layer: List[Metric]
    folder: pathlib.Path = HERE  # where its traffic and metric files were found

    @property
    def params(self) -> dict:
        """The configuration's keys with the mix's on top of them."""
        return {**self.config, **{k: v for k, v in self.traffic.items() if k != "name"}}


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _metrics(entries, cell: str, kind: str) -> List[Metric]:
    out = []
    for e in entries:
        m = Metric(name=e["name"], unit=e["unit"], better=e["better"], source=e["source"],
                   workloads=e.get("workloads"), layer=e.get("layer"), moves=e.get("moves"),
                   bound=e.get("bound"))
        if m.in_cell(cell):
            out.append(m)
    if not out:
        raise ValueError(f"cell {cell!r} reports no {kind} metric")
    return out


def find_cell(name: str, spec_path: pathlib.Path, folder: pathlib.Path = HERE) -> Cell:
    """The cell `name` of the BENCHMARK.json at spec_path, with its
    configuration's file (BENCHMARK.json's path, relative to the folder
    that holds it) and its mix's file (in `folder`'s traffic/) read."""
    spec = load_json(spec_path)
    root = spec_path.parent
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {spec_path} (have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    cfg_entry = configs[w["config"]]
    cfg_path = root / cfg_entry["file"]
    config = {**load_json(cfg_path), "name": cfg_entry["name"], "path": str(cfg_path)}
    traffic = {**load_json(folder / "traffic" / f"{w['traffic']}.json"), "name": w["traffic"]}
    return Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic,
                end_to_end=_metrics(spec["end_to_end"], name, "end-to-end"),
                per_layer=_metrics(spec["per_layer"], name, "per-layer"), folder=folder)


_LOADED: Dict[pathlib.Path, object] = {}


def _load(path: pathlib.Path, prefix: str):
    """The module in the file at path, loaded by its path (a name may hold
    dots), not imported by a module name; once a process."""
    path = path.resolve()
    if path not in _LOADED:
        if not path.is_file():
            raise FileNotFoundError(f"no file {path}")
        name = f"{prefix}_{path.stem.replace('.', '_').replace('-', '_')}"
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module  # its dataclasses look their module up
        spec.loader.exec_module(module)
        _LOADED[path] = module
    return _LOADED[path]


def metric_reader(name: str, folder: pathlib.Path = HERE) -> Callable:
    """The ``read`` function of metrics/<name>.py."""
    return _load(folder / "metrics" / f"{name}.py", "plubench_metric").read


def traffic_module(kind: str, folder: pathlib.Path = HERE):
    """The module traffic/<kind>.py."""
    return _load(folder / "traffic" / f"{kind}.py", "plubench_traffic")


def generator(kind: str, folder: pathlib.Path = HERE):
    """The ``Loop`` class of traffic/<kind>.py, the generator of every mix
    of that kind."""
    return traffic_module(kind, folder).Loop


def scene_file(config: dict) -> pathlib.Path:
    """The configuration's scene file, relative to the configuration's
    file."""
    return pathlib.Path(config["path"]).parent / config["scene"]


def read_metrics(metrics: List[Metric], ctx, folder: pathlib.Path = HERE) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of every per-layer metric whose reader finds
    something to read in ctx; the others are left out."""
    out = {}
    for m in metrics:
        value = metric_reader(m.name, folder)(ctx)
        if value is not None:
            out[m.name] = {"value": float(value), "unit": m.unit}
    return out
