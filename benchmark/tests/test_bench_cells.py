"""Cells are found by name from BENCHMARK.json, their files exist and keep
the contract's names, and a new cell is new files plus entries."""

import json
import re
import shutil

import pytest

from helpers import ROOT, SPEC, run_tiny
from plubench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads(SPEC.read_text())


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_found_by_name(cell):
    c = spec.find_cell(cell, SPEC)
    assert c.chips == 1
    assert spec.scene_file(c.config).is_file()
    assert "kind" in c.traffic
    assert any(m.name == "setup_s" for m in c.end_to_end)
    assert len(c.end_to_end) >= 2 and c.per_layer
    for m in c.per_layer:
        assert (spec.HERE / "metrics" / f"{m.name}.py").is_file()


def test_names_and_units_keep_the_contract():
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["traffic"] for w in BENCH["workloads"]]
    assert len(set(names) - {w["traffic"] for w in BENCH["workloads"]}) == len(names) - len(
        [w["traffic"] for w in BENCH["workloads"]])
    assert all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) for m in BENCH["end_to_end"] + BENCH["per_layer"])
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert all(m["moves"] in e2e for m in BENCH["per_layer"])
    assert all(m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.find_cell("no-such.cell", SPEC)


def test_a_new_cell_is_new_files_plus_entries(tmp_path):
    """A throwaway configuration, two mixes (one of a new kind) and a
    per-layer metric, written under TMPDIR beside copies of the harness's
    own files: found by name and run on the CPU, the mix's n over the
    configuration's, the new kind's generator found by its kind, the new
    metric read by its own reader."""
    folder = tmp_path / "bench"
    shutil.copytree(spec.HERE / "traffic", folder / "traffic")
    shutil.copytree(spec.HERE / "metrics", folder / "metrics")
    (folder / "configs").mkdir()
    scene = spec.HERE / "scenes" / "cornell-box.urn"
    (folder / "configs" / "tiny-box.json").write_text(json.dumps(
        {"scene": str(scene), "width": 8, "height": 8, "n": 2, "check_pixels": 8,
         "reduced": ["width", "height", "n"]}))
    (folder / "traffic" / "preview.json").write_text(json.dumps(
        {"kind": "render", "n": 1, "warmup": 1}))
    (folder / "traffic" / "twice.json").write_text(json.dumps({"kind": "render_twice"}))
    (folder / "traffic" / "render_twice.py").write_text(
        "from plubench import spec\n"
        "class Loop(spec.generator('render', spec.HERE)):\n"
        "    kind = 'render'\n"
        "    def _image(self, key):\n"
        "        super()._image(key)\n"
        "        return super()._image(key)\n")
    (folder / "metrics" / "images_in_window.py").write_text(
        "def read(ctx):\n    return ctx.items if ctx.items else None\n")
    bench = dict(BENCH)
    bench["configs"] = BENCH["configs"] + [
        {"name": "tiny-box", "source": "https://example.org/tiny", "why": "a test",
         "file": str(folder / "configs" / "tiny-box.json"), "reduced": ["width", "height", "n"]}]
    bench["workloads"] = BENCH["workloads"] + [
        {"name": "tiny-box.preview", "config": "tiny-box", "traffic": "preview", "chips": 1,
         "why": "a test"},
        {"name": "tiny-box.twice", "config": "tiny-box", "traffic": "twice", "chips": 1,
         "why": "a test"}]
    bench["end_to_end"] = [
        {**m, "workloads": m["workloads"] + ["tiny-box.twice"]}
        if m["name"] in ("samples_per_s", "image_ms.p95") else m for m in BENCH["end_to_end"]]
    bench["per_layer"] = BENCH["per_layer"] + [
        {"name": "images_in_window", "unit": "images", "better": "higher",
         "source": "host_clock", "layer": "pass loop", "moves": "samples_per_s",
         "workloads": ["tiny-box.preview"]}]
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    cell = spec.find_cell("tiny-box.preview", path, folder=folder)
    assert cell.traffic["name"] == "preview" and cell.folder == folder
    assert cell.params["n"] == 1
    result, _ = run_tiny(cell, trace=True)
    assert result["correct"]
    assert result["metrics"]["images_in_window"]["value"] >= 1
    assert "scene_compile_ms" in result["metrics"]
    twice = spec.find_cell("tiny-box.twice", path, folder=folder)
    result, _ = run_tiny(twice)
    assert result["correct"], result["checks"]
    assert result["metrics"]["samples_per_s"]["value"] > 0
