"""Finds what BENCHMARK.json names: a cell's configuration file, its mix in
`mixes/<traffic>.json`, the op and corpus the mix names in `ops/` and
`corpora/`, and each metric's reader in `e2e_metrics/<name>.py` or
`layer_metrics/<name>.py`.  A cell is added by adding such files and
entries; nothing here changes."""

from __future__ import annotations

import importlib
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: pathlib.Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def mix(traffic: str) -> dict:
    return json.loads((HERE / "mixes" / f"{traffic}.json").read_text())


def op(name: str):
    return importlib.import_module(f"{__package__}.ops.{name}")


def corpus(name: str):
    return importlib.import_module(f"{__package__}.corpora.{name}")


def reader(kind: str, name: str):
    """The read(run) function of metric `name`, from `<kind>/<name>.py`."""
    path = HERE / kind / f"{name}.py"
    mod_name = f"{__package__}.{kind}.{name.replace('.', '__')}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None:
        raise KeyError(f"no reader {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics(bench: dict, cell_name: str, traced: bool) -> list:
    """The cell's metrics: untraced, the end-to-end metrics that list it or
    list no cells; traced, the per-layer metrics that list it, or that list
    no cells and move an end-to-end metric of the cell."""
    e2e = [m for m in bench["end_to_end"]
           if cell_name in m.get("workloads", [cell_name])]
    if not traced:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]
