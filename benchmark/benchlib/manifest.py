"""The benchmark's cells, resolved by name from ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration, a traffic mix and
its chips. Each is a file of its own under ``benchmark/``, found by name:

- ``configs/<config>.json``: the model, inference and training settings as
  run, with the published source, ``reduced`` and ``assumed``;
- ``traffic/<traffic>.json``: the mix's parameters, with ``kind`` naming the
  generator and runner ``kinds/<kind>.py``;
- ``metrics/<metric>.py``: a per-layer metric's reader (``read(obs)``);
- ``limits/<cell>.json``: the limit of each number the cell's correctness
  check compares.

The end-to-end metrics of a cell are those of ``end_to_end`` whose
``workloads`` list it (or that list none); its per-layer metrics those of
``per_layer`` whose ``workloads`` list it.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    limits: dict
    root: Path = field(default=HERE)


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"the benchmark has no {path.relative_to(HERE.parent)}")
    return json.loads(path.read_text())


def _applies(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_cell(name: str, root: Path = HERE, manifest_path: Path = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (beside ``root``'s parent
    unless ``manifest_path`` is given) with its files read."""
    manifest = _json(manifest_path or root.parent / "BENCHMARK.json")
    found = [w for w in manifest["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    config = _json(root / "configs" / f"{w['config']}.json")
    traffic = _json(root / "traffic" / f"{w['traffic']}.json")
    limits_path = root / "limits" / f"{name}.json"
    limits = _json(limits_path) if limits_path.is_file() else {}
    return Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic,
                end_to_end=[m for m in manifest["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in manifest["per_layer"] if name in m.get("workloads", [])],
                limits=limits, root=root)


def _load_module(path: Path, modname: str):
    if not path.is_file():
        raise FileNotFoundError(f"the benchmark has no {path.relative_to(HERE.parent)}")
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kind_module(cell: Cell):
    kind = cell.traffic["kind"]
    return _load_module(cell.root / "kinds" / f"{kind}.py", f"bench_kind_{kind}")


def metric_reader(cell: Cell, metric: str):
    return _load_module(cell.root / "metrics" / f"{metric}.py",
                        "bench_metric_" + metric.replace(".", "_").replace("-", "_"))
