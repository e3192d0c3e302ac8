#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the port (``mdqe_cvpr2023_tpu_torch``)
on a machine with as many CUDA cards as the cell asks for. It makes the
cell's weights and inputs from ``--seed``, loads and warms up (``setup_s``),
measures for ``--seconds``, checks what the measured path produced against
the plain reference (``benchmark/reference/``), and prints one JSON line
last on standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics; with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and last
``compared``, each number compared with its limit (also the last lines of
standard error).

``--sut control`` puts the reference, one precision step below the
configuration's, in the program's place (the control of the comparison).
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for p in (str(ROOT), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)


def _environment() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths (the
    port builds its kernels into ``build/kernels`` beside itself)."""
    base = ROOT / "build" / "bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["USE_FLAX"] = "0"


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             sut: str = "program", t0: float = None) -> dict:
    """Run ``cell`` (a ``manifest.Cell``) once on ``device``; returns the
    result's fields (``result_line`` prints them)."""
    import torch

    from benchlib import common, manifest
    ctx = common.Ctx(cell=cell, seed=int(seed), seconds=float(seconds), trace=bool(trace),
                     device=device, sut=sut, t0=T0 if t0 is None else t0)
    torch.manual_seed(common.salted(seed, 1))
    res = manifest.kind_module(cell).run(ctx)
    setup_s = res["window_start"] - ctx.t0
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = manifest.metric_reader(cell, m["name"]).read(res["obs"])
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        e2e = dict(res["e2e"], setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(e2e[m["name"]]), "unit": m["unit"]}
    if device == "cuda":
        kind = torch.cuda.get_device_name(0)
    else:
        kind = "cpu"
    dev = {"platform": "gpu" if device == "cuda" else "cpu", "kind": kind,
           "count": cell.chips, "memory_peak_bytes": int(res["memory_peak_bytes"])}
    if trace:
        dev.update(res["device_extra"])
    checks = res["checks"]
    out = {"correct": bool(checks) and all(c["ok"] for c in checks) and res["failed"] == 0,
           "attempted": int(res["attempted"]), "failed": int(res["failed"]),
           "metrics": metrics, "device": dev}
    if trace and res.get("breakdown"):
        out["breakdown"] = res["breakdown"]
    out["compared"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    out["_notes"] = dict(res.get("notes", {}), setup_s=setup_s)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--sut", choices=("program", "control"), default="program",
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    _environment()
    import torch

    from benchlib import hygiene, manifest
    cell = manifest.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", args.sut)
    found = hygiene.forbidden_loaded()
    if found:
        print(f"the process holds {found}: the benchmark runs no JAX", file=sys.stderr)
        return 3
    notes = out.pop("_notes")
    print(json.dumps({"notes": notes}), file=sys.stderr)
    for name, c in out["compared"].items():
        print(f"compared {name} = {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
