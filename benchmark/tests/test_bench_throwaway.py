"""A cell added as files only: in a copy of the benchmark, a new
configuration, traffic mix and limits file and a new entry in the copy's
BENCHMARK.json; the harness finds them by name and runs the cell's set-up
and a window of no length on the CPU."""
from __future__ import annotations

import json
import shutil

from bench_tiny import BENCH, ROOT, SEED, run_tiny, shrink

from benchlib import manifest


def test_throwaway_workload_from_files(tmp_path):
    copy = tmp_path / "benchmark"
    shutil.copytree(BENCH, copy, ignore=shutil.ignore_patterns("__pycache__"))
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((BENCH / "configs" / "r50_ovis360.json").read_text())
    cfg["name"] = "throwaway_cfg"
    (copy / "configs" / "throwaway_cfg.json").write_text(json.dumps(cfg))
    traffic = json.loads((BENCH / "traffic" / "vis.json").read_text())
    traffic["frames"] = 6
    (copy / "traffic" / "throwaway_mix.json").write_text(json.dumps(traffic))
    limits = json.loads((BENCH / "limits" / "swinl_ovis.vis.json").read_text())
    (copy / "limits" / "throwaway_cfg.throwaway_mix.json").write_text(json.dumps(limits))
    man["workloads"].append({"name": "throwaway_cfg.throwaway_mix", "config": "throwaway_cfg",
                             "traffic": "throwaway_mix", "chips": 1, "why": "a test"})
    for m in man["end_to_end"] + man["per_layer"]:
        if "r50_ovis360.vis_crowded" in m.get("workloads", []):
            m["workloads"].append("throwaway_cfg.throwaway_mix")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))

    cell = manifest.load_cell("throwaway_cfg.throwaway_mix", root=copy)
    assert cell.root == copy and cell.traffic["frames"] == 6
    assert {m["name"] for m in cell.end_to_end} == {"vis_clips_per_s", "vis_video_p95_s",
                                                    "setup_s"}
    assert cell.limits == limits
    shrink(cell)
    cell.traffic["frames"] = 6
    out = run_tiny(cell, SEED, seconds=0.0)
    assert set(out["metrics"]) == {"vis_clips_per_s", "vis_video_p95_s", "setup_s"}
    assert out["attempted"] >= 1 and out["correct"]
