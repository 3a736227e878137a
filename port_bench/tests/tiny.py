"""Helpers of the benchmark's CPU tests: the repository on ``sys.path`` and a
copy of the benchmark's data files cut to a size the CPU runs in seconds."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

CELLS = ("snn6400-train-b256", "dcsnn-train-b2048", "snn6400-eval-b4096",
         "snn6400-train-exact-b256")


def tiny_root(tmp: Path) -> Path:
    """A copy of ``BENCHMARK.json`` and ``port_bench/`` under ``tmp`` with the
    fc layers cut to 64 neurons, batches of 8 (the DCSNN 4) and 12 steps:
    every width the CPU cannot run in seconds cut, the limits as they
    are."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(ROOT / "port_bench", tmp / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for path in (tmp / "port_bench" / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        if cfg["net"] == "2layer-snn":
            cfg["layers"][0]["out_features"] = 64
        path.write_text(json.dumps(cfg))
    for path in (tmp / "port_bench" / "traffic").glob("*.json"):
        traffic = json.loads(path.read_text())
        traffic.update(batch=4 if traffic["dataset"] == "fashion" else 8, t_steps=12)
        path.write_text(json.dumps(traffic))
    return tmp
