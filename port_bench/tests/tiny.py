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

SNN_CELLS = ("snn6400-train-b1024", "dcsnn-train-b4096", "snn6400-eval-b4096",
             "snn6400-train-exact-b256", "dcsnn-eval-b4096")
LM_CELLS = ("qwen3-train-4x2048",)
CELLS = SNN_CELLS + LM_CELLS
# an LM configuration cut to the port's smoke sizes (qwen3-0.6b's SMOKE)
LM_TINY = {"num_hidden_layers": 3, "hidden_size": 64, "intermediate_size": 128,
           "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 32,
           "vocab_size": 512}


def tiny_root(tmp: Path) -> Path:
    """A copy of ``BENCHMARK.json`` and ``port_bench/`` under ``tmp`` with the
    fc layers cut to 64 neurons, batches of 8 (the DCSNN 4) and 12 steps,
    and the LM configurations to ``LM_TINY`` with batches of 4 sequences of
    32 tokens, computing in float32 (a unit there holds a few dozen weights,
    and bfloat16's rounding alone moves its norms as far as the card's
    limits): every width the CPU cannot run in seconds cut, the limits as
    they are."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(ROOT / "port_bench", tmp / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for path in (tmp / "port_bench" / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        if cfg.get("family") == "lm":
            cfg.update(LM_TINY)
            cfg["assumed"]["compute_dtype"] = "float32"
        elif cfg["net"] == "2layer-snn":
            cfg["layers"][0]["out_features"] = 64
        path.write_text(json.dumps(cfg))
    for path in (tmp / "port_bench" / "traffic").glob("*.json"):
        traffic = json.loads(path.read_text())
        if "seq" in traffic:
            traffic.update(batch=4, seq=32)
        else:
            traffic.update(batch=4 if traffic["dataset"] == "fashion" else 8, t_steps=12)
        path.write_text(json.dumps(traffic))
    return tmp
