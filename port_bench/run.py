"""Benchmark of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json``: the configuration file
``port_bench/configs/<config>.json`` under the traffic mix
``port_bench/traffic/<traffic>.json``, through the driver of the
configuration's family, ``port_bench/families/<family>.py`` (the file's
``family`` key; ``snn`` where it has none), loaded by path from the run's
root so that a family is added as a new file.  The family's set-up makes
the weights and the inputs on the card from ``--seed`` and drives the
system through its first recorded work; with ``--trace 0`` it then measures
the window, with no synchronisation but the one that ends it, and gives the
cell's end-to-end metrics; with ``--trace 1`` it profiles a stretch of the
same work and gives the cell's per-layer metrics, each read by
``port_bench/metrics/<name>.py``.  After the window it records more of the
same work and compares what the timed path produced with the plain
reference (``port_bench/reference/``) against the limits in
``port_bench/limits/<cell>.json``.  Either way the last line of standard
output is one JSON object, with ``correct`` and each number compared beside
its limit.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

# top-level module names no run may load, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def load_cell(name: str, root: Path = ROOT) -> dict:
    """The cell's entry, configuration, traffic mix, limits and metrics, found
    by name."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {c["name"]: c for c in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    cell = cells[name]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    here = root / "port_bench"
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name])]
    end_to_end = [m for m in bench["end_to_end"]
                  if name in m.get("workloads", [name])]
    return {
        "root": root,
        "cell": cell,
        "cfg": json.loads((root / config["file"]).read_text()),
        "traffic": json.loads((here / "traffic" / f"{cell['traffic']}.json").read_text()),
        "limits": json.loads((here / "limits" / f"{name}.json").read_text()),
        "per_layer": per_layer,
        "end_to_end": end_to_end,
    }


def metric_reader(root: Path, name: str):
    """The module ``port_bench/metrics/<name>.py`` under ``root``."""
    path = root / "port_bench" / "metrics" / f"{name}.py"
    module_spec = importlib.util.spec_from_file_location(f"port_bench.metrics.{name}", path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def family_module(spec: dict):
    """The module ``port_bench/families/<family>.py`` under the run's root
    that drives the cell's configuration: its file's ``family`` key, ``snn``
    where it has none."""
    name = spec["cfg"].get("family", "snn")
    path = spec["root"] / "port_bench" / "families" / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"no family {name!r}: {path} is not there")
    module_spec = importlib.util.spec_from_file_location(f"port_bench.families.{name}", path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module


def run_cell(spec: dict, seed: int, seconds: float, trace: int, device,
             make_net=None, t_start: float | None = None) -> tuple[dict, dict]:
    """Set-up, the window (or the traced stretch) and the comparison of one
    run, by the family of the cell's configuration.  Returns the result line
    and the numbers compared.  ``make_net`` builds the system under test in
    the program's place (the family's ``CONTROL``)."""
    return family_module(spec).run_cell(spec, seed, seconds, trace, device,
                                        make_net=make_net, t_start=t_start)


def main(argv=None, *, look_for_chip: bool = True, device=None, root: Path = ROOT) -> int:
    """One run; returns the exit code.  ``look_for_chip=False`` (the tests)
    skips the look for a card and runs on ``device``; ``root`` holds the
    ``BENCHMARK.json`` and the ``port_bench`` data files to read."""
    args = parse(argv)
    spec = load_cell(args.workload, root)
    import torch

    if look_for_chip:
        want = spec["cell"]["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < want:
            print(f"port_bench: needs {want} CUDA device(s); "
                  f"torch.cuda.is_available()={torch.cuda.is_available()}, "
                  f"device_count={torch.cuda.device_count()}", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    line, numbers = run_cell(spec, args.seed, args.seconds, args.trace, device,
                             t_start=T_START)
    found = forbidden_modules()
    if found:
        print(f"port_bench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for k, v in line["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r} "
              f"{'ok' if v['value'] <= v['limit'] else 'FAILED'}", file=sys.stderr)
    print(f"check steps {numbers['steps_checked']} correct {line['correct']}",
          file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
