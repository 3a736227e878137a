"""The readings that each limit of ``limits/<cell>.json`` is set from.

    python3 port_bench/readings.py --workload <cell> --seeds 1-12 \\
        [--control-seeds 101-103] [--fault-seeds 201-203] [--out FILE]

In one process, on the card: the program's numbers on ``--seeds`` (the
lower readings), the control's on ``--control-seeds`` (the family's
``CONTROL``: the plain reference in the program's place, a precision below
the configuration's: the upper readings), and each planted fault's (the
family's ``FAULTS``) on ``--fault-seeds``.  Every reading runs set-up and
the family's least window (``--seconds 0``).  Prints one JSON line per
reading and a summary: each number's largest program reading and its
smallest control and fault readings.  The benchmark's own runs never run
this.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1] / "src"),
                str(Path(__file__).resolve().parents[1])]

from port_bench import run  # noqa: E402


def seeds(text: str) -> list[int]:
    out = []
    for part in text.split(","):
        if "-" in part[1:]:
            lo, hi = part.split("-", 1)
            out.extend(range(int(lo), int(hi) + 1))
        elif part:
            out.append(int(part))
    return out


def reading(spec: dict, family, seed: int, device, *, control: bool = False,
            fault: str | None = None) -> dict:
    make_net = family.CONTROL if control else None
    planted = family.plant(fault, spec) if fault else contextlib.nullcontext()
    try:
        with planted:
            line, numbers = family.run_cell(spec, seed, 0.0, 0, device, make_net=make_net)
    except Exception as e:  # a fault that crashes the run gives no number
        return {"seed": seed, "control": control, "fault": fault, "error": repr(e)}
    return {"seed": seed, "control": control, "fault": fault,
            **{k: numbers[k] for k in family.NUMBERS if k in numbers},
            "correct": line["correct"], "peak": line["device"]["memory_peak_bytes"]}


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="1-12")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--faults", default="", help="comma-separated; all of the family's "
                    "FAULTS where empty")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    import torch

    device = device or torch.device("cuda", 0)
    spec = run.load_cell(args.workload)
    family = run.family_module(spec)
    rows = [reading(spec, family, s, device) for s in seeds(args.seeds)]
    rows += [reading(spec, family, s, device, control=True)
             for s in seeds(args.control_seeds)]
    fault_names = [f for f in args.faults.split(",") if f] or list(family.FAULTS)
    for f in fault_names:
        rows += [reading(spec, family, s, device, fault=f) for s in seeds(args.fault_seeds)]
    for r in rows:
        print(json.dumps(r), flush=True)
    summary = {}
    for k in family.NUMBERS:
        prog = [r[k] for r in rows if k in r and not r["control"] and not r["fault"]]
        summary[k] = {
            "program_max": max(prog) if prog else None,
            "control_min": min((r[k] for r in rows if k in r and r["control"]), default=None),
            **{f"{f}_min": min((r[k] for r in rows if k in r and r["fault"] == f),
                               default=None) for f in family.FAULTS}}
    print(json.dumps({"workload": args.workload, "summary": summary}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(json.dumps(r) for r in rows) + "\n"
                                  + json.dumps({"summary": summary}) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
