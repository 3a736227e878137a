#!/usr/bin/env python3
"""SASS instructions per element of the elementwise kernels with a loop
(8-10), read from ``cuobjdump -sass`` of the libraries the port builds,
and the time their issue takes on the card.  (Kernel 7 takes one group a
thread with no loop; bytes and the launch, not issue, set its time.)

For each kernel function of ``csrc/llsmu.cu`` and ``po2_quant.cu`` it
finds the loop (a backward branch) that stores the most
bytes per pass: the grid-stride loop over elements, or over four-element
vectors.  It counts that loop's instructions and divides by the elements
one pass handles (the bytes the pass stores over the bytes one element
writes).  Instructions split into memory (loads, stores), control
(branches, barriers), uniform (``U*``: one per warp, on the uniform
datapath) and the rest, the per-thread ALU instructions.  At ``n`` elements
the ALU instructions take at least ``n × ALU / (64 × SMs × clock)``: an
H100 SM issues 64 int32 lanes a clock (half its 128 float32 lanes), the
clock being ``clocks.max.sm`` from ``nvidia-smi``; and every instruction
at least ``n × all / (128 × SMs × clock)``, four warp schedulers issuing
one warp instruction a clock each.

The instruction-issue times are for 2^24 elements, the large size at which
``tools/time_kernels.py`` times kernels 7-10.  ``--src DIR`` reads another
checkout's ``src`` (an unpacked parent commit, say), built with that
checkout's own build module.  Run from the repository root on the GPU
machine:

    python3 tools/sass_count.py [--src DIR] [--label NAME]

It prints one line per kernel and, last, one JSON object.
"""
from __future__ import annotations

import argparse
import collections
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

from time_kernels import SIDE_LARGE as ELEMENTS  # noqa: E402
STEMS = ("llsmu", "po2_quant")
# bytes one element writes: one int32 or float32
OUT_BYTES = {"llsmu_multiply_kernel": 4, "po2_encode_kernel": 4, "po2_decode_kernel": 4}
MEMORY = ("LDG", "STG", "LDS", "STS", "LD", "ST", "LDC", "LDL", "STL", "ATOM", "RED")
CONTROL = ("BRA", "EXIT", "BSSY", "BSYNC", "BAR", "CALL", "RET", "WARPSYNC", "BMOV", "NOP",
           "YIELD", "JMP", "BREAK")
_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)\s*([^;]*);")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_FUNC = re.compile(r"Function\s*:\s*(\S+)")
_TARGET = re.compile(r"`\((\.L_x_\d+)\)|(0x[0-9a-f]+)")


def _cuobjdump() -> str:
    from repro_torch.kernels import _build

    nvcc = Path(_build._nvcc())
    path = nvcc.with_name("cuobjdump")
    if path.is_file():
        return str(path)
    which = shutil.which("cuobjdump")
    if which:
        return which
    raise SystemExit("sass_count: cuobjdump not found beside nvcc")


def _functions(sass: str) -> dict[str, list[tuple[int, str, str]]]:
    """Kernel name → [(address, opcode, operands)], a branch's target label
    resolved to the address of the instruction that follows the label."""
    funcs, name, pending = {}, None, []
    labels: dict[str, dict[str, int]] = {}
    for line in sass.splitlines():
        m = _FUNC.search(line)
        if m:
            name = m.group(1)
            funcs[name], labels[name], pending = [], {}, []
            continue
        if name is None:
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSTR.search(line)
        if m:
            addr = int(m.group(1), 16)
            for label in pending:
                labels[name][label] = addr
            pending = []
            funcs[name].append((addr, m.group(3), m.group(4).strip()))
    return {n: [(a, op, _resolve(args, labels[n]) if op.startswith("BRA") else args)
                for a, op, args in body] for n, body in funcs.items()}


def _resolve(args: str, labels: dict[str, int]) -> str:
    m = _TARGET.search(args)
    if not m:
        return args
    return hex(labels[m.group(1)]) if m.group(1) else m.group(2)


def _store_bytes(op: str) -> int:
    for suffix, n in ((".128", 16), (".64", 8), (".U16", 2), (".S16", 2), (".U8", 1),
                      (".S8", 1)):
        if suffix in op:
            return n
    return 4


def _hot_loop(body):
    """The backward-branch loop that stores the most bytes per pass:
    (instructions, stored bytes), or None."""
    best = None
    for i, (addr, op, args) in enumerate(body):
        if not op.startswith("BRA") or not args.startswith("0x"):
            continue
        target = int(args, 16)
        if target > addr:
            continue
        loop = [x for x in body[:i + 1] if x[0] >= target]
        stored = sum(_store_bytes(o) for _, o, _ in loop if o.startswith("STG"))
        if stored and (best is None or (stored, len(loop)) > (best[1], len(best[0]))):
            best = (loop, stored)
    return best


def _kind(op: str) -> str:
    base = op.split(".")[0]
    if base in MEMORY:
        return "memory"
    if base in CONTROL:
        return "control"
    if base.startswith("U") and base not in ("UNDEF",):
        return "uniform"
    return "alu"


def _pretty(mangled: str) -> str:
    for kernel in OUT_BYTES:
        if kernel in mangled:
            flag = re.search(r"ILb([01])E", mangled)
            return kernel + (f"<{'true' if flag.group(1) == '1' else 'false'}>" if flag else "")
    return mangled


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch is built and read")
    ap.add_argument("--label", default="", help="a name printed with every line")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))

    import torch

    if not torch.cuda.is_available():
        print("sass_count: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    label = args.label or str(Path(args.src).resolve())
    libs = _build.build_all()
    cuobjdump = _cuobjdump()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    clock_hz = float(re.search(r"(\d+)\s*MHz\s*$", smi).group(1)) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"[{label}] {smi}; {sms} SMs; {ELEMENTS} elements for the instruction-issue times",
          flush=True)
    results = []
    for stem in STEMS:
        sass = subprocess.run([cuobjdump, "-sass", str(libs[stem])], capture_output=True,
                              text=True, check=True, timeout=300).stdout
        for mangled, body in _functions(sass).items():
            name = _pretty(mangled)
            kernel = name.split("<")[0]
            if kernel not in OUT_BYTES:
                continue
            hot = _hot_loop(body)
            if hot is None:
                print(f"[{label}] {name}: no storing loop found", flush=True)
                continue
            loop, stored = hot
            per_pass = stored / OUT_BYTES[kernel]
            kinds = collections.Counter(_kind(op) for _, op, _ in loop)
            ops = collections.Counter(op.split(".")[0] for _, op, _ in loop
                                      if _kind(op) == "alu")
            per = {k: kinds[k] / per_pass for k in ("alu", "memory", "control", "uniform")}
            total = len(loop) / per_pass
            t_alu = ELEMENTS * per["alu"] / (64 * sms * clock_hz) * 1e3
            t_issue = ELEMENTS * total / (128 * sms * clock_hz) * 1e3
            top = ", ".join(f"{op} {n / per_pass:.2f}" for op, n in ops.most_common(12))
            print(f"[{label}] {name}: hot loop {len(loop)} instructions for {per_pass:g} "
                  f"element(s): {total:.2f} per element (ALU {per['alu']:.2f}, memory "
                  f"{per['memory']:.2f}, control {per['control']:.2f}, uniform "
                  f"{per['uniform']:.2f}); ALU issue at 64 lanes {t_alu:.5f} ms, all at 128 "
                  f"lanes {t_issue:.5f} ms for {ELEMENTS} elements; ALU per element: "
                  f"{top}", flush=True)
            results.append(dict(kernel=name, loop_instructions=len(loop),
                                elements_per_pass=per_pass, per_element=total,
                                alu_per_element=per["alu"], alu_issue_ms=t_alu,
                                issue_ms=t_issue, alu_ops=dict(ops)))
    print(json.dumps({"label": label, "card": smi, "sms": sms, "elements": ELEMENTS,
                      "kernels": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
