"""The LM family: the port's LM training step (``repro_torch/train/
train_step.py``) on a dense decoder, built as ``launch/train.py`` builds it
(``port_bench/lm_system.py``), on token batches the benchmark draws.

Set-up draws the float32 master weights and a pool of token batches on the
card from ``--seed`` (``port_bench/lm_inputs.py``), builds the step and its
optimizer state, and runs the first steps through the window's call,
recorded: the reference follows them from the same weights
(``port_bench/lm_check.py``).  With ``--trace 0`` the window runs steps back
to back, with one synchronisation at its end; ``samples_per_s`` counts the
sequences of the window's whole steps over its whole time.  With ``--trace
1`` whole steps run under the profiler.  After the window the same trainer
runs one more step, recorded from its own state.  The host copies the
recorder takes are left out of ``setup_s``.
"""
from __future__ import annotations

import math
import sys
import time

import torch

from port_bench import lm_check, lm_faults, lm_system
from port_bench import trace as tracing
from port_bench.reference import lm as ref
from port_bench.run import metric_reader

POOL = 8                 # distinct token batches set-up draws
SETUP_STEPS = lm_check.FOLLOWED   # steps set-up runs, recorded
MIN_WINDOW_STEPS = 2     # the window runs at least these
TRACE_STEPS = 3          # whole steps the traced run profiles

NUMBERS = lm_check.NUMBERS
FAULTS = lm_faults.FAULTS
CONTROL = lm_system.ReferenceTrainer


def plant(fault: str, spec: dict):
    """The fault ``fault`` planted in the program for the cell ``spec``."""
    return lm_faults.plant(fault)


class _Copies:
    """Host copies for the comparison, their time kept apart from set-up's:
    the device's queue is drained first, outside the clock."""

    def __init__(self, device: torch.device):
        self.device, self.seconds = device, 0.0

    def __call__(self, tree):
        if tree is None:
            return None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        out = ref.unflatten(tree, [x.detach().to("cpu", copy=True) for x in ref.leaves(tree)])
        self.seconds += time.perf_counter() - t0
        return out


def _called(seen: dict) -> bool:
    return "grads" in seen and seen.get("updated", False)


def capture(trainer, pool: list, first: int, steps: int, cfg: dict, traffic: dict,
            device: torch.device) -> tracing.Trace:
    """Profile ``steps`` whole steps from pool index ``first`` on."""
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        with torch.profiler.record_function("port_bench.window"):
            for i in range(steps):
                trainer.step(pool[(first + i) % len(pool)])
            if cuda:
                torch.cuda.synchronize(device)
    return tracing.Trace(cfg=cfg, traffic=traffic, batches=steps, steps=steps,
                         update_device_us=0.0, launches={}, **tracing.events(prof))


def run_cell(spec: dict, seed: int, seconds: float, trace: int, device,
             make_net=None, t_start: float | None = None) -> tuple[dict, dict]:
    """Set-up, the window (or the traced stretch) and the comparison of one
    run.  Returns the result line and the numbers compared.  ``make_net``
    builds the trainer under test (the program's unless the control puts the
    reference in its place)."""
    from port_bench import lm_inputs

    cfg, traffic, limits = spec["cfg"], spec["traffic"], spec["limits"]
    make_net = make_net or lm_system.ProgramTrainer
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    # ---- set-up ----------------------------------------------------------
    marks = [("imports", time.perf_counter())]
    params = lm_inputs.initial_params(cfg, seed, device)
    pool = lm_inputs.token_pool(cfg, traffic, POOL, seed, device)
    marks.append(("inputs", time.perf_counter()))
    trainer = make_net(cfg, traffic, params, device)
    del params
    marks.append(("trainer", time.perf_counter()))
    copy = _Copies(device)
    records: dict = {"setup": []}
    for k in range(SETUP_STEPS):
        with trainer.recording() as seen:
            trainer.step(pool[k])
        records["setup"].append({"loss": seen.get("loss"), "called": _called(seen)})
        if k == 0:
            records["grads1"] = copy(seen.get("grads"))
            records["after1"] = copy(trainer.state())
        del seen
    records["params3"] = copy(trainer.state()["params"])
    sync()
    marks.append(("steps", time.perf_counter()))
    setup_s = marks[-1][1] - t_start - copy.seconds
    for rec in records["setup"]:
        rec["loss"] = math.nan if rec["loss"] is None else float(rec["loss"])
    print("port_bench: set-up " + ", ".join(
        f"{name} {t - prev:.3f} s" for (name, t), prev in
        zip(marks, [t_start] + [t for _, t in marks[:-1]]))
        + f" (copies for the comparison {copy.seconds:.3f} s, left out)", file=sys.stderr)

    # ---- the window, or the traced stretch ---------------------------------
    result: dict = {}
    if trace:
        n = TRACE_STEPS
        tr = capture(trainer, pool, SETUP_STEPS, n, cfg, traffic, device)
        metrics = {}
        for m in spec["per_layer"]:
            value = metric_reader(spec["root"], m["name"]).read(tr)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info = {"busy_s": tr.busy_s, "window_s": tr.window_s}
        result["breakdown"] = tr.breakdown()
        print(f"port_bench: traced {tr.steps} steps, {tr.window_s:.6f} s", file=sys.stderr)
    else:
        n = 0
        sync()
        t0 = time.perf_counter()
        while True:
            trainer.step(pool[(SETUP_STEPS + n) % POOL])
            n += 1
            if n >= MIN_WINDOW_STEPS and time.perf_counter() - t0 >= seconds:
                break
        sync()
        window_s = time.perf_counter() - t0
        metrics = {"samples_per_s": {"value": n * traffic["batch"] / window_s,
                                     "unit": "samples/s"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
        metrics = {m["name"]: metrics[m["name"]] for m in spec["end_to_end"]}
        device_info = {}
        print(f"port_bench: {n} steps in {window_s:.6f} s", file=sys.stderr)
    attempted = n * traffic["batch"]
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    # ---- the step after the window, recorded from the trainer's own state --
    index = (SETUP_STEPS + n) % POOL
    before = trainer.state()
    with trainer.recording() as seen:
        trainer.step(pool[index])
    sync()
    records["post"] = {"before": before, "grads": seen.get("grads"),
                       "after": trainer.state(), "called": _called(seen),
                       "loss": float(seen["loss"]) if "loss" in seen else math.nan,
                       "index": index, "steps_before": SETUP_STEPS + n}

    # ---- the comparison ------------------------------------------------------
    del trainer, seen, before
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = lm_check.check(cfg, traffic, records, pool, seed, device)
    print(f"port_bench: comparison {time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    correct = lm_check.verdict(numbers, limits)
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": peak, **device_info}
    line = {"correct": correct, "attempted": attempted, "failed": 0, "metrics": metrics,
            "device": device_info, **result, "checks": checks}
    return line, numbers
