"""Benchmark of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json``: the configuration file
``port_bench/configs/<config>.json`` under the traffic mix
``port_bench/traffic/<traffic>.json``.  Set-up makes the weights and a pool
of rate-coded rasters on the card from ``--seed`` and drives the net through
its first batches (training: the recorded batches that the comparison
follows; frozen: one warm batch).  With ``--trace 0`` it then measures the
window, batch after batch with no synchronisation but the one that ends it,
and prints the cell's end-to-end metrics; with ``--trace 1`` it profiles a
stretch of whole batches and prints the cell's per-layer metrics, each read
by ``port_bench/metrics/<name>.py``.  After the window the same net runs one
more batch, recorded (training: on from the window's end state; frozen: a
window batch again, whose counts must equal the window's).  Either way the
last line of standard output is one JSON object; ``correct`` comes from the
comparison with the plain reference (``port_bench/check.py``) against the
limits in ``port_bench/limits/<cell>.json``.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import random  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

# top-level module names no run may load, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

# The harness's own settings, the same for every traffic mix of a mode.
POOL = {"train": 8, "eval": 4}            # distinct batches of rasters set-up makes
SETUP_BATCHES = {"train": 2, "eval": 1}   # batches set-up drives (training: recorded)
CHECK_DRAWS = 2                           # steps of the first batch drawn from the seed
MIN_WINDOW_BATCHES = 2                    # the window runs at least these
TRACE_BATCHES = 3                         # whole batches the traced run profiles


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


def recorded_steps(traffic: dict, seed: int) -> dict:
    """The steps the comparison follows, ``{batch: {step, ...}}``: the first
    three of the first batch and its last, a few more drawn from the seed,
    and, in training, the first step after the reset and one more of the
    second batch, and the first, the last and one more of the batch after
    the window."""
    rng = random.Random(seed)
    T = traffic["t_steps"]
    first = {0, 1, 2, T - 1} | set(rng.sample(range(3, T - 1), CHECK_DRAWS))
    if traffic["mode"] != "train":
        return {0: first}
    return {0: first, 1: {0, rng.randrange(1, T)}, 2: {0, rng.randrange(1, T - 1), T - 1}}


def run_cell(spec: dict, seed: int, seconds: float, trace: int, device,
             make_net=None, t_start: float | None = None) -> tuple[dict, dict]:
    """Set-up, the window (or the traced stretch) and the comparison of one
    run.  Returns the result line and the numbers compared.  ``make_net``
    builds the system under test (the program's net unless the control
    puts the reference in its place)."""
    import torch

    from port_bench import check, inputs, system
    from port_bench.reference import snn as ref

    cfg, traffic, limits = spec["cfg"], spec["traffic"], spec["limits"]
    make_net = make_net or system.ProgramNet
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    # ---- set-up ----------------------------------------------------------
    marks = [("imports", time.perf_counter())]
    mode = traffic["mode"]
    weights = inputs.initial_weights(ref.weight_shapes(cfg), seed, device)
    pool = inputs.raster_pool(traffic, POOL[mode], seed, device)
    seed_weights = [w.to("cpu", copy=True) for w in weights]
    marks.append(("inputs", time.perf_counter()))
    net = make_net(cfg, traffic, weights, device)
    del weights
    marks.append(("net", time.perf_counter()))
    train = mode == "train"
    steps = recorded_steps(traffic, seed)
    recorder = system.Recorder(steps)
    first = SETUP_BATCHES[mode]
    if train:
        with net.recording(recorder):
            for i in range(first):
                recorder.start_batch(i % len(pool), follows=i > 0)
                recorder.batches[-1]["counts"] = net.run_batch(pool[i % len(pool)]).to("cpu")
    else:
        for i in range(first):
            net.run_batch(pool[i % len(pool)])
    sync()
    marks.append(("batches", time.perf_counter()))
    setup_s = marks[-1][1] - t_start - recorder.seconds
    print("port_bench: set-up " + ", ".join(
        f"{name} {t - prev:.3f} s" for (name, t), prev in
        zip(marks, [t_start] + [t for _, t in marks[:-1]]))
        + f" (copies for the comparison {recorder.seconds:.3f} s, left out)", file=sys.stderr)

    # ---- the window, or the traced stretch ---------------------------------
    # frozen: the counts of one window batch, drawn from the seed, are kept
    keep_at = random.Random(seed + 1).randrange(MIN_WINDOW_BATCHES)
    kept: dict = {} if train else {keep_at: None}
    result: dict = {}
    if trace:
        from port_bench import trace as tracing

        n = TRACE_BATCHES
        tr = tracing.capture(net, pool, first, n, cfg, traffic, kept, device)
        metrics = {}
        for m in spec["per_layer"]:
            value = metric_reader(spec["root"], m["name"]).read(tr)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        attempted = n * traffic["batch"]
        device_info = {"busy_s": tr.busy_s, "window_s": tr.window_s}
        result["breakdown"] = tr.breakdown()
        print(f"port_bench: traced {tr.batches} batches, {tr.steps} steps, "
              f"{tr.window_s:.6f} s", file=sys.stderr)
    else:
        n = 0
        sync()
        t0 = time.perf_counter()
        while True:
            counts = net.run_batch(pool[(first + n) % len(pool)])
            if n in kept:
                kept[n] = counts
            n += 1
            if n >= MIN_WINDOW_BATCHES and time.perf_counter() - t0 >= seconds:
                break
        sync()
        window_s = time.perf_counter() - t0
        attempted = n * traffic["batch"]
        metrics = {"samples_per_s": {"value": attempted / window_s, "unit": "samples/s"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
        metrics = {m["name"]: metrics[m["name"]] for m in spec["end_to_end"]}
        device_info = {}
        print(f"port_bench: {n} batches in {window_s:.6f} s", file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    # ---- the batch after the window, recorded -------------------------------
    if train:
        # the next batch on from the window's end state, as the window would
        # have run it
        index = (first + n) % len(pool)
        with net.recording(recorder):
            recorder.start_batch(index, follows=False)
            recorder.batches[-1]["counts"] = net.run_batch(pool[index]).to("cpu")
    else:
        # the frozen net's answer: its call on that batch again, recorded,
        # must give the window's counts bit for bit
        recorder = system.Recorder({0: steps[0]})
        index = (first + keep_at) % len(pool)
        with net.recording(recorder):
            recorder.start_batch(index, follows=False)
            recorder.batches[0]["counts"] = net.run_batch(pool[index]).to("cpu")
        recorder.batches[0]["window_counts"] = kept[keep_at].to("cpu")

    # ---- the comparison ------------------------------------------------------
    del net
    kept.clear()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = check.check(cfg, traffic["rule"], train, recorder.batches, pool,
                          seed_weights, device)
    print(f"port_bench: comparison {time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    correct = check.verdict(numbers, limits)
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": peak, **device_info}
    line = {"correct": correct, "attempted": attempted, "failed": 0, "metrics": metrics,
            "device": device_info, **result, "checks": checks}
    return line, numbers


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
