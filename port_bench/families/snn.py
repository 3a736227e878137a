"""The SNN family: the paper's spiking nets (``repro_torch.models.snn``),
trained with a learning rule or run frozen, batch after batch through the
trainer's per-batch loop (``port_bench/system.py``).

A configuration file with no ``family`` key runs here.  Set-up makes the
weights and a pool of rate-coded rasters on the card from ``--seed`` and
drives the net through its first batches (training: the recorded batches
that the comparison follows; frozen: one warm batch).  With ``--trace 0`` it
then measures the window, batch after batch with no synchronisation but the
one that ends it; with ``--trace 1`` it profiles a stretch of whole batches
and reads the cell's per-layer metrics.  After the window the same net runs
one more batch, recorded (training: on from the window's end state; frozen: a
window batch again, whose counts must equal the window's).  ``correct`` comes
from the comparison with the plain reference (``port_bench/check.py``)
against the limits in ``port_bench/limits/<cell>.json``.
"""
from __future__ import annotations

import random
import sys
import time

from port_bench import check, faults, system
from port_bench.run import metric_reader

# The family's own settings, the same for every traffic mix of a mode.
POOL = {"train": 8, "eval": 4}            # distinct batches of rasters set-up makes
SETUP_BATCHES = {"train": 2, "eval": 1}   # batches set-up drives (training: recorded)
CHECK_DRAWS = 2                           # steps of the first batch drawn from the seed
MIN_WINDOW_BATCHES = 2                    # the window runs at least these
TRACE_BATCHES = 3                         # whole batches the traced run profiles


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

    from port_bench import inputs
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


# the comparison's numbers, the control and the planted faults
# (``port_bench/readings.py`` reads the limits' readings through them)
NUMBERS = check.NUMBERS
FAULTS = faults.FAULTS
CONTROL = system.ReferenceNet


def plant(fault: str, spec: dict):
    """The fault ``fault`` planted in the program for the cell ``spec``."""
    return faults.plant(fault, spec["traffic"]["mode"] == "train")
