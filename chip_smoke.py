#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  Phases, each
printed on lines of its own:

1. env     — torch/CUDA versions, the card's name and power limit;
2. build   — every CUDA source under ``src/repro_torch/csrc/`` compiled
             into ``build/torch_kernels/`` (seconds, nvcc's ptxas report);
3. kernels — each fused ITP-STDP kernel against its plain PyTorch version
             on the card: bit-equal (``torch.equal``) at the serving shape
             8×784×100 (depth 1, 7, 8), a ragged 200×72, both pairings, and
             packed ≡ unpacked; median times from CUDA events beside the
             byte bound and the plain version's time;
4. serve   — the slice's load through ``repro_torch.serve.Server`` at the
             2layer-snn fc width (784×100, rule itp, depth 7, 8 sessions,
             32 requests, max_batch 8, t_steps 16): once on the packed path
             (kernel ``itp_stdp_update_packed``) and once with
             ``packed_history=False`` (kernel ``itp_stdp_update``), each
             with the launch counters set to 0 just before and read just
             after; launches must equal batches × t_steps.  The same load on
             ``backend="reference"`` on the card must give equal post rasters
             and words and ``w`` within rtol=1e-5, atol=1e-6; one session
             served solo and interleaved must be bit-identical;
5. the ``kernels`` JSON line, the ``nvidia-smi`` name/power-limit line, and
   the final ``{"ok": true, ...}`` line.

Any mismatch or exception ends the script with a non-zero exit.  Without a
CUDA device it exits with code 2 and prints no result.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)
FP32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
SERVE_CFG = dict(n_pre=784, n_post=100, rule="itp", depth=7)
SERVE_LOAD = dict(sessions=8, requests=32)
SERVE_SCFG = dict(max_batch=8, t_steps=16, theta_plus=0.05)
KERNEL_CASES = [  # (lanes, n_pre, n_post, depth)
    (8, 784, 100, 7), (8, 784, 100, 1), (8, 784, 100, 8), (1, 200, 72, 7)]
REPLACES = {
    "itp_stdp_update_packed": "src/repro/kernels/itp_stdp/kernel.py:177",
    "itp_stdp_update": "src/repro/kernels/itp_stdp/kernel.py:108",
}


def _phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def _time_ms(fn, *, reps: int = 30, inner: int = 20) -> float:
    """Median over ``reps`` CUDA-event windows of ``inner`` back-to-back calls."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return statistics.median(times)


def _device_ms(fn, kernel_name: str, n: int = 50) -> float | None:
    """Mean device time of ``kernel_name`` from a profiler trace, or None."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total_us, count = 0.0, 0
    for row in prof.key_averages():
        if kernel_name in row.key:
            total_us += getattr(row, "device_time_total", 0.0) or getattr(
                row, "cuda_time_total", 0.0)
            count += row.count
    return total_us / count / 1e3 if count else None


def _bound(lanes: int, n_pre: int, n_post: int, depth: int, packed: bool
           ) -> tuple[float, str]:
    """Least time for one update: bytes (each input read once, the output
    written once) over HBM rate vs float32 ops over the float32 peak."""
    syn = lanes * n_pre * n_post
    neurons = lanes * (n_pre + n_post)
    hist = neurons * (1 if packed else 4 * depth)
    nbytes = 2 * 4 * syn + 4 * neurons + hist + 2 * 4 * depth
    ops = 7 * syn + 3 * depth * neurons   # gate muls, sub, eta mul, add, clip; po2 read
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _inputs(lanes, n_pre, n_post, depth, gen, device):
    import torch

    from repro_torch.core.history import unpack_words

    w = torch.rand((lanes, n_pre, n_post), generator=gen)
    pre_s = (torch.rand((lanes, n_pre), generator=gen) < 0.3).float()
    post_s = (torch.rand((lanes, n_post), generator=gen) < 0.3).float()
    pre_words = torch.randint(0, 256, (lanes, n_pre), generator=gen, dtype=torch.uint8)
    post_words = torch.randint(0, 256, (lanes, n_post), generator=gen, dtype=torch.uint8)
    t = [x.to(device) for x in (w, pre_s, post_s, pre_words, post_words)]
    bits = [unpack_words(x, depth).transpose(-1, -2).float().contiguous() for x in t[3:]]
    return t + bits


def phase_kernels(device) -> dict:
    import torch

    from repro_torch.core.stdp import STDPParams
    from repro_torch.kernels.itp_stdp import kernel as K
    from repro_torch.kernels.itp_stdp import ref as R
    from repro_torch.kernels.itp_stdp.ops import po2_vectors

    gen = torch.Generator().manual_seed(11)
    params = STDPParams()
    report = {}
    for lanes, n_pre, n_post, depth in KERNEL_CASES:
        w, pre_s, post_s, pre_wd, post_wd, pre_b, post_b = _inputs(
            lanes, n_pre, n_post, depth, gen, device)
        po2 = po2_vectors(params, depth, device=device)
        for nearest in (True, False):
            kw = dict(nearest=nearest, eta=0.3, w_min=0.0, w_max=1.0)
            packed = K.itp_stdp_update_packed(w, pre_s, post_s, pre_wd, post_wd, *po2,
                                              depth=depth, **kw)
            unpacked = K.itp_stdp_update(w, pre_s, post_s, pre_b, post_b, *po2, **kw)
            plain_p = R.itp_stdp_update_packed_ref(w, pre_s, post_s, pre_wd, post_wd,
                                                   *po2, depth=depth, **kw)
            plain_u = R.itp_stdp_update_ref(w, pre_s, post_s, pre_b, post_b, *po2, **kw)
            torch.cuda.synchronize()
            err_p = (packed - plain_p).abs().max().item()
            err_u = (unpacked - plain_u).abs().max().item()
            case = f"{lanes}x{n_pre}x{n_post} depth={depth} nearest={nearest}"
            ok = (torch.equal(packed, plain_p) and torch.equal(unpacked, plain_u)
                  and torch.equal(packed, unpacked) and bool(torch.isfinite(packed).all()))
            _phase("kernels", f"{case}: packed vs plain max|err|={err_p:.3g}, unpacked vs "
                   f"plain max|err|={err_u:.3g}, packed==unpacked "
                   f"{torch.equal(packed, unpacked)} -> {'OK' if ok else 'MISMATCH'}")
            if not ok:
                raise SystemExit(f"kernel mismatch at {case}")
            for name, err in (("itp_stdp_update_packed", err_p), ("itp_stdp_update", err_u)):
                report.setdefault(name, {"max_abs_err": 0.0})
                report[name]["max_abs_err"] = max(report[name]["max_abs_err"], err)

        if (lanes, n_pre, n_post, depth) == KERNEL_CASES[0]:
            kw = dict(nearest=True, eta=1.0 / 16.0, w_min=0.0, w_max=1.0)
            timed = {
                "itp_stdp_update_packed": (
                    lambda: K.itp_stdp_update_packed(w, pre_s, post_s, pre_wd, post_wd,
                                                     *po2, depth=depth, **kw),
                    lambda: R.itp_stdp_update_packed_ref(w, pre_s, post_s, pre_wd,
                                                         post_wd, *po2, depth=depth, **kw),
                    True),
                "itp_stdp_update": (
                    lambda: K.itp_stdp_update(w, pre_s, post_s, pre_b, post_b, *po2, **kw),
                    lambda: R.itp_stdp_update_ref(w, pre_s, post_s, pre_b, post_b, *po2, **kw),
                    False),
            }
            for name, (kern, plain, is_packed) in timed.items():
                ms = _time_ms(kern)
                plain_ms = _time_ms(plain, reps=10, inner=5)
                bound_ms, bound_by = _bound(lanes, n_pre, n_post, depth, is_packed)
                device_ms = _device_ms(kern, "itp_stdp_kernel")
                report[name].update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                    bound_by=bound_by, device_ms=device_ms,
                                    shape=f"{lanes}x{n_pre}x{n_post} depth={depth}")
                dev_txt = "not measured" if device_ms is None else f"{device_ms:.5f} ms"
                _phase("kernels", f"{name} {lanes}x{n_pre}x{n_post} depth={depth}: "
                       f"{ms:.5f} ms/call (CUDA events), kernel alone {dev_txt} "
                       f"(profiler), bound {bound_ms:.5f} ms ({bound_by}), plain "
                       f"{plain_ms:.5f} ms")
    return report


def _serve(cfg, scfg, load, device, *, threaded: bool):
    """Serve ``load`` on a fresh server; returns (server, results, seconds)."""
    import torch

    from repro_torch.serve import Server

    server = Server(cfg, scfg, seed=0, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if threaded:
        server.start()
    tickets = [server.submit(r) for r in load]
    server.shutdown(drain=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    results = [server.poll(t) for t in tickets]
    if any(r is None for r in results):
        raise SystemExit(f"served {sum(r is not None for r in results)}/{len(load)} requests")
    return server, results, seconds


def _profile_batch(cfg, scfg, load, device) -> None:
    """Where one served batch's time goes: wall time, device-busy share, and
    the device kernels that take the most time (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, _, seconds = _serve(cfg, scfg, load, device, threaded=False)
    rows = []
    for row in prof.key_averages():
        dev_us = getattr(row, "self_device_time_total", 0.0) or getattr(
            row, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us, row.count, row.key))
    busy_us = sum(r[0] for r in rows)
    _phase("profile", f"one batch of {len(load)} requests x {scfg.t_steps} steps: wall "
           f"{seconds * 1e3:.3f} ms (profiled), device busy {busy_us / 1e3:.3f} ms "
           f"({busy_us / 1e4 / seconds:.2f}% of wall)")
    for dev_us, count, key in sorted(rows, reverse=True)[:8]:
        _phase("profile", f"  {dev_us / 1e3:9.4f} ms device, {count:5d} calls: {key[:90]}")


def _states(server):
    return {sid: server.store.peek(sid) for sid in server.store.session_ids}


def _assert_states(a, b, *, exact: bool, what: str) -> None:
    import torch

    if a.keys() != b.keys():
        raise SystemExit(f"{what}: session sets differ")
    for sid in a:
        x, y = a[sid], b[sid]
        for p, q in zip((*x.pre_words, *x.post_words), (*y.pre_words, *y.post_words)):
            if not torch.equal(p, q):
                raise SystemExit(f"{what}: words of {sid} differ")
        for name in ("w", "v", "theta"):
            p, q = getattr(x, name), getattr(y, name)
            same = torch.equal(p, q) if exact else torch.allclose(p, q, rtol=1e-5, atol=1e-6)
            if not same:
                err = (p - q).abs().max().item()
                raise SystemExit(f"{what}: {name} of {sid} differs (max|err|={err:.3g})")
        if x.t != y.t:
            raise SystemExit(f"{what}: step counters of {sid} differ")


def phase_serve(device) -> dict:
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.core.engine import EngineConfig
    from repro_torch.kernels.itp_stdp import kernel as K
    from repro_torch.launch.serve import synthetic_load
    from repro_torch.serve import ServeConfig

    scfg = ServeConfig(**SERVE_SCFG)
    cfg = EngineConfig(**SERVE_CFG, backend="fused", packed_history=True)
    load = synthetic_load(torch.Generator().manual_seed(1), t_steps=scfg.t_steps,
                          n_pre=cfg.n_pre, **SERVE_LOAD)
    counters = {"itp_stdp_update_packed": K.itp_stdp_update_packed,
                "itp_stdp_update": K.itp_stdp_update}
    # warm-up (first CUDA calls of each path, the caching allocator): not counted
    for packed in (True, False):
        _serve(dataclasses.replace(cfg, packed_history=packed), scfg,
               load[:scfg.max_batch], device, threaded=False)
    launches = {}
    runs = {}
    for name, packed in (("itp_stdp_update_packed", True), ("itp_stdp_update", False)):
        run_cfg = dataclasses.replace(cfg, packed_history=packed)
        for fn in counters.values():
            fn.launches = 0
        server, results, seconds = _serve(run_cfg, scfg, load, device, threaded=True)
        counts = {k: fn.launches for k, fn in counters.items()}
        expect = server.batches * scfg.t_steps
        _phase("serve", f"fused packed_history={packed}: served {len(results)}/"
               f"{len(load)} requests in {server.batches} batches, {seconds:.4f} s "
               f"({len(load) / seconds:.2f} requests/s, "
               f"{len(load) * scfg.t_steps / seconds:.1f} sim-steps/s); launches {counts}")
        if counts[name] != expect or counts[name] == 0:
            raise SystemExit(f"{name}: {counts[name]} launches, expected {expect}")
        launches[name] = counts[name]
        runs[packed] = (server, results, seconds)

    server, results, seconds = runs[True]
    for r in results:
        if r.post.shape != (scfg.t_steps, cfg.n_post) or r.post.dtype != np.uint8:
            raise SystemExit(f"bad result shape {r.post.shape} {r.post.dtype}")
    for s in _states(server).values():
        if not (tuple(s.w.shape) == (cfg.n_pre, cfg.n_post) and torch.isfinite(s.w).all()):
            raise SystemExit("non-finite or misshapen weights")
    rate = float(np.mean([r.post.mean() for r in results]))

    # packed == unpacked, bit for bit, over the whole load
    u_server, u_results, _ = runs[False]
    if not all(np.array_equal(a.post, b.post) for a, b in zip(results, u_results)):
        raise SystemExit("packed vs unpacked: post rasters differ")
    _assert_states(_states(server), _states(u_server), exact=True, what="packed vs unpacked")

    # the same load on the reference backend, on the card
    ref_server, ref_results, ref_seconds = _serve(
        dataclasses.replace(cfg, backend="reference"), scfg, load, device, threaded=True)
    if not all(np.array_equal(a.post, b.post) for a, b in zip(results, ref_results)):
        raise SystemExit("fused vs reference: post rasters differ")
    _assert_states(_states(server), _states(ref_server), exact=False, what="fused vs reference")

    # one session solo vs interleaved: bit-identical
    solo_load = [r for r in load if r.sid == "user0"]
    solo_server, solo_results, _ = _serve(cfg, scfg, solo_load, device, threaded=False)
    inter = [r for r in results if r.sid == "user0"]
    if not all(np.array_equal(a.post, b.post) for a, b in zip(inter, solo_results)):
        raise SystemExit("solo vs interleaved: post rasters differ")
    _assert_states({"user0": server.store.peek("user0")},
                   {"user0": solo_server.store.peek("user0")}, exact=True,
                   what="solo vs interleaved")
    _profile_batch(cfg, scfg, load[:scfg.max_batch], device)
    _phase("serve", f"parity OK: packed == unpacked (bitwise), fused == reference "
           f"(rasters and words exact, w/v/theta rtol=1e-5 atol=1e-6), solo == "
           f"interleaved (bitwise); mean post rate {rate:.4f}; reference backend "
           f"{len(load) / ref_seconds:.2f} requests/s")
    return {"launches": launches, "requests_per_s": len(load) / seconds,
            "sim_steps_per_s": len(load) * scfg.t_steps / seconds}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to run",
              file=sys.stderr)
        return 2

    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build

    device = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    _phase("env", f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA "
           f"{torch.version.cuda}, device {torch.cuda.get_device_name(0)} "
           f"(count {torch.cuda.device_count()}); nvidia-smi: {smi}")

    t0 = time.perf_counter()
    libs = _build.build_all()
    _phase("build", f"{len(libs)} CUDA source(s) built/loaded in "
           f"{time.perf_counter() - t0:.2f} s into {_build.BUILD_DIR}")
    for stem, path in libs.items():
        log = path.with_name(path.name + ".log")
        for line in (log.read_text().splitlines() if log.exists() else []):
            if "registers" in line or "spill" in line or "Compiling" in line:
                _phase("build", f"{stem}: {line.strip()}")

    kernels = phase_kernels(device)
    serve = phase_serve(device)
    _phase("serve", f"slice load: {serve['requests_per_s']:.2f} requests/s, "
           f"{serve['sim_steps_per_s']:.1f} sim-steps/s")

    line = {"kernels": [
        {"name": name, "route": "cuda", "source": "src/repro_torch/csrc/itp_stdp.cu",
         "replaces": REPLACES[name], "launches": serve["launches"][name],
         "max_abs_err": k["max_abs_err"], "ms": k["ms"], "plain_ms": k["plain_ms"],
         "bound_ms": k["bound_ms"], "bound_by": k["bound_by"], "library_ms": None,
         "device_ms": k["device_ms"], "shape": k["shape"]}
        for name, k in kernels.items()]}
    bad = [k["name"] for k in line["kernels"]
           if not all(math.isfinite(k[f]) for f in ("ms", "plain_ms", "bound_ms"))]
    if bad:
        raise SystemExit(f"unmeasured kernels: {bad}")
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
