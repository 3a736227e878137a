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
5. conv_kernels — each im2col conv-delta kernel against its plain PyTorch
             version on the card at the four conv-layer shapes of the paper
             nets at batch 16 (DCSNN conv1/conv2, CSNN conv1/conv2), depth 7,
             both pairings: within atol=1e-4, rtol=1e-5, and bit-equal, since
             both sum exactly in float64; packed ≡ unpacked and two runs
             bitwise; times from CUDA events and the profiler beside the byte
             bound and the plain version's time;
6. train   — the slice's main path, ``train_to_accuracy``: the 6layer-dcsnn
             at full width (28×28×1, conv 12@5×5, conv 24@3×3, fc 128; batch
             16, t_steps 30) on ``backend="fused"`` for 3 batches plus one
             evaluation, with conv-kernel launches = 2 × t_steps × batches and
             fc launches = t_steps × batches; the same batches with
             ``quantise=False`` on fused (packed and unpacked) and reference,
             spike counts exact and weights within rtol=atol=1e-5; the
             5layer-csnn at full width (512×2) for one batch, likewise; the
             2layer-snn (784×100) under the protocol of BENCH_accuracy.json
             (6 epochs × 8 batches × 16 × 30 steps, theta_plus 0.05, hard
             WTA), whose final accuracy must be ≥ 0.25; one profiled DCSNN
             batch;
7. the ``kernels`` JSON line, the ``nvidia-smi`` name/power-limit line, and
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
    "itp_stdp_conv_delta_packed": "src/repro/kernels/itp_stdp_conv/kernel.py:197",
    "itp_stdp_conv_delta": "src/repro/kernels/itp_stdp_conv/kernel.py:133",
}
SOURCES = {
    "itp_stdp_update_packed": "src/repro_torch/csrc/itp_stdp.cu",
    "itp_stdp_update": "src/repro_torch/csrc/itp_stdp.cu",
    "itp_stdp_conv_delta_packed": "src/repro_torch/csrc/itp_stdp_conv.cu",
    "itp_stdp_conv_delta": "src/repro_torch/csrc/itp_stdp_conv.cu",
}
# (M, K, C) of the paper nets' conv layers at batch 16: M = batch × positions
CONV_CASES = {"DCSNN conv1": (9216, 25, 12), "DCSNN conv2": (1600, 108, 24),
              "CSNN conv1": (4048, 14, 8), "CSNN conv2": (976, 40, 16)}
CONV_DEPTH = 7
CONV_TOL = dict(atol=1e-4, rtol=1e-5)   # the reference's kernel-vs-oracle tolerance
TRAIN_TOL = dict(rtol=1e-5, atol=1e-5)  # the reference's fused-vs-reference net tolerance
DCSNN_TRAIN = dict(epochs=1, batches_per_epoch=3, batch=16, t_steps=30,
                   assign_batches=2, eval_batches=2, seed=0)
CSNN_TRAIN = dict(epochs=1, batches_per_epoch=1, batch=16, t_steps=30,
                  assign_batches=1, eval_batches=1, seed=0)
# BENCH_accuracy.json's protocol (train_to_accuracy.protocol)
ACCURACY_TRAIN = dict(epochs=6, batches_per_epoch=8, batch=16, t_steps=30,
                      assign_batches=6, eval_batches=8, seed=0)
ACCURACY_FLOOR = 0.25                   # 2.5 × chance on 10 classes


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


def _device_ms(fn, kernel_name: str, *, launches_per_call: int = 1,
               n: int = 50) -> float | None:
    """Device time per call of ``fn`` summed over the kernels whose names
    contain ``kernel_name``, from a profiler trace; None unless the trace
    holds all ``n × launches_per_call`` of their launches (a trace that
    lost events would read low)."""
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
    _phase("profile", f"{kernel_name}: the trace holds {count} of "
           f"{n * launches_per_call} launches")
    return total_us / n / 1e3 if count == n * launches_per_call else None


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
    _report_profile(prof, seconds,
                    f"one batch of {len(load)} requests x {scfg.t_steps} steps")


def _report_profile(prof, seconds: float, what: str) -> None:
    """Print the wall time, the device-busy share and the eight device
    kernels that take the most time of one profiled run.  Only the device's
    own events (kernels, copies, memsets) count: a host op's row repeats
    the device time of the kernels it launched."""
    import torch

    rows = []
    for row in prof.key_averages():
        if row.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(row, "self_device_time_total", 0.0) or getattr(
            row, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us, row.count, row.key))
    busy_us = sum(r[0] for r in rows)
    busy = (f"{busy_us / 1e3:.3f} ms ({busy_us / 1e4 / seconds:.2f}% of wall)" if rows
            else "not measured (no device events in the trace)")
    _phase("profile", f"{what}: wall {seconds * 1e3:.3f} ms (profiled), device busy {busy}")
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


def _conv_bound(m: int, k: int, c: int, depth: int, packed: bool) -> tuple[float, str]:
    """Least time for one conv delta: the inputs read once (float32 spikes,
    one history byte per element or 4·depth bytes of bitplanes, the po2
    vectors) and the (K, C) float32 delta written once, over the HBM rate,
    against the two contractions' multiply and add per term over the
    float32 peak."""
    hist = (m * k + m * c) * (1 if packed else 4 * depth)
    nbytes = 4 * (m * k + m * c) + hist + 2 * 4 * depth + 4 * k * c
    ops = 4 * m * k * c
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def phase_conv_kernels(device) -> dict:
    import torch

    from repro_torch.core.history import pack_bitplanes
    from repro_torch.core.stdp import STDPParams
    from repro_torch.kernels.itp_stdp.ops import po2_vectors
    from repro_torch.kernels.itp_stdp_conv import kernel as CK
    from repro_torch.kernels.itp_stdp_conv import ref as CR

    gen = torch.Generator().manual_seed(12)
    po2 = po2_vectors(STDPParams(), CONV_DEPTH, device=device)
    report = {name: {"max_abs_err": 0.0} for name in
              ("itp_stdp_conv_delta_packed", "itp_stdp_conv_delta")}
    for layer, (m, k, c) in CONV_CASES.items():
        pre = (torch.rand((m, k), generator=gen) < 0.3).float().to(device)
        post = (torch.rand((m, c), generator=gen) < 0.25).float().to(device)
        pre_b = (torch.rand((CONV_DEPTH, m, k), generator=gen) < 0.3).float().to(device)
        post_b = (torch.rand((CONV_DEPTH, m, c), generator=gen) < 0.25).float().to(device)
        pre_w, post_w = pack_bitplanes(pre_b), pack_bitplanes(post_b)
        for nearest in (True, False):
            packed = CK.itp_stdp_conv_delta_packed(pre, post, pre_w, post_w, *po2,
                                                   depth=CONV_DEPTH, nearest=nearest)
            unpacked = CK.itp_stdp_conv_delta(pre, post, pre_b, post_b, *po2, nearest=nearest)
            packed2 = CK.itp_stdp_conv_delta_packed(pre, post, pre_w, post_w, *po2,
                                                    depth=CONV_DEPTH, nearest=nearest)
            unpacked2 = CK.itp_stdp_conv_delta(pre, post, pre_b, post_b, *po2,
                                               nearest=nearest)
            plain = CR.itp_stdp_conv_delta_ref(pre, post, pre_b, post_b, *po2, nearest=nearest)
            torch.cuda.synchronize()
            err_p = (packed - plain).abs().max().item()
            err_u = (unpacked - plain).abs().max().item()
            close = bool(torch.isfinite(packed).all()) and all(
                torch.allclose(x, plain, **CONV_TOL) for x in (packed, unpacked))
            same = torch.equal(packed, unpacked)
            repeat = torch.equal(packed, packed2) and torch.equal(unpacked, unpacked2)
            case = f"{layer} M={m} K={k} C={c} depth={CONV_DEPTH} nearest={nearest}"
            _phase("conv_kernels", f"{case}: packed vs plain max|err|={err_p:.3g}, unpacked "
                   f"vs plain max|err|={err_u:.3g} (bit-equal {torch.equal(packed, plain)}), "
                   f"packed==unpacked {same}, run-to-run {repeat} -> "
                   f"{'OK' if close and same and repeat else 'MISMATCH'}")
            if not (close and same and repeat):
                raise SystemExit(f"conv kernel mismatch at {case}")
            for name, err in (("itp_stdp_conv_delta_packed", err_p),
                              ("itp_stdp_conv_delta", err_u)):
                report[name]["max_abs_err"] = max(report[name]["max_abs_err"], err)

        timed = {
            "itp_stdp_conv_delta_packed": (
                lambda: CK.itp_stdp_conv_delta_packed(pre, post, pre_w, post_w, *po2,
                                                      depth=CONV_DEPTH),
                lambda: CR.itp_stdp_conv_delta_packed_ref(pre, post, pre_w, post_w, *po2,
                                                          depth=CONV_DEPTH), True),
            "itp_stdp_conv_delta": (
                lambda: CK.itp_stdp_conv_delta(pre, post, pre_b, post_b, *po2),
                lambda: CR.itp_stdp_conv_delta_ref(pre, post, pre_b, post_b, *po2), False),
        }
        for name, (kern, plain, is_packed) in timed.items():
            ms = _time_ms(kern)
            plain_ms = _time_ms(plain, reps=10, inner=5)
            bound_ms, bound_by = _conv_bound(m, k, c, CONV_DEPTH, is_packed)
            device_ms = _device_ms(kern, "conv_delta_", launches_per_call=2)
            dev_txt = "not measured" if device_ms is None else f"{device_ms:.5f} ms"
            _phase("conv_kernels", f"{name} {layer} ({m}x{k}x{c}, depth {CONV_DEPTH}): "
                   f"{ms:.5f} ms/call (CUDA events), kernels alone {dev_txt} (profiler, "
                   f"both passes), bound {bound_ms:.5f} ms ({bound_by}), plain "
                   f"{plain_ms:.5f} ms")
            report[name].setdefault("layers", {})[layer] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                device_ms=device_ms)
            if layer == "DCSNN conv1":
                report[name].update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                    bound_by=bound_by, device_ms=device_ms,
                                    shape=f"{layer} {m}x{k}x{c} depth={CONV_DEPTH}")
    return report


def _train_counters():
    from repro_torch.kernels.itp_stdp import kernel as K
    from repro_torch.kernels.itp_stdp_conv import kernel as CK

    return {"itp_stdp_update_packed": K.itp_stdp_update_packed,
            "itp_stdp_update": K.itp_stdp_update,
            "itp_stdp_conv_delta_packed": CK.itp_stdp_conv_delta_packed,
            "itp_stdp_conv_delta": CK.itp_stdp_conv_delta}


def _run_batches(cfg, batches, batch, device):
    """``run_snn`` over ``batches`` from one seeded init, dynamics reset
    between rasters; returns (state, per-batch spike counts)."""
    import torch

    from repro_torch.models import snn

    st = snn.init_snn(cfg, batch, generator=torch.Generator().manual_seed(0), device=device)
    counts = []
    for b in batches:
        st, cnt = snn.run_snn(st, b, cfg, train=True)
        counts.append(cnt)
        st = snn.reset_dynamics(st, cfg, batch)
    torch.cuda.synchronize()
    return st, counts


def _train_net(net: str, cfg, tcfg, device, *, conv_layers: int) -> dict:
    """Train ``net`` on the main path with the launch counters set to 0 just
    before and read just after; then the same batches with quantise=False on
    fused packed, fused unpacked and reference for the parity checks."""
    import dataclasses

    import torch

    from repro_torch.launch.cli import sampler_for
    from repro_torch.train.stdp_trainer import SamplerSource, train_to_accuracy

    sampler, n_classes = sampler_for(net)
    counters = _train_counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    res = train_to_accuracy(cfg, sampler, n_classes, tcfg, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    steps = tcfg.batches_per_epoch * tcfg.t_steps * tcfg.epochs
    want = {"itp_stdp_conv_delta_packed": conv_layers * steps,
            "itp_stdp_update_packed": steps, "itp_stdp_conv_delta": 0,
            "itp_stdp_update": 0}
    st = res["state"]
    levels = (1 << (cfg.w_bits - 1)) - 1
    finite = all(bool(torch.isfinite(w).all()) for w in st.weights)
    on_grid = all(bool(torch.allclose(w * levels, torch.round(w * levels), atol=1e-3))
                  for w in st.weights)
    samples = tcfg.batch * tcfg.batches_per_epoch * tcfg.epochs
    _phase("train", f"{net} fused (full width, batch {tcfg.batch}, t_steps {tcfg.t_steps}, "
           f"{tcfg.batches_per_epoch * tcfg.epochs} train batches + evaluation): "
           f"accuracy curve {res['accuracy_curve']}, eval rate {res['mean_eval_rates'][-1]:.4f}, "
           f"train {res['train_seconds']:.3f} s = {steps / res['train_seconds']:.1f} "
           f"sim-steps/s, {samples / res['train_seconds']:.2f} samples/s; wall with "
           f"evaluation {wall:.3f} s; launches {launches}")
    if launches != want:
        raise SystemExit(f"{net}: launches {launches}, expected {want}")
    if not (finite and on_grid and 0.0 <= res["final_accuracy"] <= 1.0):
        raise SystemExit(f"{net}: non-finite or off-grid weights, or a bad accuracy")

    # the same batches with quantise=False: fused packed / unpacked / reference
    source = SamplerSource(sampler, tcfg)
    batches = [b["spikes"].to(device) for b in source.train_batches(0)]
    flt = dataclasses.replace(cfg, quantise=False)
    st_p, cnt_p = _run_batches(flt, batches, tcfg.batch, device)
    for fn in counters.values():
        fn.launches = 0
    st_u, cnt_u = _run_batches(dataclasses.replace(flt, packed_history=False), batches,
                               tcfg.batch, device)
    unpacked_launches = counters["itp_stdp_conv_delta"].launches
    st_r, cnt_r = _run_batches(dataclasses.replace(flt, backend="reference"), batches,
                               tcfg.batch, device)
    if unpacked_launches != conv_layers * tcfg.t_steps * len(batches):
        raise SystemExit(f"{net}: {unpacked_launches} unpacked conv launches")
    same_u = (all(torch.equal(a, b) for a, b in zip(cnt_p, cnt_u))
              and all(torch.equal(a, b) for a, b in zip(st_p.weights, st_u.weights)))
    counts_ok = all(torch.equal(a, b) for a, b in zip(cnt_p, cnt_r))
    w_err = max((a - b).abs().max().item() for a, b in zip(st_p.weights, st_r.weights))
    w_ok = all(torch.allclose(a, b, **TRAIN_TOL) for a, b in zip(st_p.weights, st_r.weights))
    bitwise = all(torch.equal(a, b) for a, b in zip(st_p.weights, st_r.weights))
    spikes = sum(float(c.sum()) for c in cnt_p)
    _phase("train", f"{net} quantise=False on the same {len(batches)} batches: packed == "
           f"unpacked {same_u} ({unpacked_launches} unpacked conv launches); fused vs "
           f"reference: spike counts equal {counts_ok} ({spikes:.0f} output spikes), "
           f"weights max|err| {w_err:.3g} (bit-equal {bitwise})")
    if not (same_u and counts_ok and w_ok and spikes > 0):
        raise SystemExit(f"{net}: fused vs reference / packed vs unpacked parity failed")
    return {"launches": launches, "unpacked_launches": unpacked_launches,
            "sim_steps_per_s": steps / res["train_seconds"],
            "samples_per_s": samples / res["train_seconds"],
            "accuracy_curve": res["accuracy_curve"]}


def _profile_train_batch(cfg, tcfg, device) -> None:
    """Where one DCSNN training batch's time goes: wall time, device-busy
    share, and the device kernels that take the most time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.cli import sampler_for
    from repro_torch.train.stdp_trainer import SamplerSource

    sampler, _ = sampler_for("6layer-dcsnn")
    batch = next(iter(SamplerSource(sampler, tcfg).train_batches(0)))["spikes"].to(device)
    _run_batches(cfg, [batch], tcfg.batch, device)            # warm
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _run_batches(cfg, [batch], tcfg.batch, device)
        seconds = time.perf_counter() - t0
    _report_profile(prof, seconds, f"one 6layer-dcsnn training batch ({tcfg.batch} x "
                    f"{tcfg.t_steps} steps, fused)")


def phase_train(device) -> dict:
    import torch

    from repro_torch.launch.cli import sampler_for
    from repro_torch.models import snn
    from repro_torch.train.stdp_trainer import TrainerConfig, train_to_accuracy

    out = {}
    dcsnn, dcsnn_t = snn.fmnist_dcsnn(backend="fused"), TrainerConfig(**DCSNN_TRAIN)
    out["6layer-dcsnn"] = _train_net("6layer-dcsnn", dcsnn, dcsnn_t, device, conv_layers=2)
    out["5layer-csnn"] = _train_net("5layer-csnn", snn.fault_csnn(backend="fused"),
                                    TrainerConfig(**CSNN_TRAIN), device, conv_layers=2)

    # the 2-layer SNN under BENCH_accuracy.json's protocol
    sampler, n_classes = sampler_for("2layer-snn")
    cfg = snn.mnist_2layer(backend="fused", theta_plus=0.05, hard_wta=True)
    tcfg = TrainerConfig(**ACCURACY_TRAIN)
    counters = _train_counters()
    for fn in counters.values():
        fn.launches = 0
    res = train_to_accuracy(cfg, sampler, n_classes, tcfg, device=device)
    torch.cuda.synchronize()
    fc = counters["itp_stdp_update_packed"].launches
    steps = tcfg.epochs * tcfg.batches_per_epoch * tcfg.t_steps
    _phase("train", f"2layer-snn (784x100, fused, BENCH_accuracy protocol): accuracy curve "
           f"{res['accuracy_curve']} (final {res['final_accuracy']:.4f}, floor "
           f"{ACCURACY_FLOOR}), train {res['train_seconds']:.3f} s = "
           f"{steps / res['train_seconds']:.1f} sim-steps/s, "
           f"{tcfg.epochs * tcfg.batches_per_epoch * tcfg.batch / res['train_seconds']:.2f} "
           f"samples/s; fc launches {fc}")
    if fc != steps:
        raise SystemExit(f"2layer-snn: {fc} fc launches, expected {steps}")
    if not res["final_accuracy"] >= ACCURACY_FLOOR:
        raise SystemExit(f"2layer-snn: final accuracy {res['final_accuracy']} < {ACCURACY_FLOOR}")
    out["2layer-snn"] = {"accuracy_curve": res["accuracy_curve"],
                         "sim_steps_per_s": steps / res["train_seconds"]}
    _profile_train_batch(dcsnn, dcsnn_t, device)
    return out


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
    kernels.update(phase_conv_kernels(device))
    train = phase_train(device)
    dcsnn = train["6layer-dcsnn"]
    # launches: each kernel's count from the run of its main path (serving for
    # the dense kernels, DCSNN training for the conv kernels)
    launches = dict(serve["launches"],
                    itp_stdp_conv_delta_packed=dcsnn["launches"]["itp_stdp_conv_delta_packed"],
                    itp_stdp_conv_delta=dcsnn["unpacked_launches"])
    for net, r in train.items():
        _phase("train", f"{net}: {r['sim_steps_per_s']:.1f} sim-steps/s")

    line = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": launches[name],
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
