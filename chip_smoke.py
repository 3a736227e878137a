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
             served solo and interleaved must be bit-identical; then the same
             load with the counter baseline ``rule="exact"`` (kernel
             ``counter_stdp_update``, launches = batches × t_steps), fused ==
             reference and solo == interleaved likewise, 1 B/neuron;
5. conv_kernels — each im2col conv-delta kernel against its plain PyTorch
             version on the card at the four conv-layer shapes of the paper
             nets at batch 16 (DCSNN conv1/conv2, CSNN conv1/conv2), depth 7,
             both pairings: within atol=1e-4, rtol=1e-5, and bit-equal, since
             both sum exactly in float64; packed ≡ unpacked and two runs
             bitwise; times from CUDA events and the profiler beside the byte
             bound and the plain version's time;
6. counter_kernels — the counter-rule kernels (update and conv delta)
             against their plain versions on the card, for each window
             (exact, linear, imstdp): the update at serving's 8×784×100 and
             the fc layers' batch-16 shapes (784×100, 600×128, 480×64), the
             conv delta at the four conv shapes, depth 7 plus one depth-255
             case each; linear and imstdp updates bit-equal, exact within
             rtol=atol=1e-6, conv deltas within atol=1e-4, rtol=1e-5; two runs
             bitwise; every case timed (CUDA events, the profiler, the byte
             bound, the plain version), and kernels 1 and 3 beside kernel 5 at
             serving's shape and kernel 6 at DCSNN conv1 (the ITP-vs-counter
             ratios);
7. side_numerics — the paper's hardware numerics on their kernels (7-10):
             the DCSNN conv1 population (16 × 6,912 neurons, 24×24×12 at
             batch 16, ``LIFParams()``) for 30 steps through
             ``lif_step_kernel`` (kernel ``lif_update``) and through
             ``lif_step_llsmu`` from ``lif_fixed_init`` (kernel
             ``llsmu_multiply``, frac_bits 8, n_bits 4), each step
             ``torch.equal`` to the same step on the plain versions, 30
             launches each; the ISI histogram of the fixed-point raster and
             the history depth it selects (the paper's is 7); 3 ITP-AdamW
             steps (``po2_update=True``) on a tree with the leaf shapes of
             qwen3-0.6b (2 of its 28 layers, a cut that bounds chip time;
             float32, about 187 M parameters), kernels ``po2_encode`` and
             ``po2_decode`` once per leaf per step, parameters and moments
             ``torch.equal`` to the same steps on the plain quantiser; the
             gradient tree's compression error and an int8 wire round trip
             of the embedding's gradient; the drift model's §IV-A numbers
             (``paper_metrics``), the curve RMSE 0.094753 within 5e-4; then
             each kernel against its plain version at the path's shapes
             (kernels 7-8 at 16 × 6,912, kernels 9-10 at the embedding leaf,
             151,936 × 1,024), timed beside the byte bound;
8. train   — the slice's main path, ``train_to_accuracy``: the 6layer-dcsnn
             at full width (28×28×1, conv 12@5×5, conv 24@3×3, fc 128; batch
             16, t_steps 30) on ``backend="fused"`` for 3 batches plus one
             evaluation, with conv-kernel launches = 2 × t_steps × batches and
             fc launches = t_steps × batches; the same batches with
             ``quantise=False`` on fused (packed and unpacked) and reference,
             spike counts exact and weights within rtol=atol=1e-5; the
             5layer-csnn at full width (512×2) for one batch, likewise; the
             2layer-snn (784×100) under the protocol of BENCH_accuracy.json
             (6 epochs × 8 batches × 16 × 30 steps, theta_plus 0.05, hard
             WTA), whose final accuracy must be ≥ 0.25; then the counter
             baselines on the counter kernels: the 6layer-dcsnn with
             ``rule="exact"`` (3 batches, fused == reference), one batch each of
             ``linear`` on the 5layer-csnn and ``imstdp`` on the 6layer-dcsnn,
             and the 2layer-snn protocol with ``exact``, whose final accuracy
             must be ≥ 0.25 and within 0.05 of the ``itp`` run's; one profiled
             DCSNN batch each for itp and exact;
9. the ``kernels`` JSON line (kernels 1-4, kernels 5-6 once per window,
   kernels 7-10), the ``nvidia-smi`` name/power-limit line, and the final
   ``{"ok": true, ...}`` line.

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
COUNTER_WINDOWS = ("exact", "linear", "imstdp")
REPLACES = {
    "itp_stdp_update_packed": "src/repro/kernels/itp_stdp/kernel.py:177",
    "itp_stdp_update": "src/repro/kernels/itp_stdp/kernel.py:108",
    "itp_stdp_conv_delta_packed": "src/repro/kernels/itp_stdp_conv/kernel.py:197",
    "itp_stdp_conv_delta": "src/repro/kernels/itp_stdp_conv/kernel.py:133",
    **{f"counter_stdp_update[{w}]": "src/repro/kernels/itp_counter/kernel.py:172"
       for w in COUNTER_WINDOWS},
    **{f"counter_conv_delta[{w}]": "src/repro/kernels/itp_counter/kernel.py:330"
       for w in COUNTER_WINDOWS},
    "lif_update": "src/repro/kernels/lif/kernel.py:37",
    "llsmu_multiply": "src/repro/kernels/llsmu/kernel.py:66",
    "po2_encode": "src/repro/kernels/po2_quant/kernel.py:69",
    "po2_decode": "src/repro/kernels/po2_quant/kernel.py:77",
}
SOURCES = {
    "itp_stdp_update_packed": "src/repro_torch/csrc/itp_stdp.cu",
    "itp_stdp_update": "src/repro_torch/csrc/itp_stdp.cu",
    "itp_stdp_conv_delta_packed": "src/repro_torch/csrc/itp_stdp_conv.cu",
    "itp_stdp_conv_delta": "src/repro_torch/csrc/itp_stdp_conv.cu",
    **{k: "src/repro_torch/csrc/itp_counter.cu" for k in REPLACES if k.startswith("counter")},
    "lif_update": "src/repro_torch/csrc/lif.cu",
    "llsmu_multiply": "src/repro_torch/csrc/llsmu.cu",
    "po2_encode": "src/repro_torch/csrc/po2_quant.cu",
    "po2_decode": "src/repro_torch/csrc/po2_quant.cu",
}
# (M, K, C) of the paper nets' conv layers at batch 16: M = batch × positions
CONV_CASES = {"DCSNN conv1": (9216, 25, 12), "DCSNN conv2": (1600, 108, 24),
              "CSNN conv1": (4048, 14, 8), "CSNN conv2": (976, 40, 16)}
CONV_DEPTH = 7
CONV_TOL = dict(atol=1e-4, rtol=1e-5)   # the reference's kernel-vs-oracle tolerance
# (lanes, n_pre, n_post) of the dense counter update: serving's 8 sessions and
# the paper nets' fc layers at batch 16 (the batch is the lane axis)
COUNTER_FC_CASES = {"serving": (8, 784, 100), "2layer-snn fc": (16, 784, 100),
                    "DCSNN fc": (16, 600, 128), "CSNN fc": (16, 480, 64)}
COUNTER_DEPTH = 7
COUNTER_DEEP = 255                      # the uint8 counter word's largest depth
WINDOW_TOL = dict(rtol=1e-6, atol=1e-6)  # the reference's tolerance for the exp window
# float32 operations of one window evaluation (the exp counted as one)
WINDOW_OPS = {"exact": 4, "linear": 6, "imstdp": 1}
ITP_GAP_TOL = 0.05                      # BENCH_accuracy.json's itp-vs-exact tolerance
TRAIN_TOL = dict(rtol=1e-5, atol=1e-5)  # the reference's fused-vs-reference net tolerance
DCSNN_TRAIN = dict(epochs=1, batches_per_epoch=3, batch=16, t_steps=30,
                   assign_batches=2, eval_batches=2, seed=0)
CSNN_TRAIN = dict(epochs=1, batches_per_epoch=1, batch=16, t_steps=30,
                  assign_batches=1, eval_batches=1, seed=0)
# BENCH_accuracy.json's protocol (train_to_accuracy.protocol)
ACCURACY_TRAIN = dict(epochs=6, batches_per_epoch=8, batch=16, t_steps=30,
                      assign_batches=6, eval_batches=8, seed=0)
ACCURACY_FLOOR = 0.25                   # 2.5 × chance on 10 classes
# the side numerics: the DCSNN conv1 population (24×24×12 at batch 16)
LIF_POPULATION = (16, 24 * 24 * 12)
LIF_STEPS = 30
LIF_FRAC_BITS = 8
PAPER_HISTORY_DEPTH = 7
# qwen3-0.6b (src/repro/configs/qwen3_0_6b.py): d_model 1024, 16 heads × 128,
# 8 kv heads, d_ff 3072, vocab 151,936, q/k norms, tied embedding, 28 layers
QWEN3 = dict(d_model=1024, n_heads=16, n_kv_heads=8, head_dim=128, d_ff=3072,
             vocab=151_936, n_layers=28)
QWEN3_LAYERS = 2                        # of 28: a cut that bounds chip time
ADAMW_STEPS = 3
DRIFT_RMSE = 0.094753                   # paper §IV-A; tests/test_drift.py's band
DRIFT_RMSE_TOL = 5e-4
# bytes per element, inputs read once and outputs written once: kernel 7 reads
# v and I and writes v and the spikes (float32); kernel 8 reads two int32
# operands and writes one; kernels 9-10 read four bytes and write four
SIDE_BYTES = {"lif_update": 16, "llsmu_multiply": 12, "po2_encode": 8, "po2_decode": 8}
# operations per element (counted at the float32 peak, the only non-tensor
# rate of the data sheet): the LIF step's sub, mul, two adds, compare and
# select; LLSMU's split, three Mitchell multiplies (leading-one counts,
# mantissa shifts, branch, shift back) and recombination; the encoder's field
# and mantissa extraction, compare, clip, bias and sign; the decoder's masks,
# exponent build and select
SIDE_OPS = {"lif_update": 6, "llsmu_multiply": 120, "po2_encode": 12, "po2_decode": 6}


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


def _device_ms(fn, kernel_name: str, *, n: int = 50) -> float | None:
    """Device time per call of ``fn`` (one launch of a kernel whose name
    contains ``kernel_name``), from a profiler trace; None unless the trace
    holds exactly ``n`` such launches (a trace that lost events would read
    low)."""
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
           f"{n} launches")
    return total_us / n / 1e3 if count == n else None


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


def _serve_parity(cfg, scfg, load, device, server, results, *, what: str) -> float:
    """The same load on the reference backend (rasters and words exact, the
    rest within rtol=1e-5, atol=1e-6) and one session served solo against
    its interleaved run (bitwise); returns the reference's requests/s."""
    import dataclasses

    import numpy as np

    ref_server, ref_results, ref_seconds = _serve(
        dataclasses.replace(cfg, backend="reference"), scfg, load, device, threaded=True)
    if not all(np.array_equal(a.post, b.post) for a, b in zip(results, ref_results)):
        raise SystemExit(f"{what} fused vs reference: post rasters differ")
    _assert_states(_states(server), _states(ref_server), exact=False,
                   what=f"{what} fused vs reference")
    solo_load = [r for r in load if r.sid == "user0"]
    solo_server, solo_results, _ = _serve(cfg, scfg, solo_load, device, threaded=False)
    inter = [r for r in results if r.sid == "user0"]
    if not all(np.array_equal(a.post, b.post) for a, b in zip(inter, solo_results)):
        raise SystemExit(f"{what} solo vs interleaved: post rasters differ")
    _assert_states({"user0": server.store.peek("user0")},
                   {"user0": solo_server.store.peek("user0")}, exact=True,
                   what=f"{what} solo vs interleaved")
    return len(load) / ref_seconds


def _check_served(cfg, scfg, load, server, results) -> float:
    """Shapes and finiteness of a served load; returns the mean post rate."""
    import numpy as np
    import torch

    for r in results:
        if r.post.shape != (scfg.t_steps, cfg.n_post) or r.post.dtype != np.uint8:
            raise SystemExit(f"bad result shape {r.post.shape} {r.post.dtype}")
    for s in _states(server).values():
        if not (tuple(s.w.shape) == (cfg.n_pre, cfg.n_post) and torch.isfinite(s.w).all()):
            raise SystemExit("non-finite or misshapen weights")
        if any(x.dtype != torch.uint8 for x in (*s.pre_words, *s.post_words)):
            raise SystemExit("session words are not uint8")
    if server.store.state_bytes_per_session() != cfg.n_pre + cfg.n_post:
        raise SystemExit("the plasticity cache is not 1 B/neuron")
    return float(np.mean([r.post.mean() for r in results]))


def phase_serve(device) -> dict:
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.core.engine import EngineConfig
    from repro_torch.kernels.itp_counter import kernel as NK
    from repro_torch.kernels.itp_stdp import kernel as K
    from repro_torch.launch.serve import synthetic_load
    from repro_torch.serve import ServeConfig

    scfg = ServeConfig(**SERVE_SCFG)
    cfg = EngineConfig(**SERVE_CFG, backend="fused", packed_history=True)
    load = synthetic_load(torch.Generator().manual_seed(1), t_steps=scfg.t_steps,
                          n_pre=cfg.n_pre, **SERVE_LOAD)
    counters = {"itp_stdp_update_packed": K.itp_stdp_update_packed,
                "itp_stdp_update": K.itp_stdp_update,
                "counter_stdp_update": NK.counter_stdp_update}
    exact_cfg = dataclasses.replace(cfg, rule="exact")
    # warm-up (first CUDA calls of each path, the caching allocator): not counted
    for run_cfg in (cfg, dataclasses.replace(cfg, packed_history=False), exact_cfg):
        _serve(run_cfg, scfg, load[:scfg.max_batch], device, threaded=False)
    launches = {}
    runs = {}
    for name, run_cfg in (("itp_stdp_update_packed", cfg),
                          ("itp_stdp_update", dataclasses.replace(cfg, packed_history=False)),
                          ("counter_stdp_update[exact]", exact_cfg)):
        for fn in counters.values():
            fn.launches = 0
        server, results, seconds = _serve(run_cfg, scfg, load, device, threaded=True)
        counts = {k: fn.launches for k, fn in counters.items()}
        expect = server.batches * scfg.t_steps
        _phase("serve", f"fused rule={run_cfg.rule} packed_history={run_cfg.packed_history}: "
               f"served {len(results)}/{len(load)} requests in {server.batches} batches, "
               f"{seconds:.4f} s ({len(load) / seconds:.2f} requests/s, "
               f"{len(load) * scfg.t_steps / seconds:.1f} sim-steps/s); launches {counts}")
        counted = counts[name.split("[")[0]]
        if counted != expect or counted == 0 or sum(counts.values()) != counted:
            raise SystemExit(f"{name}: launches {counts}, expected {expect} of {name} only")
        launches[name] = counted
        runs[name] = (server, results, seconds)

    server, results, seconds = runs["itp_stdp_update_packed"]
    rate = _check_served(cfg, scfg, load, server, results)

    # packed == unpacked, bit for bit, over the whole load
    u_server, u_results, _ = runs["itp_stdp_update"]
    if not all(np.array_equal(a.post, b.post) for a, b in zip(results, u_results)):
        raise SystemExit("packed vs unpacked: post rasters differ")
    _assert_states(_states(server), _states(u_server), exact=True, what="packed vs unpacked")
    ref_rps = _serve_parity(cfg, scfg, load, device, server, results, what="itp")
    _profile_batch(cfg, scfg, load[:scfg.max_batch], device)
    _phase("serve", f"itp parity OK: packed == unpacked (bitwise), fused == reference "
           f"(rasters and words exact, w/v/theta rtol=1e-5 atol=1e-6), solo == "
           f"interleaved (bitwise); mean post rate {rate:.4f}; reference backend "
           f"{ref_rps:.2f} requests/s")

    # the counter baseline 'exact' on the same load
    e_server, e_results, e_seconds = runs["counter_stdp_update[exact]"]
    e_rate = _check_served(exact_cfg, scfg, load, e_server, e_results)
    e_ref_rps = _serve_parity(exact_cfg, scfg, load, device, e_server, e_results,
                              what="exact")
    _phase("serve", f"exact parity OK: fused == reference, solo == interleaved (bitwise), "
           f"1 B/neuron; mean post rate {e_rate:.4f}; {len(load) / e_seconds:.2f} "
           f"requests/s fused, {e_ref_rps:.2f} on the reference backend")
    return {"launches": launches, "requests_per_s": len(load) / seconds,
            "sim_steps_per_s": len(load) * scfg.t_steps / seconds,
            "exact_requests_per_s": len(load) / e_seconds}


def _conv_bound(m: int, k: int, c: int, depth: int, packed: bool,
                window: str | None = None) -> tuple[float, str]:
    """Least time for one conv delta: the inputs read once (float32 spikes,
    one history or counter byte per element or 4·depth bytes of bitplanes,
    the (2, depth) po2 vectors or window table) and the (K, C) float32 delta
    written once, over the HBM rate, against the two contractions' multiply
    and add per term (plus a counter ``window``'s evaluation per element)
    over the float32 peak."""
    hist = (m * k + m * c) * (1 if packed else 4 * depth)
    nbytes = 4 * (m * k + m * c) + hist + 2 * 4 * depth + 4 * k * c
    ops = 4 * m * k * c + (WINDOW_OPS[window] * m * (k + c) if window else 0)
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
            device_ms = _device_ms(kern, "conv_delta_")
            dev_txt = "not measured" if device_ms is None else f"{device_ms:.5f} ms"
            _phase("conv_kernels", f"{name} {layer} ({m}x{k}x{c}, depth {CONV_DEPTH}): "
                   f"{ms:.5f} ms/call (CUDA events), kernel alone {dev_txt} (profiler), "
                   f"bound {bound_ms:.5f} ms ({bound_by}), plain "
                   f"{plain_ms:.5f} ms")
            report[name].setdefault("layers", {})[layer] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                device_ms=device_ms)
            if layer == "DCSNN conv1":
                report[name].update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                    bound_by=bound_by, device_ms=device_ms,
                                    shape=f"{layer} {m}x{k}x{c} depth={CONV_DEPTH}")
    return report


def _counter_bound(lanes: int, n_pre: int, n_post: int, depth: int,
                   window: str) -> tuple[float, str]:
    """Least time for one dense counter update: w read and written once, the
    spikes and counter words read once, the (2, depth) table, over the HBM
    rate, against 7 operations per synapse (gate, update, clip) plus two
    window evaluations per synapse (the per-pair contract) over the float32
    peak."""
    syn = lanes * n_pre * n_post
    neurons = lanes * (n_pre + n_post)
    nbytes = 2 * 4 * syn + 4 * neurons + neurons + 2 * 4 * depth
    ops = (7 + 2 * WINDOW_OPS[window]) * syn
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _timed(name: str, what: str, kern, plain, bound, kernel_name: str, *,
           phase: str = "counter_kernels") -> dict:
    """Time a kernel call (CUDA events and the profiler) and its plain
    version (``None``: not timed); print one line; return the numbers."""
    ms = _time_ms(kern)
    plain_ms = None if plain is None else _time_ms(plain, reps=10, inner=5)
    device_ms = _device_ms(kern, kernel_name)
    bound_ms, bound_by = bound
    dev_txt = "not measured" if device_ms is None else f"{device_ms:.5f} ms"
    plain_txt = "" if plain is None else f", plain {plain_ms:.5f} ms"
    _phase(phase, f"{name} {what}: {ms:.5f} ms/call (CUDA events), kernel "
           f"alone {dev_txt} (profiler), bound {bound_ms:.5f} ms ({bound_by}){plain_txt}")
    return dict(ms=ms, plain_ms=plain_ms, device_ms=device_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def phase_counter_kernels(device) -> dict:
    """Kernels 5-6 against their plain versions for every window: kernel 5 at
    serving's and the fc layers' shapes, kernel 6 at the four conv shapes,
    depth 7 and one depth-255 case each; run == run bitwise; every case
    timed (the kernels line reports serving's shape and DCSNN conv1 at depth
    7); beside them kernels 1 and 3 at equal shapes."""
    import torch

    from repro_torch.core.history import pack_bitplanes
    from repro_torch.core.stdp import STDPParams
    from repro_torch.kernels.itp_counter import kernel as NK
    from repro_torch.kernels.itp_counter import ref as NR
    from repro_torch.kernels.itp_counter.ops import counter_lut
    from repro_torch.kernels.itp_stdp import kernel as K
    from repro_torch.kernels.itp_stdp.ops import po2_vectors
    from repro_torch.kernels.itp_stdp_conv import kernel as CK

    p = STDPParams()
    gen = torch.Generator().manual_seed(13)
    report = {}

    def counters(shape, depth):
        return torch.randint(0, depth + 1, shape, generator=gen).to(torch.uint8).to(device)

    def spikes(shape, rate):
        return (torch.rand(shape, generator=gen) < rate).float().to(device)

    dense = [(case, shape, COUNTER_DEPTH) for case, shape in COUNTER_FC_CASES.items()]
    dense.append(("serving", COUNTER_FC_CASES["serving"], COUNTER_DEEP))
    for case, (lanes, n_pre, n_post), depth in dense:
        w = torch.rand((lanes, n_pre, n_post), generator=gen).to(device)
        pre_s, post_s = spikes((lanes, n_pre), 0.3), spikes((lanes, n_post), 0.3)
        pre_t, post_t = counters((lanes, n_pre), depth), counters((lanes, n_post), depth)
        lut = counter_lut(p, depth, device)
        for window in COUNTER_WINDOWS:
            name = f"counter_stdp_update[{window}]"
            kw = dict(depth=depth, window=window, a_plus=p.a_plus, a_minus=p.a_minus,
                      tau_plus=p.tau_plus, tau_minus=p.tau_minus, eta=1.0 / 16.0,
                      w_min=0.0, w_max=1.0)
            out = NK.counter_stdp_update(w, pre_s, post_s, pre_t, post_t, lut, **kw)
            again = NK.counter_stdp_update(w, pre_s, post_s, pre_t, post_t, lut, **kw)
            plain = NR.counter_stdp_update_ref(w, pre_s, post_s, pre_t, post_t, lut=lut, **kw)
            torch.cuda.synchronize()
            err = (out - plain).abs().max().item()
            bitwise = torch.equal(out, plain)
            close = bitwise or (window == "exact" and torch.allclose(out, plain, **WINDOW_TOL))
            ok = close and torch.equal(out, again) and bool(torch.isfinite(out).all())
            what = f"{case} {lanes}x{n_pre}x{n_post} depth={depth}"
            _phase("counter_kernels", f"{name} {what}: max|err|={err:.3g} (bit-equal "
                   f"{bitwise}), run-to-run {torch.equal(out, again)} -> "
                   f"{'OK' if ok else 'MISMATCH'}")
            if not ok:
                raise SystemExit(f"counter kernel mismatch: {name} at {what}")
            rep = report.setdefault(name, {"max_abs_err": 0.0})
            rep["max_abs_err"] = max(rep["max_abs_err"], err)
            t = _timed(name, what,
                       lambda: NK.counter_stdp_update(w, pre_s, post_s, pre_t, post_t, lut,
                                                      **kw),
                       lambda: NR.counter_stdp_update_ref(w, pre_s, post_s, pre_t, post_t,
                                                          lut=lut, **kw),
                       _counter_bound(lanes, n_pre, n_post, depth, window),
                       "counter_stdp_kernel")
            if case == "serving" and depth == COUNTER_DEPTH:
                rep.update(t, shape=what)
        if case == "serving" and depth == COUNTER_DEPTH:
            # ITP against the counter datapath at one shape: kernel 1 on the
            # same weights and spikes, fed random history words
            words = [torch.randint(0, 256, t.shape, generator=gen, dtype=torch.uint8)
                     .to(device) for t in (pre_t, post_t)]
            po2 = po2_vectors(p, depth, device=device)
            itp = _timed("itp_stdp_update_packed", f"{case} {lanes}x{n_pre}x{n_post} "
                         f"depth={depth} (beside kernel 5)",
                         lambda: K.itp_stdp_update_packed(w, pre_s, post_s, *words, *po2,
                                                          depth=depth, eta=1.0 / 16.0),
                         None, _bound(lanes, n_pre, n_post, depth, True),
                         "itp_stdp_kernel")
            _ratio_line("kernel 5 (exact) / kernel 1", report["counter_stdp_update[exact]"],
                        itp)

    conv = [(layer, shape, COUNTER_DEPTH) for layer, shape in CONV_CASES.items()]
    conv.append(("DCSNN conv1", CONV_CASES["DCSNN conv1"], COUNTER_DEEP))
    for layer, (m, k, c), depth in conv:
        pre, post = spikes((m, k), 0.3), spikes((m, c), 0.25)
        pre_t, post_t = counters((m, k), depth), counters((m, c), depth)
        lut = counter_lut(p, depth, device)
        for window in COUNTER_WINDOWS:
            name = f"counter_conv_delta[{window}]"
            kw = dict(depth=depth, window=window, a_plus=p.a_plus, a_minus=p.a_minus,
                      tau_plus=p.tau_plus, tau_minus=p.tau_minus)
            out = NK.counter_conv_delta(pre, post, pre_t, post_t, lut, **kw)
            again = NK.counter_conv_delta(pre, post, pre_t, post_t, lut, **kw)
            plain = NR.counter_conv_delta_ref(pre, post, pre_t, post_t, lut=lut, **kw)
            torch.cuda.synchronize()
            err = (out - plain).abs().max().item()
            bitwise = torch.equal(out, plain)
            close = bool(torch.isfinite(out).all()) and torch.allclose(out, plain, **CONV_TOL)
            ok = close and torch.equal(out, again)
            what = f"{layer} M={m} K={k} C={c} depth={depth}"
            _phase("counter_kernels", f"{name} {what}: max|err|={err:.3g} (bit-equal "
                   f"{bitwise}), run-to-run {torch.equal(out, again)} -> "
                   f"{'OK' if ok else 'MISMATCH'}")
            if not ok:
                raise SystemExit(f"counter conv kernel mismatch: {name} at {what}")
            rep = report.setdefault(name, {"max_abs_err": 0.0})
            rep["max_abs_err"] = max(rep["max_abs_err"], err)
            t = _timed(name, what,
                       lambda: NK.counter_conv_delta(pre, post, pre_t, post_t, lut, **kw),
                       lambda: NR.counter_conv_delta_ref(pre, post, pre_t, post_t, lut=lut,
                                                         **kw),
                       _conv_bound(m, k, c, depth, True, window), "conv_delta_")
            if layer == "DCSNN conv1" and depth == COUNTER_DEPTH:
                rep.update(t, shape=what)
        if layer == "DCSNN conv1" and depth == COUNTER_DEPTH:
            bits = [(torch.rand((depth, *x.shape), generator=gen) < 0.3).float().to(device)
                    for x in (pre, post)]
            words = [pack_bitplanes(b) for b in bits]
            po2 = po2_vectors(p, depth, device=device)
            itp = _timed("itp_stdp_conv_delta_packed", f"{layer} M={m} K={k} C={c} "
                         f"depth={depth} (beside kernel 6)",
                         lambda: CK.itp_stdp_conv_delta_packed(pre, post, *words, *po2,
                                                               depth=depth),
                         None, _conv_bound(m, k, c, depth, True), "conv_delta_")
            _ratio_line("kernel 6 (exact) / kernel 3", report["counter_conv_delta[exact]"],
                        itp)
    return report


def _ratio_line(what: str, counter: dict, itp: dict) -> None:
    dev = ("not measured" if counter["device_ms"] is None or itp["device_ms"] is None
           else f"{counter['device_ms'] / itp['device_ms']:.3f}")
    _phase("counter_kernels", f"ITP vs counter, {what}: {counter['ms'] / itp['ms']:.3f} "
           f"(CUDA events), {dev} (device time)")


def _qwen3_shapes(layers: int) -> dict:
    """The parameter tree of qwen3-0.6b with ``layers`` stacked blocks, leaf
    shapes as the JAX package's ``models/transformer.py:107 init_model``
    builds them: the embedding (``layers.py:133``, tied, so no output
    matrix), the final RMS norm, and per block two norms, attention
    (``attention.py:25``: wq, wk, wv, wo, q/k norms) and the SwiGLU MLP
    (``layers.py:99``: gate, up, down)."""
    d, hd, ff = QWEN3["d_model"], QWEN3["head_dim"], QWEN3["d_ff"]
    q, kv, n = QWEN3["n_heads"] * hd, QWEN3["n_kv_heads"] * hd, layers
    return {"embed": {"tok": (QWEN3["vocab"], d)}, "final_norm": {"scale": (d,)},
            "blocks": {"norm1": {"scale": (n, d)}, "norm2": {"scale": (n, d)},
                       "attn": {"wq": (n, d, q), "wk": (n, d, kv), "wv": (n, d, kv),
                                "wo": (n, q, d), "q_norm": (n, hd), "k_norm": (n, hd)},
                       "mlp": {"gate": (n, d, ff), "up": (n, d, ff), "down": (n, ff, d)}}}


def _fill(shapes: dict, make) -> dict:
    """A tree of tensors ``make(path, shape)`` shaped as the dict of shapes."""
    return {k: _fill(v, make) if isinstance(v, dict) else make(k, v)
            for k, v in shapes.items()}


def _side_bound(name: str, n: int) -> tuple[float, str]:
    t_bytes = SIDE_BYTES[name] * n / HBM_BYTES_PER_S
    t_ops = SIDE_OPS[name] * n / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _side_check(name: str, what: str, out, plain) -> dict:
    """Hold a kernel's outputs against its plain version's, bitwise."""
    import torch

    torch.cuda.synchronize()
    equal = all(torch.equal(a, b) for a, b in zip(out, plain))
    err = max((a.double() - b.double()).abs().max().item() for a, b in zip(out, plain))
    _phase("side_numerics", f"{name} {what}: max|err|={err:.3g}, bit-equal {equal} -> "
           f"{'OK' if equal else 'MISMATCH'}")
    if not equal:
        raise SystemExit(f"side kernel mismatch: {name} at {what}")
    return {"max_abs_err": err}


def phase_side_numerics(device) -> dict:
    """Kernels 7-10 on their paths: the neuron datapath (float and fixed
    point) at the DCSNN conv1 population, ITP-AdamW on qwen3-0.6b's leaf
    shapes, the drift model; then each kernel against its plain version at
    the path's shapes, timed."""
    import torch

    from repro_torch.core import lif as TL
    from repro_torch.core.drift import paper_metrics
    from repro_torch.core.encoding import isi_histogram_batched, select_history_depth
    from repro_torch.distributed.compression import (_decode_int8, _encode_int8,
                                                     compression_error)
    from repro_torch.kernels.lif import kernel as LK
    from repro_torch.kernels.lif.ops import lif_step_kernel
    from repro_torch.kernels.lif.ref import lif_update_ref
    from repro_torch.kernels.llsmu import kernel as MK
    from repro_torch.kernels.llsmu.ref import llsmu_multiply_ref
    from repro_torch.kernels.po2_quant import kernel as PK
    from repro_torch.kernels.po2_quant import ref as PR
    from repro_torch.kernels.po2_quant.ops import po2_quantize
    from repro_torch.train import optimizer as OPT
    from repro_torch.tree import tree_leaves

    report, launches = {}, {}
    counters = {"lif_update": LK.lif_update, "llsmu_multiply": MK.llsmu_multiply,
                "po2_encode": PK.po2_encode, "po2_decode": PK.po2_decode}

    # --- the neuron datapath: 30 steps, float (kernel 7) and fixed point (8)
    p = TL.LIFParams()
    gen = torch.Generator(device=device).manual_seed(14)
    currents = torch.rand((LIF_STEPS, *LIF_POPULATION), generator=gen, device=device) * 0.8
    fl = plain_fl = TL.lif_init(LIF_POPULATION, p, device=device)
    fx = plain_fx = TL.lif_fixed_init(LIF_POPULATION, p, LIF_FRAC_BITS, device=device)
    raster, same = [], True
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i_in in currents:
        fl, s_fl = lif_step_kernel(fl, i_in, p)
        fx, s_fx = TL.lif_step_llsmu(fx, i_in, p, frac_bits=LIF_FRAC_BITS)
        raster.append(s_fx)
        # the same step on the plain versions (no launches)
        plain_fl, ps_fl = lif_step_kernel(plain_fl, i_in, p, use_kernel=False)
        plain_fx, ps_fx = TL.lif_step_llsmu(plain_fx, i_in, p, frac_bits=LIF_FRAC_BITS,
                                            use_kernel=False)
        same &= (torch.equal(fl.v, plain_fl.v) and torch.equal(s_fl, ps_fl)
                 and torch.equal(fx.v_q, plain_fx.v_q) and torch.equal(s_fx, ps_fx))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: fn.launches for k, fn in counters.items()}
    want = {"lif_update": LIF_STEPS, "llsmu_multiply": LIF_STEPS, "po2_encode": 0,
            "po2_decode": 0}
    n_pop = LIF_POPULATION[0] * LIF_POPULATION[1]
    rates = (torch.stack(raster).float().mean().item(), s_fl.float().mean().item())
    _phase("side_numerics", f"neuron datapath {LIF_POPULATION[0]}x{LIF_POPULATION[1]} "
           f"(DCSNN conv1, LIFParams()), {LIF_STEPS} steps: float and fixed-point "
           f"(frac_bits {LIF_FRAC_BITS}, n_bits 4) each step equal to the plain versions "
           f"{same}; fixed-point rate {rates[0]:.4f}, last float step {rates[1]:.4f}; "
           f"{wall * 1e3:.3f} ms with the plain steps; launches {counts}")
    if not same or counts != want:
        raise SystemExit(f"neuron datapath: equal {same}, launches {counts}, want {want}")
    launches.update(lif_update=counts["lif_update"], llsmu_multiply=counts["llsmu_multiply"])
    stats = isi_histogram_batched(torch.stack(raster).reshape(LIF_STEPS, n_pop))
    depth = select_history_depth(stats)
    _phase("side_numerics", f"ISI of the fixed-point raster: {stats.n_spikes} spikes, "
           f"{stats.n_intervals} intervals, coverage at depth 7 {stats.coverage(7):.4f}; "
           f"depth selected for 99 % coverage {depth} (the paper's: {PAPER_HISTORY_DEPTH})")

    # --- ITP-AdamW on qwen3-0.6b's leaf shapes (kernels 9-10)
    shapes = _qwen3_shapes(QWEN3_LAYERS)
    g = torch.Generator(device=device).manual_seed(15)

    def init(name, shape):
        if name in ("scale", "q_norm", "k_norm"):
            return torch.ones(shape, device=device)
        return torch.randn(shape, generator=g, device=device) * 0.02

    params = _fill(shapes, init)
    leaves = len(tree_leaves(params))
    n_params = sum(x.numel() for x in tree_leaves(params))

    def grads(step):
        gg = torch.Generator(device=device).manual_seed(100 + step)
        return _fill(shapes, lambda _, shape: torch.randn(shape, generator=gg, device=device)
                     * 1e-3)

    cfg = OPT.OptimizerConfig(po2_update=True)

    def run(use_kernel):
        prm, st = params, OPT.init_opt_state(params)
        for step in range(ADAMW_STEPS):
            prm, st, metrics = OPT.adamw_update(cfg, prm, grads(step), st,
                                                use_kernel=use_kernel)
        return prm, st, metrics

    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kp, ks, km = run(True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: fn.launches for k, fn in counters.items()}
    want = {"lif_update": 0, "llsmu_multiply": 0, "po2_encode": leaves * ADAMW_STEPS,
            "po2_decode": leaves * ADAMW_STEPS}
    pp, ps, _ = run(False)
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves((kp, ks.mu, ks.nu)),
                                                 tree_leaves((pp, ps.mu, ps.nu))))
    moved = sum(int((a != b).sum()) for a, b in zip(tree_leaves(kp), tree_leaves(params)))
    _phase("side_numerics", f"ITP-AdamW on qwen3-0.6b leaf shapes ({QWEN3_LAYERS} of "
           f"{QWEN3['n_layers']} layers: a cut that bounds chip time; {leaves} leaves, "
           f"{n_params} float32 parameters), {ADAMW_STEPS} steps: {wall * 1e3:.3f} ms "
           f"(gradients drawn inside); lr {float(km['lr']):.6g}, grad norm "
           f"{float(km['grad_norm']):.6g}; {moved} parameters moved; kernels == plain "
           f"quantiser (parameters and moments, bitwise) {same}; launches {counts}")
    if not same or counts != want:
        raise SystemExit(f"ITP-AdamW: equal {same}, launches {counts}, want {want}")
    launches.update(po2_encode=counts["po2_encode"], po2_decode=counts["po2_decode"])
    del pp, ps, kp, ks
    last = grads(ADAMW_STEPS - 1)
    err = float(compression_error(last))
    tok = last["embed"]["tok"]
    wire = _encode_int8(tok)
    round_trip = torch.equal(_decode_int8(wire), po2_quantize(tok, use_kernel=False))
    _phase("side_numerics", f"po2 wire codec: compression error over the gradient tree "
           f"{err:.6f}; embedding gradient {tuple(tok.shape)} as {wire.numel()} int8 bytes "
           f"({wire.element_size()} B/element against 4), round trip == po2_quantize "
           f"{round_trip}")
    if not round_trip or not err < 0.25:
        raise SystemExit(f"po2 wire codec: round trip {round_trip}, error {err}")

    # --- the drift model (§IV-A), on the card
    t0 = time.perf_counter()
    m = paper_metrics(device=device)
    wall = time.perf_counter() - t0
    _phase("side_numerics", f"drift (paper §IV-A): update-curve RMSE "
           f"{m['update_curve_rmse']:.6f} (paper 0.094753), equilibrium shift "
           f"{m['equilibrium_rel_err']:.4f} (paper 0.2469), convergence-time error "
           f"{m['convergence_time_rel_err']:.4f} (paper 0.0736), compensated RMSE "
           f"{m['update_curve_rmse_compensated']:.3g}; {wall:.3f} s")
    if not (abs(m["update_curve_rmse"] - DRIFT_RMSE) < DRIFT_RMSE_TOL
            and m["update_curve_rmse_compensated"] < 1e-6):
        raise SystemExit(f"drift metrics off: {m}")

    # --- each kernel against its plain version at the path's shapes, timed
    v, i_in = fl.v, currents[-1]
    kw = dict(alpha=p.alpha, e_rest=p.e_rest, v_th=p.v_th)
    what = f"{LIF_POPULATION[0]}x{LIF_POPULATION[1]}"
    report["lif_update"] = _side_check("lif_update", what, LK.lif_update(v, i_in, **kw),
                                       lif_update_ref(v, i_in, **kw))
    e_q = round(p.e_rest * (1 << LIF_FRAC_BITS))
    a = torch.abs(fx.v_q - e_q).contiguous()
    b = torch.full_like(a, round(p.alpha * (1 << LIF_FRAC_BITS)))
    report["llsmu_multiply"] = _side_check("llsmu_multiply", what,
                                           (MK.llsmu_multiply(a, b),),
                                           (llsmu_multiply_ref(a, b),))
    codes = PK.po2_encode(tok)
    emb = f"embedding {tok.shape[0]}x{tok.shape[1]}"
    report["po2_encode"] = _side_check("po2_encode", emb, (codes,), (PR.po2_encode_ref(tok),))
    report["po2_decode"] = _side_check("po2_decode", emb, (PK.po2_decode(codes),),
                                       (PR.po2_decode_ref(codes),))
    timings = {
        "lif_update": (lambda: LK.lif_update(v, i_in, **kw),
                       lambda: lif_update_ref(v, i_in, **kw), n_pop, what),
        "llsmu_multiply": (lambda: MK.llsmu_multiply(a, b), lambda: llsmu_multiply_ref(a, b),
                           n_pop, what),
        "po2_encode": (lambda: PK.po2_encode(tok), lambda: PR.po2_encode_ref(tok),
                       tok.numel(), emb),
        "po2_decode": (lambda: PK.po2_decode(codes), lambda: PR.po2_decode_ref(codes),
                       codes.numel(), emb),
    }
    for name, (kern, plain, n, shape) in timings.items():
        report[name].update(_timed(name, shape, kern, plain, _side_bound(name, n),
                                   f"{name}_kernel", phase="side_numerics"), shape=shape)
    return {"kernels": report, "launches": launches}


def _train_counters():
    from repro_torch.kernels.itp_counter import kernel as NK
    from repro_torch.kernels.itp_stdp import kernel as K
    from repro_torch.kernels.itp_stdp_conv import kernel as CK

    return {"itp_stdp_update_packed": K.itp_stdp_update_packed,
            "itp_stdp_update": K.itp_stdp_update,
            "itp_stdp_conv_delta_packed": CK.itp_stdp_conv_delta_packed,
            "itp_stdp_conv_delta": CK.itp_stdp_conv_delta,
            "counter_stdp_update": NK.counter_stdp_update,
            "counter_conv_delta": NK.counter_conv_delta}


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
    fused and reference (and, for the history rules, fused unpacked) for the
    parity checks."""
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
    counter_rule = cfg.rule in COUNTER_WINDOWS
    conv_kernel, fc_kernel = (("counter_conv_delta", "counter_stdp_update") if counter_rule
                              else ("itp_stdp_conv_delta_packed", "itp_stdp_update_packed"))
    want = dict.fromkeys(counters, 0)
    want.update({conv_kernel: conv_layers * steps, fc_kernel: steps})
    st = res["state"]
    levels = (1 << (cfg.w_bits - 1)) - 1
    finite = all(bool(torch.isfinite(w).all()) for w in st.weights)
    on_grid = all(bool(torch.allclose(w * levels, torch.round(w * levels), atol=1e-3))
                  for w in st.weights)
    samples = tcfg.batch * tcfg.batches_per_epoch * tcfg.epochs
    _phase("train", f"{net} rule={cfg.rule} fused (full width, batch {tcfg.batch}, "
           f"t_steps {tcfg.t_steps}, "
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
    # (a counter rule has one word layout: packed_history does not apply)
    source = SamplerSource(sampler, tcfg)
    batches = [b["spikes"].to(device) for b in source.train_batches(0)]
    flt = dataclasses.replace(cfg, quantise=False)
    st_p, cnt_p = _run_batches(flt, batches, tcfg.batch, device)
    unpacked_launches, same_u = None, True
    if not counter_rule:
        for fn in counters.values():
            fn.launches = 0
        st_u, cnt_u = _run_batches(dataclasses.replace(flt, packed_history=False), batches,
                                   tcfg.batch, device)
        unpacked_launches = counters["itp_stdp_conv_delta"].launches
        if unpacked_launches != conv_layers * tcfg.t_steps * len(batches):
            raise SystemExit(f"{net}: {unpacked_launches} unpacked conv launches")
        same_u = (all(torch.equal(a, b) for a, b in zip(cnt_p, cnt_u))
                  and all(torch.equal(a, b) for a, b in zip(st_p.weights, st_u.weights)))
    st_r, cnt_r = _run_batches(dataclasses.replace(flt, backend="reference"), batches,
                               tcfg.batch, device)
    counts_ok = all(torch.equal(a, b) for a, b in zip(cnt_p, cnt_r))
    w_err = max((a - b).abs().max().item() for a, b in zip(st_p.weights, st_r.weights))
    w_ok = all(torch.allclose(a, b, **TRAIN_TOL) for a, b in zip(st_p.weights, st_r.weights))
    bitwise = all(torch.equal(a, b) for a, b in zip(st_p.weights, st_r.weights))
    spikes = sum(float(c.sum()) for c in cnt_p)
    unpacked = ("n/a" if counter_rule
                else f"{same_u} ({unpacked_launches} unpacked conv launches)")
    _phase("train", f"{net} rule={cfg.rule} quantise=False on the same {len(batches)} "
           f"batches: packed == unpacked {unpacked}; fused vs "
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
                    f"{tcfg.t_steps} steps, rule {cfg.rule}, fused)")


def _accuracy_protocol(rule: str, device) -> dict:
    """The 2-layer SNN under BENCH_accuracy.json's protocol with ``rule``, the
    launch counters set to 0 just before and read just after."""
    import torch

    from repro_torch.launch.cli import sampler_for
    from repro_torch.models import snn
    from repro_torch.train.stdp_trainer import TrainerConfig, train_to_accuracy

    sampler, n_classes = sampler_for("2layer-snn")
    cfg = snn.mnist_2layer(rule, backend="fused", theta_plus=0.05, hard_wta=True)
    tcfg = TrainerConfig(**ACCURACY_TRAIN)
    counters = _train_counters()
    for fn in counters.values():
        fn.launches = 0
    res = train_to_accuracy(cfg, sampler, n_classes, tcfg, device=device)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    fc_kernel = "counter_stdp_update" if rule in COUNTER_WINDOWS else "itp_stdp_update_packed"
    steps = tcfg.epochs * tcfg.batches_per_epoch * tcfg.t_steps
    _phase("train", f"2layer-snn (784x100, rule={rule}, fused, BENCH_accuracy protocol): "
           f"accuracy curve {res['accuracy_curve']} (final {res['final_accuracy']:.4f}, "
           f"floor {ACCURACY_FLOOR}), train {res['train_seconds']:.3f} s = "
           f"{steps / res['train_seconds']:.1f} sim-steps/s, "
           f"{tcfg.epochs * tcfg.batches_per_epoch * tcfg.batch / res['train_seconds']:.2f} "
           f"samples/s; fc launches {launches[fc_kernel]}")
    if launches[fc_kernel] != steps or sum(launches.values()) != steps:
        raise SystemExit(f"2layer-snn {rule}: launches {launches}, expected {steps} "
                         f"of {fc_kernel} only")
    if not res["final_accuracy"] >= ACCURACY_FLOOR:
        raise SystemExit(f"2layer-snn {rule}: final accuracy {res['final_accuracy']} < "
                         f"{ACCURACY_FLOOR}")
    return {"accuracy_curve": res["accuracy_curve"], "final": res["final_accuracy"],
            "sim_steps_per_s": steps / res["train_seconds"],
            "launches": {fc_kernel: launches[fc_kernel]}}


def phase_train(device) -> dict:
    import dataclasses

    from repro_torch.models import snn
    from repro_torch.train.stdp_trainer import TrainerConfig

    out = {}
    dcsnn, dcsnn_t = snn.fmnist_dcsnn(backend="fused"), TrainerConfig(**DCSNN_TRAIN)
    csnn_t = TrainerConfig(**CSNN_TRAIN)
    out["6layer-dcsnn"] = _train_net("6layer-dcsnn", dcsnn, dcsnn_t, device, conv_layers=2)
    out["5layer-csnn"] = _train_net("5layer-csnn", snn.fault_csnn(backend="fused"), csnn_t,
                                    device, conv_layers=2)
    out["2layer-snn"] = _accuracy_protocol("itp", device)

    # the counter baselines: exact on the DCSNN (3 batches), one batch each of
    # linear on the CSNN and imstdp on the DCSNN, exact under the protocol
    dcsnn_exact = snn.fmnist_dcsnn("exact", backend="fused")
    out["6layer-dcsnn exact"] = _train_net("6layer-dcsnn", dcsnn_exact, dcsnn_t, device,
                                           conv_layers=2)
    out["5layer-csnn linear"] = _train_net("5layer-csnn",
                                           snn.fault_csnn("linear", backend="fused"),
                                           csnn_t, device, conv_layers=2)
    out["6layer-dcsnn imstdp"] = _train_net(
        "6layer-dcsnn", snn.fmnist_dcsnn("imstdp", backend="fused"),
        dataclasses.replace(dcsnn_t, batches_per_epoch=1), device, conv_layers=2)
    out["2layer-snn exact"] = exact = _accuracy_protocol("exact", device)
    itp = out["2layer-snn"]
    gap = abs(itp["final"] - exact["final"])
    _phase("train", f"2layer-snn itp vs exact: final {itp['final']:.4f} vs "
           f"{exact['final']:.4f}, gap {gap:.4f} (tolerance {ITP_GAP_TOL}); curves "
           f"identical {itp['accuracy_curve'] == exact['accuracy_curve']}")
    if not gap <= ITP_GAP_TOL:
        raise SystemExit(f"2layer-snn: itp vs exact gap {gap} > {ITP_GAP_TOL}")
    _profile_train_batch(dcsnn, dcsnn_t, device)
    _profile_train_batch(dcsnn_exact, dcsnn_t, device)
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
           f"{serve['sim_steps_per_s']:.1f} sim-steps/s (itp); "
           f"{serve['exact_requests_per_s']:.2f} requests/s (exact)")
    kernels.update(phase_conv_kernels(device))
    kernels.update(phase_counter_kernels(device))
    side = phase_side_numerics(device)
    kernels.update(side["kernels"])
    train = phase_train(device)
    dcsnn = train["6layer-dcsnn"]
    # launches: each kernel's count from the run of its main path (serving for
    # the dense kernels, DCSNN training for the conv kernels; for the counter
    # windows the exact serving load and DCSNN run, the linear CSNN run and
    # the imstdp DCSNN run)
    launches = dict(serve["launches"],
                    itp_stdp_conv_delta_packed=dcsnn["launches"]["itp_stdp_conv_delta_packed"],
                    itp_stdp_conv_delta=dcsnn["unpacked_launches"])
    for window, run in (("exact", "6layer-dcsnn exact"), ("linear", "5layer-csnn linear"),
                        ("imstdp", "6layer-dcsnn imstdp")):
        counts = train[run]["launches"]
        launches[f"counter_conv_delta[{window}]"] = counts["counter_conv_delta"]
        launches.setdefault(f"counter_stdp_update[{window}]", counts["counter_stdp_update"])
    launches.update(side["launches"])   # the neuron datapath and ITP-AdamW runs
    if not all(launches[name] > 0 for name in kernels):
        raise SystemExit(f"a kernel of the path was never launched: {launches}")
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
