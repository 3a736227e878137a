#!/usr/bin/env python3
"""Device time of the port's update kernels at the shapes the main path
launches them, on one GPU.

Kernels 1 (``itp_stdp_update_packed``), 2 (``itp_stdp_update``) and 5
(``counter_stdp_update``, each window) at depth 7, at serving's 8 × 784 × 100
and the fc layers' batch-16 shapes (2layer-snn 784 × 100, DCSNN 600 × 128,
CSNN 480 × 64; the batch is the lane axis).  Each case is first held against
its plain version (``torch.equal``; the exact window within rtol=atol=1e-6),
then timed: device ms per call from a profiler trace of 50 calls (the
``chip_smoke.py`` method), CUDA-event ms per call, and the bound of
``chip_smoke.py``.  Then the conv deltas, kernels 3 (``itp_stdp_conv_delta_packed``),
4 (``itp_stdp_conv_delta``) and 6 (``counter_conv_delta``, each window), at
the four conv layers of ``chip_smoke.CONV_CASES``, depth 7, held against
their plain versions within the conv tolerance and timed likewise.

Last it ranks the kernels as rule 2 of the port reads them: launches ×
(device − bound), summed over the shapes, with each kernel's launches per
shape in one run of ``chip_smoke.py`` (``LAUNCHES``: serving's 4 batches ×
16 steps; the fc and conv layers once per step of the training runs).

``--src DIR`` imports ``repro_torch`` from another checkout's ``src`` (an
unpacked parent commit, say), so two versions of the kernels are compared
in one process on one card.  Run from the repository root:

    python3 tools/time_kernels.py [--src DIR] [--label NAME]

It prints one line per case and, last, one JSON object with every case.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as S  # noqa: E402  (after the path; imports no repro_torch)

SHAPES = {"serving": (8, 784, 100), **{k: v for k, v in S.COUNTER_FC_CASES.items()
                                       if k != "serving"}}
DEPTH = 7
# launches per shape in one run of chip_smoke.py: serving 4 batches x 16
# steps; the DCSNN 3 batches x 30 steps (itp packed and unpacked, exact) or
# 1 batch (imstdp); the CSNN 1 batch (itp packed and unpacked, linear); the
# 2layer-snn protocol 6 epochs x 8 batches x 30 steps (itp, exact)
_DCSNN, _CSNN, _CONV = {"DCSNN fc": 90}, {"CSNN fc": 30}, {
    "DCSNN conv1": 90, "DCSNN conv2": 90, "CSNN conv1": 30, "CSNN conv2": 30}
LAUNCHES = {
    "itp_stdp_update_packed": {"serving": 64, "2layer-snn fc": 1440, **_DCSNN, **_CSNN},
    "itp_stdp_update": {"serving": 64, **_DCSNN, **_CSNN},
    "counter_stdp_update[exact]": {"serving": 64, "2layer-snn fc": 1440, **_DCSNN},
    "counter_stdp_update[linear]": dict(_CSNN),
    "counter_stdp_update[imstdp]": {"DCSNN fc": 30},
    "itp_stdp_conv_delta_packed": dict(_CONV),
    "itp_stdp_conv_delta": dict(_CONV),
    "counter_conv_delta[exact]": {"DCSNN conv1": 90, "DCSNN conv2": 90},
    "counter_conv_delta[linear]": {"CSNN conv1": 30, "CSNN conv2": 30},
    "counter_conv_delta[imstdp]": {"DCSNN conv1": 30, "DCSNN conv2": 30},
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch is timed")
    ap.add_argument("--label", default="", help="a name printed with every line")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))

    import torch

    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch.core.stdp import STDPParams
    from repro_torch.kernels.itp_counter import kernel as NK
    from repro_torch.kernels.itp_counter import ref as NR
    from repro_torch.kernels.itp_counter.ops import counter_lut
    from repro_torch.kernels.itp_stdp import kernel as K
    from repro_torch.kernels.itp_stdp import ref as R
    from repro_torch.kernels.itp_stdp.ops import po2_vectors

    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    label = args.label or str(Path(repro_torch.__file__).resolve().parents[1])
    print(f"[{label}] {smi}; repro_torch from {Path(repro_torch.__file__).parent}", flush=True)
    p = STDPParams()
    po2 = po2_vectors(p, DEPTH, device=device)
    lut = counter_lut(p, DEPTH, device)
    results = []
    for case, (lanes, n_pre, n_post) in SHAPES.items():
        gen = torch.Generator().manual_seed(lanes * n_pre + n_post)
        w, pre_s, post_s, pre_wd, post_wd, pre_b, post_b = S._inputs(
            lanes, n_pre, n_post, DEPTH, gen, device)
        pre_t, post_t = (torch.randint(0, DEPTH + 1, (lanes, n), generator=gen)
                         .to(torch.uint8).to(device) for n in (n_pre, n_post))
        kw = dict(nearest=True, eta=1.0 / 16.0, w_min=0.0, w_max=1.0)
        runs = {
            "itp_stdp_update_packed": (
                lambda: K.itp_stdp_update_packed(w, pre_s, post_s, pre_wd, post_wd, *po2,
                                                 depth=DEPTH, **kw),
                lambda: R.itp_stdp_update_packed_ref(w, pre_s, post_s, pre_wd, post_wd, *po2,
                                                     depth=DEPTH, **kw),
                S._bound(lanes, n_pre, n_post, DEPTH, True), "itp_stdp_kernel", None),
            "itp_stdp_update": (
                lambda: K.itp_stdp_update(w, pre_s, post_s, pre_b, post_b, *po2, **kw),
                lambda: R.itp_stdp_update_ref(w, pre_s, post_s, pre_b, post_b, *po2, **kw),
                S._bound(lanes, n_pre, n_post, DEPTH, False), "itp_stdp_kernel", None),
        }
        for window in S.COUNTER_WINDOWS:
            ckw = dict(depth=DEPTH, window=window, a_plus=p.a_plus, a_minus=p.a_minus,
                       tau_plus=p.tau_plus, tau_minus=p.tau_minus, eta=1.0 / 16.0,
                       w_min=0.0, w_max=1.0)
            runs[f"counter_stdp_update[{window}]"] = (
                lambda ckw=ckw: NK.counter_stdp_update(w, pre_s, post_s, pre_t, post_t, lut,
                                                       **ckw),
                lambda ckw=ckw: NR.counter_stdp_update_ref(w, pre_s, post_s, pre_t, post_t,
                                                           lut=lut, **ckw),
                S._counter_bound(lanes, n_pre, n_post, DEPTH, window), "counter_stdp_kernel",
                window)
        for name, (kern, plain, (bound_ms, bound_by), kernel_name, window) in runs.items():
            out, ref = kern(), plain()
            torch.cuda.synchronize()
            ok = torch.equal(out, ref) or (window == "exact"
                                           and torch.allclose(out, ref, **S.WINDOW_TOL))
            if not ok:
                raise SystemExit(f"{name} at {case}: kernel != plain version")
            ms = S._time_ms(kern)
            device_ms = S._device_ms(kern, kernel_name)
            dev = "not measured" if device_ms is None else f"{device_ms:.5f}"
            print(f"[{label}] {name} {case} {lanes}x{n_pre}x{n_post} depth={DEPTH}: device "
                  f"{dev} ms, events {ms:.5f} ms, bound {bound_ms:.5f} ms ({bound_by})",
                  flush=True)
            results.append(dict(name=name, case=case, shape=[lanes, n_pre, n_post],
                                device_ms=device_ms, ms=ms, bound_ms=bound_ms))

    from repro_torch.core.history import pack_bitplanes
    from repro_torch.kernels.itp_stdp_conv import kernel as CK
    from repro_torch.kernels.itp_stdp_conv import ref as CR

    for case, (m, k, c) in S.CONV_CASES.items():
        gen = torch.Generator().manual_seed(m + k + c)
        pre = (torch.rand((m, k), generator=gen) < 0.3).float().to(device)
        post = (torch.rand((m, c), generator=gen) < 0.25).float().to(device)
        pre_b = (torch.rand((DEPTH, m, k), generator=gen) < 0.3).float().to(device)
        post_b = (torch.rand((DEPTH, m, c), generator=gen) < 0.25).float().to(device)
        pre_w, post_w = pack_bitplanes(pre_b), pack_bitplanes(post_b)
        pre_t = torch.randint(0, DEPTH + 1, (m, k), generator=gen).to(torch.uint8).to(device)
        post_t = torch.randint(0, DEPTH + 1, (m, c), generator=gen).to(torch.uint8).to(device)
        runs = {
            "itp_stdp_conv_delta_packed": (
                lambda: CK.itp_stdp_conv_delta_packed(pre, post, pre_w, post_w, *po2,
                                                      depth=DEPTH),
                lambda: CR.itp_stdp_conv_delta_ref(pre, post, pre_b, post_b, *po2),
                S._conv_bound(m, k, c, DEPTH, True)),
            "itp_stdp_conv_delta": (
                lambda: CK.itp_stdp_conv_delta(pre, post, pre_b, post_b, *po2),
                lambda: CR.itp_stdp_conv_delta_ref(pre, post, pre_b, post_b, *po2),
                S._conv_bound(m, k, c, DEPTH, False)),
        }
        for window in S.COUNTER_WINDOWS:
            ckw = dict(depth=DEPTH, window=window, a_plus=p.a_plus, a_minus=p.a_minus,
                       tau_plus=p.tau_plus, tau_minus=p.tau_minus)
            runs[f"counter_conv_delta[{window}]"] = (
                lambda ckw=ckw: NK.counter_conv_delta(pre, post, pre_t, post_t, lut, **ckw),
                lambda ckw=ckw: NR.counter_conv_delta_ref(pre, post, pre_t, post_t, lut=lut,
                                                          **ckw),
                S._conv_bound(m, k, c, DEPTH, True, window))
        for name, (kern, plain, (bound_ms, bound_by)) in runs.items():
            out, ref = kern(), plain()
            torch.cuda.synchronize()
            if not torch.allclose(out, ref, **S.CONV_TOL):
                raise SystemExit(f"{name} at {case}: kernel != plain version")
            ms = S._time_ms(kern)
            device_ms = S._device_ms(kern, "conv_delta_")
            dev = "not measured" if device_ms is None else f"{device_ms:.5f}"
            print(f"[{label}] {name} {case} {m}x{k}x{c} depth={DEPTH}: device {dev} ms, "
                  f"events {ms:.5f} ms, bound {bound_ms:.5f} ms ({bound_by})", flush=True)
            results.append(dict(name=name, case=case, shape=[m, k, c], device_ms=device_ms,
                                ms=ms, bound_ms=bound_ms))
    ranking = {}
    for c in results:
        n = LAUNCHES[c["name"]].get(c["case"], 0)
        if n and c["device_ms"] is not None:
            ranking.setdefault(c["name"], 0.0)
            ranking[c["name"]] += n * (c["device_ms"] - c["bound_ms"])
    for name, lost in sorted(ranking.items(), key=lambda kv: -kv[1]):
        print(f"[{label}] rank: {name}: {sum(LAUNCHES[name].values())} launches, "
              f"launches x (device - bound) = {lost:.3f} ms per chip_smoke run", flush=True)
    print(json.dumps({"label": label, "card": smi, "cases": results, "ranking": ranking}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
