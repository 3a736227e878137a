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
their plain versions within the conv tolerance and timed likewise; kernels 3
and 4 also at the fc layers' shapes (``FC_CASES``: chip_smoke's batch-16
layers and ``chip_smoke.FC_CASES``, the benchmark's 256 × 784 × 6,400 and
2,048 × 600 × 128), where they sum the batch of the SNN fc delta.  Then the
counter rules' fc delta (``counter_fc_delta``, each window) at
``chip_smoke.COUNTER_SUM_CASES`` (the dense shapes and the benchmark's
256 × 784 × 6,400), held against its plain version within the conv tolerance
and timed likewise, beside the per-lane path it replaced (a zero ``w``
through kernel 5, summed over the lanes in float64; CUDA events), which a
version without the fc delta times alone.

Then the side kernels, 7 (``lif_update``), 8 (``llsmu_multiply``, on
element pairs and, where the version has it, with one ``b`` for every
element: ``llsmu_multiply[scalar b]``, the variant the neuron datapath
launches), 9 (``po2_encode``) and 10 (``po2_decode``), each held bit for bit
against its plain version and timed beside its byte bound at the shape
``chip_smoke.py`` times it (16 × 6,912 neurons for 7-8, qwen3-0.6b's
embedding, 151,936 × 1,024, for 9-10) and at 2^24 elements, where bytes
rather than the launch set the time; each wrapper's host µs per call at
16 × 6,912 elements (least of 9 windows of 1,000 calls, no sync), with
two steps every wrapper takes, ``torch.empty_like`` of one output and
``torch.cuda.current_stream``, timed alone; two
PyTorch calls that move bytes as the side kernels do (``torch.add`` and
``torch.neg`` into a preallocated output: 12 and 8 bytes an element, reads
and writes 2:1 and 1:1), at both sizes, as the yardstick of the rate an
elementwise launch reaches on the card; and a kernel with an empty body
(built here from ``NOOP_SOURCE``), launched with one block and with the
grids kernel 7 takes at 16 × 6,912 (four neurons a thread, and one): the
card's fixed cost of one kernel.  Each side case prints its fraction of the
bound (bound / device time).  ``--side`` times the side kernels and the
empty kernel alone.

Last it ranks the kernels as rule 2 of the port reads them: launches ×
(device − bound), summed over the shapes, with each kernel's launches per
shape in one run of ``chip_smoke.py`` (``LAUNCHES``: serving's 4 batches ×
16 steps for itp and for mstdp; the fc and conv layers once per step of the
training runs; the matrix phase's cells, at the audit's tiny shapes, are
left out).

``--host`` times the host instead: each wrapper's host µs per call (least
of 9 windows of 1,000 calls, no sync), kernels 1, 2 and 5 (each window) at
serving's 8 × 784 × 100, kernels 3, 4 and 6 (each window) at DCSNN conv1
and the side wrappers at 16 × 6,912 elements; then, in the same process,
the serving load of ``chip_smoke.py`` (784 × 100, ``itp``/``fused``, 8
sessions, 32 requests, after a warm-up) in requests/s and
``launch.train --engine`` at its defaults (``itp``/``fused``) in SOP/s,
three runs each; and one trivial function's host µs per call, plain, as a
``torch.library.Library`` operator and as a ``torch.library.custom_op``.

``--src DIR`` imports ``repro_torch`` from another checkout's ``src`` (an
unpacked parent commit, say), so two versions of the kernels are compared
in one process on one card.  Run from the repository root:

    python3 tools/time_kernels.py [--src DIR] [--label NAME] [--side | --host]

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
# the fc layers' batch-summed delta on kernels 3 and 4 (M = the batch):
# chip_smoke.py's batch-16 layers and the benchmark's
FC_CASES = {**{k: v for k, v in S.COUNTER_FC_CASES.items() if k.endswith(" fc")},
            **S.FC_CASES}
# launches per shape in one run of chip_smoke.py: serving 4 batches x 16
# steps (itp packed and unpacked, exact, mstdp); the DCSNN 3 batches x 30
# steps (itp packed and unpacked, exact) or 1 batch (imstdp, mstdp, itp on
# sparse); the CSNN 1 batch (itp packed and unpacked, linear); the 2layer-snn
# protocol 6 epochs x 8 batches x 30 steps (itp, exact, mstdp).  mstdp runs
# kernels 2 and 4; the history rules' and mstdp's fc layers kernels 3 and 4,
# the counter rules' the fc delta;
# the sparse DCSNN kernel 4 on its gathered (uncapped: all M) rows and no fc
# kernel
_DCSNN, _CSNN, _CONV = {"DCSNN fc": 90}, {"CSNN fc": 30}, {
    "DCSNN conv1": 90, "DCSNN conv2": 90, "CSNN conv1": 30, "CSNN conv2": 30}
LAUNCHES = {
    "itp_stdp_update_packed": {"serving": 64},
    "itp_stdp_update": {"serving": 128},
    "counter_stdp_update[exact]": {"serving": 64},
    "counter_fc_delta[exact]": {"2layer-snn fc": 1440, **_DCSNN},
    "counter_fc_delta[linear]": dict(_CSNN),
    "counter_fc_delta[imstdp]": {"DCSNN fc": 30},
    "itp_stdp_conv_delta_packed": {**_CONV, "2layer-snn fc": 1440, **_DCSNN, **_CSNN},
    "itp_stdp_conv_delta": {**_CONV, "DCSNN conv1": 150, "DCSNN conv2": 150,
                            "2layer-snn fc": 1440, "DCSNN fc": 120, **_CSNN},
    "counter_conv_delta[exact]": {"DCSNN conv1": 90, "DCSNN conv2": 90},
    "counter_conv_delta[linear]": {"CSNN conv1": 30, "CSNN conv2": 30},
    "counter_conv_delta[imstdp]": {"DCSNN conv1": 30, "DCSNN conv2": 30},
    "lif_update": {"16x6912": 30},
    # the neuron datapath launches the scalar-b variant where the version
    # has one, else the element-pair kernel
    "llsmu_multiply[scalar b]": {"16x6912": 30},
    "llsmu_multiply": {"16x6912": 30},
    "po2_encode": {"embedding": 3},
    "po2_decode": {"embedding": 3},
}
SIDE_LARGE = 1 << 24                    # elements: bytes, not the launch, set the time
# qwen3-0.6b's tied embedding (vocab × d_model, repro_torch.configs), where
# chip_smoke.py times kernels 9-10; a literal, since --src may name a
# checkout whose port has no configs
EMBEDDING = (151_936, 1_024)
HOST_RUNS = 3                           # runs of the serving and engine rates
# a kernel with an empty body: its device time is the card's fixed cost of
# one kernel at a given grid
NOOP_SOURCE = r"""
#include <cuda_runtime.h>
__global__ void noop_kernel() {}
extern "C" int noop_launch(int blocks, int threads, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  noop_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
"""


def _noop_library():
    """Build ``NOOP_SOURCE`` with the port's nvcc flags (once) and load it."""
    import ctypes
    import hashlib

    from repro_torch.kernels import _build

    h = hashlib.sha256((NOOP_SOURCE + " ".join(_build.NVCC_FLAGS)).encode()).hexdigest()[:16]
    lib = _build.BUILD_DIR / f"libnoop_{h}.so"
    if not lib.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src = lib.with_suffix(".cu")
        src.write_text(NOOP_SOURCE)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                       check=True, capture_output=True, text=True, timeout=300)
    fn = ctypes.CDLL(str(lib)).noop_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _side_cases(device):
    """Kernels 7-10 at the smoke's shapes and at SIDE_LARGE elements: name →
    [(case, shape text, kernel call, elements)], each kernel's outputs first
    held bit for bit against its plain version's; a version whose kernel 8
    refuses one ``b`` has no scalar-b cases."""
    import torch

    from repro_torch.core.lif import LIFParams
    from repro_torch.kernels.lif import kernel as LK
    from repro_torch.kernels.lif.ref import lif_update_ref
    from repro_torch.kernels.llsmu import kernel as MK
    from repro_torch.kernels.llsmu.ref import llsmu_multiply_ref
    from repro_torch.kernels.po2_quant import kernel as PK
    from repro_torch.kernels.po2_quant import ref as PR

    p = LIFParams()
    kw = dict(alpha=p.alpha, e_rest=p.e_rest, v_th=p.v_th)
    gen = torch.Generator(device=device).manual_seed(7)
    pop = S.LIF_POPULATION[0] * S.LIF_POPULATION[1]
    emb = EMBEDDING
    cases = {}
    for case, n, po2_shape in (("smoke", pop, emb), ("2^24", SIDE_LARGE, (SIDE_LARGE,))):
        v = torch.rand((n,), generator=gen, device=device) * 1.7 - 0.5
        i_in = torch.rand((n,), generator=gen, device=device) * 0.8
        a = torch.randint(0, 1 << 12, (n,), generator=gen, device=device, dtype=torch.int32)
        b = torch.full_like(a, round(p.alpha * (1 << S.LIF_FRAC_BITS)))
        one = b[:1].clone()
        x = torch.randn(po2_shape, generator=gen, device=device) * 0.02
        codes = PK.po2_encode(x)
        what = "16x6912" if case == "smoke" else "2^24"
        po2_what = "embedding" if case == "smoke" else "2^24"
        scalar_b = []
        if _takes_one_b(MK.llsmu_multiply, a, one):
            scalar_b.append(("llsmu_multiply[scalar b]",
                             lambda a=a, o=one: (MK.llsmu_multiply(a, o),),
                             lambda a=a, b=b: (llsmu_multiply_ref(a, b),), n, what))
        for name, kern, plain, count, shape in (
                ("lif_update", lambda v=v, i=i_in: LK.lif_update(v, i, **kw),
                 lambda v=v, i=i_in: lif_update_ref(v, i, **kw), n, what),
                ("llsmu_multiply", lambda a=a, b=b: (MK.llsmu_multiply(a, b),),
                 lambda a=a, b=b: (llsmu_multiply_ref(a, b),), n, what),
                *scalar_b,
                ("po2_encode", lambda x=x: (PK.po2_encode(x),),
                 lambda x=x: (PR.po2_encode_ref(x),), x.numel(), po2_what),
                ("po2_decode", lambda c=codes: (PK.po2_decode(c),),
                 lambda c=codes: (PR.po2_decode_ref(c),), codes.numel(), po2_what)):
            outs, refs = kern(), plain()
            torch.cuda.synchronize()
            if not all(torch.equal(o, r) for o, r in zip(outs, refs)):
                raise SystemExit(f"{name} at {shape}: kernel != plain version")
            cases.setdefault(name, []).append((case, shape, kern, count))
    return cases


def _takes_one_b(llsmu_multiply, a, one) -> bool:
    """Whether this version's kernel 8 wrapper takes one ``b`` for every
    element (the scalar-b variant); a version without it refuses the shape."""
    try:
        llsmu_multiply(a, one)
    except ValueError:
        return False
    return True


def _host_cases(device):
    """Each side wrapper at 16 × 6,912 elements, and two steps each takes:
    name → call."""
    import torch

    from repro_torch.kernels.lif import kernel as LK
    from repro_torch.kernels.llsmu import kernel as MK
    from repro_torch.kernels.po2_quant import kernel as PK

    n = S.LIF_POPULATION[0] * S.LIF_POPULATION[1]
    gen = torch.Generator(device=device).manual_seed(8)
    v = torch.rand((n,), generator=gen, device=device)
    a = torch.randint(0, 1 << 12, (n,), generator=gen, device=device, dtype=torch.int32)
    one = a[:1].clone()
    b = one.expand(n).contiguous()
    codes = PK.po2_encode(v)
    calls = {"lif_update": lambda: LK.lif_update(v, v, alpha=0.9),
             "llsmu_multiply": lambda: MK.llsmu_multiply(a, b),
             "po2_encode": lambda: PK.po2_encode(v),
             "po2_decode": lambda: PK.po2_decode(codes),
             "torch.empty_like": lambda: torch.empty_like(v),
             "torch.cuda.current_stream": lambda: torch.cuda.current_stream(device).cuda_stream}
    if _takes_one_b(MK.llsmu_multiply, a, one):
        calls["llsmu_multiply[scalar b]"] = lambda: MK.llsmu_multiply(a, one)
    return calls


def _update_host_cases(device):
    """Kernels 1-6 and the counter fc delta at their main shapes (1, 2, 5 at
    serving's 8 × 784 × 100; 3, 4, 6 at DCSNN conv1; the fc delta at the
    2layer-snn fc's 16 × 784 × 100, where the version has it): name → call."""
    import torch

    from repro_torch.core.history import pack_bitplanes
    from repro_torch.core.stdp import STDPParams
    from repro_torch.kernels.itp_counter import kernel as NK
    from repro_torch.kernels.itp_counter.ops import counter_lut
    from repro_torch.kernels.itp_stdp import kernel as K
    from repro_torch.kernels.itp_stdp.ops import po2_vectors
    from repro_torch.kernels.itp_stdp_conv import kernel as CK

    p = STDPParams()
    po2 = po2_vectors(p, DEPTH, device=device)
    lut = counter_lut(p, DEPTH, device)
    lanes, n_pre, n_post = SHAPES["serving"]
    gen = torch.Generator().manual_seed(9)
    w, pre_s, post_s, pre_wd, post_wd, pre_b, post_b = S._inputs(
        lanes, n_pre, n_post, DEPTH, gen, device)
    pre_t, post_t = (torch.randint(0, DEPTH + 1, (lanes, n), generator=gen)
                     .to(torch.uint8).to(device) for n in (n_pre, n_post))
    m, k, c = S.CONV_CASES["DCSNN conv1"]
    patches = (torch.rand((m, k), generator=gen) < 0.3).float().to(device)
    out = (torch.rand((m, c), generator=gen) < 0.25).float().to(device)
    planes_pre = (torch.rand((DEPTH, m, k), generator=gen) < 0.3).float().to(device)
    planes_post = (torch.rand((DEPTH, m, c), generator=gen) < 0.25).float().to(device)
    words_pre, words_post = pack_bitplanes(planes_pre), pack_bitplanes(planes_post)
    conv_t = [torch.randint(0, DEPTH + 1, shape, generator=gen).to(torch.uint8).to(device)
              for shape in ((m, k), (m, c))]
    b, f_pre, f_post = SHAPES["2layer-snn fc"]
    fc_args = [(torch.rand((b, n), generator=gen) < 0.2).float().to(device)
               for n in (f_pre, f_post)]
    fc_args += [torch.randint(0, DEPTH + 1, (b, n), generator=gen).to(torch.uint8).to(device)
                for n in (f_pre, f_post)]
    kw = dict(nearest=True, eta=1.0 / 16.0, w_min=0.0, w_max=1.0)
    calls = {
        "itp_stdp_update_packed": lambda: K.itp_stdp_update_packed(
            w, pre_s, post_s, pre_wd, post_wd, *po2, depth=DEPTH, **kw),
        "itp_stdp_update": lambda: K.itp_stdp_update(w, pre_s, post_s, pre_b, post_b, *po2,
                                                     **kw),
        "itp_stdp_conv_delta_packed": lambda: CK.itp_stdp_conv_delta_packed(
            patches, out, words_pre, words_post, *po2, depth=DEPTH),
        "itp_stdp_conv_delta": lambda: CK.itp_stdp_conv_delta(
            patches, out, planes_pre, planes_post, *po2),
    }
    for window in S.COUNTER_WINDOWS:
        wkw = dict(depth=DEPTH, window=window, a_plus=p.a_plus, a_minus=p.a_minus,
                   tau_plus=p.tau_plus, tau_minus=p.tau_minus)
        calls[f"counter_stdp_update[{window}]"] = (
            lambda wkw=wkw: NK.counter_stdp_update(w, pre_s, post_s, pre_t, post_t, lut,
                                                   eta=1.0 / 16.0, w_min=0.0, w_max=1.0,
                                                   **wkw))
        calls[f"counter_conv_delta[{window}]"] = (
            lambda wkw=wkw: NK.counter_conv_delta(patches, out, *conv_t, lut, **wkw))
        if hasattr(NK, "counter_fc_delta"):
            calls[f"counter_fc_delta[{window}]"] = (
                lambda wkw=wkw: NK.counter_fc_delta(*fc_args, lut, **wkw))
    return calls


def _probe(x):
    import torch

    return torch.empty_like(x)


def _registration_costs(device) -> dict:
    """Host µs per call of one trivial function (``torch.empty_like`` of a
    16-element tensor) called plainly, as an operator defined through
    ``torch.library.Library`` (``define`` + ``impl``, the port's way) and as
    a ``torch.library.custom_op``."""
    import torch

    x = torch.zeros(16, device=device)
    lib = torch.library.Library("time_kernels_probe", "FRAGMENT")
    lib.define("by_library(Tensor x) -> Tensor")
    lib.impl("by_library", _probe, "CUDA")
    custom = torch.library.custom_op("time_kernels_probe::by_custom_op", _probe,
                                     mutates_args=(), device_types="cuda",
                                     schema="(Tensor x) -> Tensor")
    calls = {"plain function": lambda: _probe(x),
             "Library.impl op": lambda: torch.ops.time_kernels_probe.by_library(x),
             "custom_op": lambda: custom(x)}
    return {name: S._host_us(call) for name, call in calls.items()}


def _host_rates(device) -> dict:
    """The serving load's requests/s and ``launch.train --engine``'s SOP/s
    (``itp``/``fused``), HOST_RUNS runs each after a warm-up."""
    import torch

    from repro_torch.core.engine import EngineConfig
    from repro_torch.launch.serve import synthetic_load
    from repro_torch.launch.train import build_parser, engine_training
    from repro_torch.serve import ServeConfig

    scfg = ServeConfig(**S.SERVE_SCFG)
    cfg = EngineConfig(**S.SERVE_CFG, backend="fused", packed_history=True)
    load = synthetic_load(torch.Generator().manual_seed(1), t_steps=scfg.t_steps,
                          n_pre=cfg.n_pre, **S.SERVE_LOAD)
    S._serve(cfg, scfg, load[:scfg.max_batch], device, threaded=False)
    serve = [len(load) / S._serve(cfg, scfg, load, device, threaded=True)[2]
             for _ in range(HOST_RUNS)]
    args = build_parser().parse_args(["--engine", "--rule", "itp", "--backend", "fused",
                                      "--device", str(device)])
    engine = [engine_training(args)[0]["sops_per_s"] for _ in range(HOST_RUNS)]
    return {"serve_requests_per_s": serve, "engine_sops_per_s": engine}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch is timed")
    ap.add_argument("--label", default="", help="a name printed with every line")
    ap.add_argument("--side", action="store_true",
                    help="time the side kernels (7-10) and the empty kernel alone")
    ap.add_argument("--host", action="store_true",
                    help="time each wrapper's host us per call and the serving and "
                         "--engine rates alone")
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
    if args.host:
        return _host_main(device, label, smi)
    p = STDPParams()
    po2 = po2_vectors(p, DEPTH, device=device)
    lut = counter_lut(p, DEPTH, device)
    results = []
    for case, (lanes, n_pre, n_post) in ({} if args.side else SHAPES).items():
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

    for case, (m, k, c) in ({} if args.side else {**S.CONV_CASES, **FC_CASES}).items():
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
        for window in S.COUNTER_WINDOWS if case in S.CONV_CASES else ():
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
    for case, (lanes, n_pre, n_post) in ({} if args.side else S.COUNTER_SUM_CASES).items():
        gen = torch.Generator().manual_seed(lanes + n_pre + n_post)
        pre_s, post_s = ((torch.rand((lanes, n), generator=gen) < 0.2).float().to(device)
                         for n in (n_pre, n_post))
        pre_t, post_t = (torch.randint(0, DEPTH + 1, (lanes, n), generator=gen)
                         .to(torch.uint8).to(device) for n in (n_pre, n_post))
        args_fc = (pre_s, post_s, pre_t, post_t, lut)
        for window in S.COUNTER_WINDOWS:
            ckw = dict(depth=DEPTH, window=window, a_plus=p.a_plus, a_minus=p.a_minus,
                       tau_plus=p.tau_plus, tau_minus=p.tau_minus)
            bound_ms, bound_by = S._conv_bound(lanes, n_pre, n_post, DEPTH, True, window)

            def lanes_path(ckw=ckw):
                zero = torch.zeros((lanes, n_pre, n_post), device=device)
                dw = NK.counter_stdp_update(zero, *args_fc, eta=1.0, w_min=-float("inf"),
                                            w_max=float("inf"), **ckw)
                return dw.sum(dim=0, dtype=torch.float64).to(torch.float32)

            timed = [(f"counter_fc_lanes[{window}]", lanes_path, None)]
            if hasattr(NK, "counter_fc_delta"):
                kern = (lambda ckw=ckw: NK.counter_fc_delta(*args_fc, **ckw))
                out, ref = kern(), NR.counter_fc_delta_ref(*args_fc[:4], lut=lut, **ckw)
                torch.cuda.synchronize()
                if not torch.allclose(out, ref, **S.CONV_TOL):
                    raise SystemExit(f"counter_fc_delta[{window}] at {case}: kernel != "
                                     f"plain version")
                timed.append((f"counter_fc_delta[{window}]", kern, "counter_fc_delta_kernel"))
            for name, kern, kernel_name in timed:
                ms = S._time_ms(kern, reps=10, inner=5)
                device_ms = None if kernel_name is None else S._device_ms(kern, kernel_name)
                dev = "not measured" if device_ms is None else f"{device_ms:.5f}"
                print(f"[{label}] {name} {case} {lanes}x{n_pre}x{n_post} depth={DEPTH}: "
                      f"device {dev} ms, events {ms:.5f} ms, bound {bound_ms:.5f} ms "
                      f"({bound_by})", flush=True)
                results.append(dict(name=name, case=case, shape=[lanes, n_pre, n_post],
                                    device_ms=device_ms, ms=ms, bound_ms=bound_ms))
    for name, cases in _side_cases(device).items():
        for case, shape, kern, count in cases:
            bound_ms, bound_by = S._side_bound(name, count)
            ms = S._time_ms(kern)
            device_ms = S._device_ms(kern, name.split("[")[0] + "_kernel")
            frac = "not measured" if device_ms is None else f"{bound_ms / device_ms:.3f}"
            dev = "not measured" if device_ms is None else f"{device_ms:.5f}"
            print(f"[{label}] {name} {case} {shape} ({count} elements): device {dev} ms, "
                  f"events {ms:.5f} ms, bound {bound_ms:.5f} ms ({bound_by}), fraction of "
                  f"the bound {frac}", flush=True)
            results.append(dict(name=name, case=shape, shape=[count], device_ms=device_ms,
                                ms=ms, bound_ms=bound_ms))
    pop = S.LIF_POPULATION[0] * S.LIF_POPULATION[1]
    for case, n in (("16x6912", pop), ("2^24", SIDE_LARGE)):
        x, y = torch.rand((2, n), device=device)
        z = torch.empty_like(x)
        for name, call, nbytes in (
                ("torch.add", lambda x=x, y=y, z=z: torch.add(x, y, out=z), 12),
                ("torch.neg", lambda x=x, z=z: torch.neg(x, out=z), 8)):
            bound_ms = nbytes * n / S.HBM_BYTES_PER_S * 1e3
            device_ms = S._device_ms(call, "elementwise_kernel")
            frac = "not measured" if device_ms is None else f"{bound_ms / device_ms:.3f}"
            dev = "not measured" if device_ms is None else f"{device_ms:.5f}"
            print(f"[{label}] yardstick {name} {case} ({n} elements, {nbytes} bytes each): "
                  f"device {dev} ms, bound {bound_ms:.5f} ms (bytes), fraction of the bound "
                  f"{frac}", flush=True)
            results.append(dict(name=name, case=case, shape=[n], device_ms=device_ms,
                                ms=None, bound_ms=bound_ms))
    for name, call in _host_cases(device).items():
        us = S._host_us(call)
        print(f"[{label}] host {name} at {S.LIF_POPULATION[0]}x{S.LIF_POPULATION[1]}: "
              f"{us:.3f} us per call (least of 9 windows of 1,000 calls, no sync)",
              flush=True)
        results.append(dict(name=f"host {name}", case="16x6912", shape=[], device_ms=None,
                            ms=None, bound_ms=None, host_us=us))
    noop = _noop_library()
    stream = torch.cuda.current_stream(device).cuda_stream
    for blocks in (1, (pop // 4 + 255) // 256, (pop + 255) // 256):
        call = lambda blocks=blocks: noop(blocks, 256, device.index or 0, stream)  # noqa: E731
        if call() != 0:
            raise SystemExit("noop kernel: launch failed")
        ms = S._time_ms(call)
        device_ms = S._device_ms(call, "noop_kernel")
        dev = "not measured" if device_ms is None else f"{device_ms:.5f}"
        print(f"[{label}] noop_kernel {blocks} block(s) of 256 threads: device {dev} ms, "
              f"events {ms:.5f} ms", flush=True)
        results.append(dict(name="noop_kernel", case=f"{blocks} blocks", shape=[blocks],
                            device_ms=device_ms, ms=ms, bound_ms=0.0))
    ranking = {}
    for c in results:
        n = LAUNCHES.get(c["name"], {}).get(c["case"], 0)
        if n and c["device_ms"] is not None:
            ranking.setdefault(c["name"], 0.0)
            ranking[c["name"]] += n * (c["device_ms"] - c["bound_ms"])
    if "llsmu_multiply[scalar b]" in ranking:   # the path's variant of kernel 8
        ranking.pop("llsmu_multiply", None)
    for name, lost in sorted(ranking.items(), key=lambda kv: -kv[1]):
        print(f"[{label}] rank: {name}: {sum(LAUNCHES[name].values())} launches, "
              f"launches x (device - bound) = {lost:.3f} ms per chip_smoke run", flush=True)
    print(json.dumps({"label": label, "card": smi, "cases": results, "ranking": ranking}))
    return 0


def _host_main(device, label: str, smi: str) -> int:
    """``--host``: each wrapper's host µs per call, then the serving and
    engine rates, in one process."""
    results = {}
    for name, call in {**_update_host_cases(device), **_host_cases(device)}.items():
        us = S._host_us(call)
        results[name] = us
        print(f"[{label}] host {name}: {us:.3f} us per call (least of 9 windows of 1,000 "
              f"calls, no sync)", flush=True)
    registration = _registration_costs(device)
    for name, us in registration.items():
        print(f"[{label}] registration probe, {name}: {us:.3f} us per call", flush=True)
    rates = _host_rates(device)
    print(f"[{label}] serving 784x100 itp/fused: requests/s "
          f"{', '.join(f'{r:.2f}' for r in rates['serve_requests_per_s'])}; --engine "
          f"itp/fused SOP/s {', '.join(f'{r:.4e}' for r in rates['engine_sops_per_s'])}",
          flush=True)
    print(json.dumps({"label": label, "card": smi, "host_us": results,
                      "registration_us": registration, **rates}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
