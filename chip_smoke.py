#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  Phases, each
printed on lines of its own:

1. env     — torch/CUDA versions, the card's name and power limit;
2. build   — every CUDA source under ``src/repro_torch/csrc/`` compiled
             into ``build/torch_kernels/`` (seconds, nvcc's ptxas report);
3. kernels — each fused ITP-STDP kernel against its plain PyTorch version
             on the card: bit-equal (``torch.equal``) at the serving shape
             8×784×100 (depth 1, 7, 8), the fc layers' batch-16 shapes
             (16×784×100, 16×600×128, 16×480×64), a ragged 200×72, both
             pairings, and packed ≡ unpacked; at serving's and each fc
             shape, median times from CUDA events and the profiler beside
             the byte bound and the plain version's time;
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
             nets at batch 16 (DCSNN conv1/conv2, CSNN conv1/conv2) and at
             the SNN fc layers' batch sums (``FC_CASES``: 16×784×100,
             16×600×128, 16×480×64, 256×784×6,400, 2,048×600×128), depth 7, both
             pairings: within atol=1e-4, rtol=1e-5, and bit-equal, since
             both sum exactly in float64; packed ≡ unpacked and two runs
             bitwise; every launch at 256×784×6,400 stores directly and none
             at 2,048×600×128 (``.direct_launches``); times from CUDA events
             and the profiler beside the bound and the plain version's time,
             every shape's in the kernels line's ``layers``;
6. counter_kernels — the counter-rule kernels (update, conv delta and
             fc delta) against their plain versions on the card, for each
             window (exact, linear, imstdp): the update at serving's 8×784×100
             and the fc layers' batch-16 shapes (784×100, 600×128, 480×64),
             the conv delta at the four conv shapes, the fc delta (the fc
             layers' batch sum, no per-lane array) at ``COUNTER_FC_CASES`` and
             at the benchmark's 256×784×6,400, depth 7 plus one depth-255 case
             each; linear and imstdp updates bit-equal, exact within
             rtol=atol=1e-6, conv deltas within atol=1e-4, rtol=1e-5, fc
             deltas bit-equal at depth 7 (exact sums) and within the conv
             tolerance at 255; two runs bitwise; every case timed (CUDA
             events, the profiler, the bound, the plain version), and kernels
             1 and 3 beside kernel 5 at serving's shape, kernel 6 at DCSNN
             conv1 and the fc delta at 256×784×6,400 (the ITP-vs-counter
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
             (kernels 7-8 at 16 × 6,912, kernel 8 with one b, the variant
             the datapath launches, and on b broadcast in memory; kernels
             9-10 at the embedding leaf, 151,936 × 1,024), timed beside the
             byte bound, and each wrapper's host µs per call at 16 × 6,912
             elements;
8. train   — the slice's main path, ``train_to_accuracy``: the 6layer-dcsnn
             at full width (28×28×1, conv 12@5×5, conv 24@3×3, fc 128; batch
             16, t_steps 30) on ``backend="fused"`` for 3 batches plus one
             evaluation, with conv-kernel launches = 3 × t_steps × batches
             (the two conv layers and the fc layer's batch sum, which is the
             same contraction with the batch as its rows); the same batches with
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
9. matrix  — every cell of BENCH_static.json with backend ``fused`` or
             ``sparse`` (9 rule × backend pairs × engine, fc, conv2d,
             conv1d: 36 cells) at the reference audit's shapes for 8 steps,
             against the same cell on ``reference`` on the card: spikes and
             timing words exact, weights within rtol=1e-5, atol=1e-6 (conv
             layers rtol=atol=1e-5); one line per cell with its max error and
             its launches (the sparse cells run uncapped here);
10. audit   — the port's graph audit (``repro_torch.analysis.graph_audit``)
             with CUDA state: all 84 cells of BENCH_static.json traced on
             fake CUDA tensors (``make_fx``), 0 violations, no stale float64
             allowlist entry, each fused cell's one kernel operator
             (``torch.ops.repro_torch.*``) as the path predicts; then the 36
             fused and sparse cells' traced graphs run on the card for 8
             steps beside the eager step, each step bit-equal, launches equal;
11. sparse_mstdp — the sparse backend and mstdp at full width: the sparse
             ``itp`` engine at 784×100, depth 7, 64 steps at input rate 0.02
             (weights on [0, 0.04), so the posts fire at ~10 %) bit-equal to
             ``fused`` at every step, a run capped at 8 events twice
             (bit-equal), and the middle step's update timed alone (the
             sparse update's device time over all its kernels beside kernel
             1's and the fused update's) with the observed densities; the
             slice's serving load with ``rule="mstdp"`` on ``fused`` (kernel
             2 on depth-1 magnitude planes, 2 B/neuron: 1,768 B a session)
             and with ``itp`` on ``sparse`` at input rate 0.02, each held
             against ``reference`` and solo ≡ interleaved; the 2layer-snn
             protocol with ``mstdp`` (final ≥ 0.25); one 6layer-dcsnn batch on
             ``mstdp``/``fused`` (kernel 4 on magnitude planes) and on
             ``itp``/``sparse`` (kernel 4 on the gathered rows), each held
             against ``reference``;
12. persist — session checkpointing and the restart runner: the slice's
             serving load with ``itp``, ``exact`` and ``mstdp`` on ``fused``,
             16 requests, a checkpoint, a restore into a new ``Server``, the
             other 16: states and post rasters bit-equal to an uninterrupted
             server, LRU order kept, the save and restore wall ms and the
             bytes on disk per session, and a leaf corrupted on purpose
             refused; then ``TrainingRunner`` over the engine population
             (8 × 256 × 256, ``itp``/``fused``, 100 steps, a checkpoint every
             25, a failure injected at step 60): bit-equal to the
             uninterrupted run, 110 kernel-1 launches (steps 50-59 replayed);
13. engine  — ``launch.train --engine`` at its defaults (8 replicas × 256 ×
             256 × 100 steps at input rate 0.3; the launcher's parser and
             ``engine_training``) with ``itp``/``fused``, ``exact``/``fused``
             and ``itp``/``sparse``: SOP/s, the warm-up seconds, launches = 2 ×
             steps on fused (warm-up and timed run), each against the same run
             on ``reference`` on the card (``itp``/``fused`` bitwise, the
             others spikes exact and w within rtol=1e-5, atol=1e-6);
14. sharded — the weight-sharded engine on a 1 × 1 NCCL grid in this
             process (``tcp://127.0.0.1`` on a free port; the group destroyed
             at the end): 784 × 100 over 64 steps at the sparse engine's
             inputs for ``itp``, ``exact`` and ``linear`` on ``fused`` and
             ``itp`` on ``sparse``, each == the unsharded ``run_engine``
             (spikes, w and v bitwise), one kernel launch a step on fused, the
             sharded step's wall ms beside the unsharded one's;
15. lm      — the LM stack's forward and decode (ROADMAP item 18b; no
             kernel of its own: its products are torch matmuls, as the
             reference's are XLA dots outside any Pallas kernel): the eleven
             smoke configs at float32, ``forward`` (logits, aux losses) and 8
             ``decode_step``s (logits, caches; granite-4.0-h-micro has no
             decode) on the card against the port on the CPU within the LM
             float32 clause (rtol=1e-4, atol=1e-5; the SSM and interleaved
             families rtol=atol=2e-3), the MoE configs bit-equal on two CUDA
             runs; qwen3-0.6b at full width and depth (596,049,920 float32
             parameters from the port's seeded ``init_model``): float32
             teacher-forced decode ≡ ``forward`` at B=2, S=64 within 1e-3 of
             the largest logit, its 2-layer cut on the card ≡ the CPU at B=2,
             S=128, bfloat16 prefill at B=4 × S=4,096 (``last_logits_only``,
             the blockwise path's four query blocks), 32 bfloat16 decode steps
             at B=8 on a 4,096-slot bfloat16 cache and on an int8 one (relative
             RMSE < 0.05), tokens/s, peak memory, the weight casts' cost and
             one profiled decode step's device-busy share; mamba2-1.3b at full
             width and depth (1,343,740,928): bfloat16 prefill at B=2 ×
             S=4,096 and 32 decode steps, timed, and float32 teacher-forced
             decode ≡ ``forward`` at B=1, S=256 within rtol=atol=2e-3; one
             qwen2-moe-a2.7b MoE layer at full width (60 experts padded to 64,
             d 2,048): bfloat16 at B=4 × S=4,096 bit-equal over two runs,
             timed, float32 at B=1 × S=256 on the card ≡ the CPU;
16. lm_train — LM training with ITP-AdamW (ROADMAP item 18c): the eleven
             smoke configs at float32, one AdamW step on the card against the
             port on the CPU within the LM float32 clause (the SSM, hybrid and
             interleaved families within 2e-3) and one ITP-AdamW step twice on
             the card, bit-equal; qwen3-0.6b at full width and depth (596,049,920
             float32 master parameters, bfloat16 compute) trained with
             ITP-AdamW at B=4 × S=2,048 on Zipf tokens with ``remat="full"``:
             one warm-up step, 4 timed steps (ms a step, tokens/s, peak
             memory) and one profiled step (device-busy share, top device
             ops), the po2 kernels' launches set to 0 before and read after
             (one encode and one decode per leaf per step); from the state it
             reached, the step with kernels 9-10 ≡ the step on the plain
             quantiser bitwise; at B=4 × S=512 ``remat`` none / full / dots
             bit-equal, each with its ms and peak memory; the bfloat16
             gradient against the float32 one at B=2 × S=1,024 with PyTorch's
             reduced-precision bf16 reduction on and off; then the launcher's
             LM mode on the card at smoke size with a failure injected: one
             restart, the final state bit-equal to an uninterrupted run;
17. lm_sharded — sharded LM training and the serving plans on a 1 × 1 NCCL
             mesh (ROADMAP items 18d, 19a, 19b): qwen3-0.6b's ITP-AdamW
             step at lm_train's shape tensor-parallel (fsdp) ≡ the
             unsharded step and the gather-on-use (dp) step, bitwise; the
             pod branch ≡ the unsharded step fed the plain po2 round trip;
             mamba2-1.3b's step at full width (48 layers, B=2 × S=1,024,
             remat full) with its SSM mixer split over 'model' ≡ the
             unsharded step, bitwise; ``launch.specs``' prefill and decode
             plans on DTensors for qwen3-0.6b and mamba2-1.3b at full width
             ≡ ``forward(last_logits_only=True)`` and ``decode_step``
             (logits and every cache leaf, bitwise); the launcher's
             ``--data 1 --model 1``; the dry run's flop count of the step;
18. the ``kernels`` JSON line (kernels 1-4, kernels 5-6 and the counter fc
   delta once per window, kernels 7-10; a dense kernel's launches summed over
   serving and phases 12-14, the fc delta's over the fc layers of the counter
   training runs, each's times at the shape where most of them fall; the
   matrix, audit, lm_train and lm_sharded phases' launches added), the
   ``nvidia-smi`` name/power-limit line, and the final ``{"ok": true, ...}``
   line.

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
    (8, 784, 100, 7), (8, 784, 100, 1), (8, 784, 100, 8), (1, 200, 72, 7),
    (16, 784, 100, 7), (16, 600, 128, 7), (16, 480, 64, 7), (8, 256, 256, 7),
    (1, 784, 100, 7)]
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
    **{f"counter_fc_delta[{w}]": "none: the fc layers' batch sum without kernel 5's "
       "per-lane array" for w in COUNTER_WINDOWS},
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
# (M, K, C) of the SNN fc layers' batch-summed delta on kernels 3-4, the
# batch as the M rows: the batch-16 fc layers of the train phase and the
# benchmark's (cells 1 and 2); FC_DIRECT: whether a launch there stores its
# outputs directly (one split, no scratch), where the card alone decides it
FC_CASES = {"2layer-snn fc": (16, 784, 100), "DCSNN fc": (16, 600, 128),
            "CSNN fc": (16, 480, 64), "snn6400 fc b256": (256, 784, 6400),
            "dcsnn fc b2048": (2048, 600, 128)}
FC_DIRECT = {"snn6400 fc b256": True, "dcsnn fc b2048": False}
# a training run's learnable layers, each launching once a step (the sparse
# runs' conv layers alone, kernel 4 on gathered rows; no fc kernel)
NET_LAYERS = {"6layer-dcsnn": ("DCSNN conv1", "DCSNN conv2", "DCSNN fc"),
              "5layer-csnn": ("CSNN conv1", "CSNN conv2", "CSNN fc"),
              "2layer-snn": ("2layer-snn fc",)}
# (lanes, n_pre, n_post) of the dense updates: serving's 8 sessions, the paper
# nets' fc layers at batch 16 (the batch is the lane axis), the engine
# launcher's population and the sharded engine's 1 x 1 tile
COUNTER_FC_CASES = {"serving": (8, 784, 100), "2layer-snn fc": (16, 784, 100),
                    "DCSNN fc": (16, 600, 128), "CSNN fc": (16, 480, 64),
                    "engine": (8, 256, 256), "sharded": (1, 784, 100)}
# the counter fc delta (the batch as lanes, summed in the kernel): those
# shapes and the benchmark's snn6400-train-exact-b256 layer
COUNTER_SUM_CASES = {**COUNTER_FC_CASES, "snn6400 fc b256": (256, 784, 6400)}
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
# the matrix phase: BENCH_static.json's fused and sparse cells at the shapes of
# the reference's audit (src/repro/analysis/jaxpr_audit.py), a few steps each
MATRIX_BACKENDS = ("fused", "sparse")
MATRIX_STEPS = 8
MATRIX_SHAPES = {"fc": ((16,), dict(kind="fc", out_features=8)),
                 "conv2d": ((8, 8, 1), dict(kind="conv2d", out_features=4, kernel=3)),
                 "conv1d": ((16, 2), dict(kind="conv1d", out_features=4, kernel=3, stride=2))}
MATRIX_TOL = dict(rtol=1e-5, atol=1e-6)  # the parity contract (conv layers: TRAIN_TOL)
# the sparse_mstdp phase: the 2layer-snn fc width as one engine at a
# realistic input density, and the slice loads with mstdp and sparse
SPARSE_ENGINE = dict(n_pre=784, n_post=100, depth=7)
SPARSE_STEPS = 64
SPARSE_RATE = 0.02                      # input spike probability per step
SPARSE_W = (0.0, 0.04)                  # init weight range: the posts fire at ~10 %
SPARSE_CAP = 8                          # the capped run's max_events
# the persist, engine and sharded phases: launch.train --engine's defaults (the
# reference's), the restart runner's checkpoint interval and injected failure,
# and the sharded engine's steps at the sparse engine's width and inputs
ENGINE_DEFAULTS = dict(engine_pre=256, engine_post=256, replicas=8, engine_rate=0.3,
                       steps=100)
RUNNER_CKPT_EVERY = 25
RUNNER_FAIL_AT = 60
SHARDED_STEPS = 64
# the side numerics: the DCSNN conv1 population (24×24×12 at batch 16)
LIF_POPULATION = (16, 24 * 24 * 12)
LIF_STEPS = 30
LIF_FRAC_BITS = 8
PAPER_HISTORY_DEPTH = 7
QWEN3 = "qwen3-0.6b"                    # its widths: the port's config (repro_torch.configs)
QWEN3_LAYERS = 2                        # of 28: a cut that bounds chip time
ADAMW_STEPS = 3
# the LM phase: the float32 parity clause (ROADMAP ground rules; the SSM
# family at the reference's own ssd tolerance), the loads at full width
# (batch, sequence) and their expected parameter counts
LM_TOL = dict(rtol=1e-4, atol=1e-5)
LM_SSM_TOL = dict(rtol=2e-3, atol=2e-3)
LM_SMOKE = dict(batch=2, seq=16, steps=8)
LM_PERTURBED = ("scale", "bias", "bq", "bk", "bv", "q_norm", "k_norm", "gate_attn", "conv_b",
                "d_skip", "dt_bias", "norm_scale", "up_bias", "down_bias")
LM_DENSE, LM_SSM, LM_MOE = "qwen3-0.6b", "mamba2-1.3b", "qwen2-moe-a2.7b"
LM_PARAMS = {LM_DENSE: 596_049_920, LM_SSM: 1_343_740_928}
LM_DECODE_CHECK = (2, 64)               # float32 teacher-forced decode ≡ forward
LM_DECODE_REL = 1e-3                    # × the largest |logit|
LM_CUT = (2, 2, 128)                    # layers, batch, seq: the card ≡ the CPU
LM_PREFILL = (4, 4096)                  # the train_4k sequence: four query blocks
LM_DECODE = dict(batch=8, max_t=4096, steps=32)
LM_INT8_RMSE = 0.05                     # test_models.py:249
SSM_PREFILL = (2, 4096)                 # 16 SSD chunks of 256
SSM_DECODE_STEPS = 32
SSM_DECODE_CHECK = (1, 256)
MOE_LOAD = (4, 4096)
MOE_CHECK = (1, 256)
# the lm_train phase (ROADMAP item 18c): the smoke configs' step, qwen3-0.6b
# trained at full width and depth ((batch, sequence) and timed steps after one
# warm-up), the remat comparison's and the bf16-reduction probe's shapes, the
# launcher's LM mode at smoke size; the optimizer is the launcher's at --steps 100
LM_TRAIN_SMOKE = (2, 16)
LM_TRAIN = (4, 2048)
LM_TRAIN_STEPS = 4
LM_REMAT = (4, 512)
LM_REMAT_REPS = 3
LM_BF16_PROBE = (2, 1024)
LM_TRAIN_OPT = dict(lr=3e-4, total_steps=100, warmup_steps=5)
LM_LAUNCH = ["--smoke", "--arch", LM_DENSE, "--steps", "12", "--batch", "4", "--seq", "64",
             "--ckpt-every", "4", "--po2-update", "--log-every", "4"]
LM_LAUNCH_FAIL_AT = 7
# the lm_sharded phase (ROADMAP item 18d): qwen3-0.6b at lm_train's shape on a
# 1 x 1 NCCL mesh under fsdp (steps, then one profiled step) against the
# unsharded step, the pod branch on a 1 x 1 x 1 mesh against the unsharded
# step fed the plain po2 round trip of its gradients, and the launcher's
# --data 1 --model 1 at lm_train's launcher settings against --data 0
LM_SHARDED_STEPS = 3
LM_POD_STEPS = 2
# ROADMAP item 19b on the 1 x 1 mesh: mamba2-1.3b's train step at full width
# (its SSM mixer split over 'model'), and the prefill and decode plans of
# qwen3-0.6b and mamba2-1.3b at full width, each against the unsharded path
SSM_TRAIN = (2, 1024)
SSM_TRAIN_STEPS = 3
PLAN_PREFILL = {LM_DENSE: (2, 2048), LM_SSM: (2, 1024)}
PLAN_DECODE = {LM_DENSE: dict(batch=8, max_t=4096), LM_SSM: dict(batch=2, max_t=4096)}
PLAN_DECODE_STEPS = 4
DRIFT_RMSE = 0.094753                   # paper §IV-A; tests/test_drift.py's band
DRIFT_RMSE_TOL = 5e-4
# bytes per element, inputs read once and outputs written once: kernel 7 reads
# v and I and writes v and the spikes (float32); kernel 8 reads two int32
# operands and writes one, or with one b (its scalar-b variant, the one the
# neuron datapath launches) reads one and writes one; kernels 9-10 read four
# bytes and write four
SIDE_BYTES = {"lif_update": 16, "llsmu_multiply": 12, "llsmu_multiply[scalar b]": 8,
              "po2_encode": 8, "po2_decode": 8}
# operations per element: the LIF step's sub, mul, two adds, compare and
# select; LLSMU's split, three Mitchell multiplies (leading-one counts,
# mantissa shifts, branch, shift back) and recombination; the encoder's field
# and mantissa extraction, compare, clip, bias and sign; the decoder's masks,
# exponent build and select.  The bound divides them by the data sheet's
# float32 rate (FP32_OPS_PER_S), as it does for every kernel, so the rows
# compare across the port; kernels 8-10 issue int32 instructions, which an
# H100 SM runs on 64 lanes a clock, half its float32 lanes, and which count
# one each where the float32 rate counts an FMA as two.  Kernel 8's real
# limit is that integer issue, which PERF.md reckons from its SASS
# (``tools/sass_count.py``); its byte bound is the one these rows keep
SIDE_OPS = {"lif_update": 6, "llsmu_multiply": 120, "llsmu_multiply[scalar b]": 120,
            "po2_encode": 12, "po2_decode": 6}


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


def _host_us(fn, *, n: int = 1000, reps: int = 9) -> float:
    """Host wall time of one call of ``fn`` in µs: the least over ``reps``
    windows of ``n`` calls back to back with no synchronisation between them
    (the wrapper's own launch path, as long as the device keeps up; the
    least, since other work on the host's shared cores only adds time)."""
    import torch

    for _ in range(10):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        times.append((time.perf_counter() - t0) / n * 1e6)
    torch.cuda.synchronize()
    return min(times)


def _device_ms(fn, kernel_name: str, *, n: int = 50, tries: int = 3) -> float | None:
    """Device time per call of ``fn`` (one launch of a kernel whose name
    contains ``kernel_name``), from a profiler trace; None unless a trace
    holds exactly ``n`` such launches in one of ``tries`` attempts (a trace
    that lost events would read low)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
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
        _phase("profile", f"{kernel_name}: the trace holds {count} of {n} launches")
        if count == n:
            return total_us / n / 1e3
    return None


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

        case = next((c for c, shape in COUNTER_FC_CASES.items()
                     if shape == (lanes, n_pre, n_post)), None)
        if case is not None and depth == COUNTER_DEPTH:
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
            what = f"{case} {lanes}x{n_pre}x{n_post} depth={depth}"
            for name, (kern, plain, is_packed) in timed.items():
                bound = _bound(lanes, n_pre, n_post, depth, is_packed)
                t = _timed(name, what, kern, plain, bound, "itp_stdp_kernel", phase="kernels")
                report[name].setdefault("cases", {})[case] = dict(t, shape=what)
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


def _report_profile(prof, seconds: float, what: str) -> float | None:
    """Print the wall time, the device-busy share and the eight device
    kernels that take the most time of one profiled run; return the busy
    share (None if the trace holds no device events).  Only the device's
    own events (kernels, copies, memsets) count: a host op's row, and a
    profiler span's device-side row, repeat the device time of the kernels
    launched inside them."""
    import torch

    rows = []
    for row in prof.key_averages():
        # a span's device-side row covers the kernels launched inside it
        if (row.device_type != torch.autograd.DeviceType.CUDA
                or getattr(row, "is_user_annotation", False)):
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
    return busy_us / 1e6 / seconds if rows else None


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
    wrappers = (CK.itp_stdp_conv_delta_packed, CK.itp_stdp_conv_delta)
    for layer, (m, k, c) in {**CONV_CASES, **FC_CASES}.items():
        pre = (torch.rand((m, k), generator=gen) < 0.3).float().to(device)
        post = (torch.rand((m, c), generator=gen) < 0.25).float().to(device)
        pre_b = (torch.rand((CONV_DEPTH, m, k), generator=gen) < 0.3).float().to(device)
        post_b = (torch.rand((CONV_DEPTH, m, c), generator=gen) < 0.25).float().to(device)
        pre_w, post_w = pack_bitplanes(pre_b), pack_bitplanes(post_b)
        for fn in wrappers:
            fn.direct_launches = 0
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
        # each wrapper made 4 launches: every one or none stores directly
        direct = [fn.direct_launches for fn in wrappers]
        _phase("conv_kernels", f"{layer} ({m}x{k}x{c}): direct-store launches {direct} of 4")
        if layer in FC_DIRECT and direct != [4 * FC_DIRECT[layer]] * 2:
            raise SystemExit(f"{layer}: {direct} direct-store launches of 4, want "
                             f"{4 * FC_DIRECT[layer]}")

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
                device_ms=device_ms, shape=f"{layer} {m}x{k}x{c} depth={CONV_DEPTH}",
                direct=direct[0] > 0)
    return report


def _conv_launches(train: dict, kernels: dict) -> dict:
    """Kernels 3-4's launches in the training runs (the conv layers and the
    fc layers' batch sums; kernel 4 also the unpacked runs'), by layer: a
    run's launches fall evenly on its learnable layers.  Each report takes
    its times at the layer where most of them fall.  Returns the summed
    launches."""
    out = {}
    for name in ("itp_stdp_conv_delta_packed", "itp_stdp_conv_delta"):
        by_shape = {}
        for run, r in train.items():
            n = r["launches"].get(name, 0)
            if name == "itp_stdp_conv_delta":
                n += r.get("unpacked_launches") or 0
            net, _, variant = run.partition(" ")
            layers = NET_LAYERS[net][:-1] if variant == "sparse" else NET_LAYERS[net]
            if n % len(layers):
                raise SystemExit(f"{run}: {n} {name} launches over {len(layers)} layers")
            for layer in layers if n else ():
                by_shape[layer] = by_shape.get(layer, 0) + n // len(layers)
        most = max(by_shape, key=by_shape.get)
        kernels[name].update(kernels[name]["layers"][most], launches_by_shape=by_shape)
        _phase("kernels", f"{name}: launches {by_shape}; timed at {most}")
        out[name] = sum(by_shape.values())
    return out


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
    """Kernels 5-6 and the fc delta against their plain versions for every
    window: kernel 5 at serving's and the fc layers' shapes, kernel 6 at the
    four conv shapes, the fc delta at ``COUNTER_SUM_CASES`` (also against
    kernel 5's lanes summed in float64, the path it replaced: bit-equal),
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
            if depth == COUNTER_DEPTH:
                rep.setdefault("cases", {})[case] = dict(t, shape=what)
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
            _ratio_line("kernel 5 (exact) / kernel 1",
                        report["counter_stdp_update[exact]"]["cases"]["serving"], itp)

    summed = [(case, shape, COUNTER_DEPTH) for case, shape in COUNTER_SUM_CASES.items()]
    summed.append(("2layer-snn fc", COUNTER_FC_CASES["2layer-snn fc"], COUNTER_DEEP))
    for case, (lanes, n_pre, n_post), depth in summed:
        pre_s, post_s = spikes((lanes, n_pre), 0.2), spikes((lanes, n_post), 0.2)
        pre_t, post_t = counters((lanes, n_pre), depth), counters((lanes, n_post), depth)
        lut = counter_lut(p, depth, device)
        what = f"{case} {lanes}x{n_pre}x{n_post} depth={depth}"
        for window in COUNTER_WINDOWS:
            name = f"counter_fc_delta[{window}]"
            kw = dict(depth=depth, window=window, a_plus=p.a_plus, a_minus=p.a_minus,
                      tau_plus=p.tau_plus, tau_minus=p.tau_minus)
            args = (pre_s, post_s, pre_t, post_t, lut)
            out = NK.counter_fc_delta(*args, **kw)
            again = NK.counter_fc_delta(*args, **kw)
            plain = NR.counter_fc_delta_ref(*args[:4], lut=lut, **kw)

            def lanes_path():   # the path it replaced: kernel 5 per lane, summed
                zero = torch.zeros((lanes, n_pre, n_post), device=device)
                dw = NK.counter_stdp_update(zero, *args, **kw, eta=1.0, w_min=-math.inf,
                                            w_max=math.inf)
                return dw.sum(dim=0, dtype=torch.float64).to(torch.float32)

            replaced = lanes_path()
            torch.cuda.synchronize()
            err = (out - plain).abs().max().item()
            bitwise = torch.equal(out, plain)
            close = bitwise or ((window == "exact" or depth == COUNTER_DEEP)
                                and torch.allclose(out, plain, **CONV_TOL))
            same = torch.equal(out, replaced)
            ok = (close and torch.equal(out, again) and bool(torch.isfinite(out).all())
                  and (same or depth == COUNTER_DEEP))
            _phase("counter_kernels", f"{name} {what}: max|err|={err:.3g} (bit-equal "
                   f"{bitwise}), == kernel 5's lanes summed {same}, run-to-run "
                   f"{torch.equal(out, again)} -> {'OK' if ok else 'MISMATCH'}")
            if not ok:
                raise SystemExit(f"counter fc delta mismatch: {name} at {what}")
            rep = report.setdefault(name, {"max_abs_err": 0.0})
            rep["max_abs_err"] = max(rep["max_abs_err"], err)
            if depth != COUNTER_DEPTH:
                continue
            t = _timed(name, what, lambda: NK.counter_fc_delta(*args, **kw),
                       lambda: NR.counter_fc_delta_ref(*args[:4], lut=lut, **kw),
                       _conv_bound(lanes, n_pre, n_post, depth, True, window),
                       "counter_fc_delta_kernel")
            t["replaced_ms"] = _time_ms(lanes_path, reps=10, inner=2)
            _phase("counter_kernels", f"{name} {what}: the per-lane path it replaced (zero "
                   f"fill, kernel 5, float64 cast and sum) {t['replaced_ms']:.5f} ms/call")
            rep.setdefault("cases", {})[case] = dict(t, shape=what)
        if case == "snn6400 fc b256":
            # ITP against the counter datapath at the benchmark's layer: kernel
            # 3 on the same spikes, fed random history words
            words = [torch.randint(0, 256, t.shape, generator=gen, dtype=torch.uint8)
                     .to(device) for t in (pre_t, post_t)]
            po2 = po2_vectors(p, depth, device=device)
            itp = _timed("itp_stdp_conv_delta_packed", f"{what} (beside the fc delta)",
                         lambda: CK.itp_stdp_conv_delta_packed(pre_s, post_s, *words, *po2,
                                                               depth=depth),
                         None, _conv_bound(lanes, n_pre, n_post, depth, True),
                         "conv_delta_")
            _ratio_line("counter fc delta (exact) / kernel 3",
                        report["counter_fc_delta[exact]"]["cases"][case], itp)

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
    """The parameter tree of qwen3-0.6b with ``layers`` stacked blocks, as
    leaf shapes: the port's ``init_model`` on the meta device (no storage,
    no draws), its widths from the port's config (``repro_torch.configs``)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_model
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(get_config(QWEN3), n_layers=layers)
    return tree_map(lambda a: tuple(a.shape), init_model(None, cfg, device="meta"))


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

    from repro_torch.configs import get_config
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
    # the datapath's LLSMU multiply is the scalar-b variant (one alpha for
    # every membrane, nothing broadcast in memory)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        TL.lif_step_llsmu(fx, currents[0], p, frac_bits=LIF_FRAC_BITS)
        torch.cuda.synchronize()
    variants = sorted({e.name for e in prof.events() if "llsmu_multiply_kernel" in e.name})
    _phase("side_numerics", f"lif_step_llsmu launches {variants}")
    if len(variants) != 1 or "llsmu_multiply_kernel<true>" not in variants[0]:
        raise SystemExit(f"lif_step_llsmu: expected the scalar-b kernel, got {variants}")
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
           f"{get_config(QWEN3).n_layers} layers: a cut that bounds chip time; {leaves} leaves, "
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
    # kernel 8 as the neuron datapath launches it (one b, the Q8 alpha, for
    # every element: the scalar-b variant) and on b broadcast in memory (the
    # element-pair variant)
    e_q = round(p.e_rest * (1 << LIF_FRAC_BITS))
    a = torch.abs(fx.v_q - e_q).contiguous()
    alpha_q = torch.tensor([round(p.alpha * (1 << LIF_FRAC_BITS))], dtype=torch.int32,
                           device=device)
    b = alpha_q.expand(a.shape).contiguous()
    report["llsmu_multiply"] = _side_check("llsmu_multiply", f"{what} scalar b",
                                           (MK.llsmu_multiply(a, alpha_q),),
                                           (llsmu_multiply_ref(a, b),))
    pair = _side_check("llsmu_multiply", f"{what} element pairs", (MK.llsmu_multiply(a, b),),
                       (llsmu_multiply_ref(a, b),))
    codes = PK.po2_encode(tok)
    emb = f"embedding {tok.shape[0]}x{tok.shape[1]}"
    report["po2_encode"] = _side_check("po2_encode", emb, (codes,), (PR.po2_encode_ref(tok),))
    report["po2_decode"] = _side_check("po2_decode", emb, (PK.po2_decode(codes),),
                                       (PR.po2_decode_ref(codes),))
    # the host's cost of one wrapper call, each kernel at n_pop elements
    small_x, small_c = tok.reshape(-1)[:n_pop], codes.reshape(-1)[:n_pop]
    host = {"lif_update": lambda: LK.lif_update(v, i_in, **kw),
            "llsmu_multiply": lambda: MK.llsmu_multiply(a, alpha_q),
            "llsmu_multiply[element pairs]": lambda: MK.llsmu_multiply(a, b),
            "po2_encode": lambda: PK.po2_encode(small_x),
            "po2_decode": lambda: PK.po2_decode(small_c)}
    host_us = {name: _host_us(fn) for name, fn in host.items()}
    _phase("side_numerics", f"host µs per wrapper call at {n_pop} elements (least of 9 "
           "windows of 1,000 calls, no sync): "
           + ", ".join(f"{k} {us:.3f}" for k, us in host_us.items()))
    timings = {
        "lif_update": (lambda: LK.lif_update(v, i_in, **kw),
                       lambda: lif_update_ref(v, i_in, **kw), "lif_update", n_pop, what),
        "llsmu_multiply": (lambda: MK.llsmu_multiply(a, alpha_q),
                           lambda: llsmu_multiply_ref(a, b), "llsmu_multiply[scalar b]", n_pop,
                           f"{what} scalar b"),
        "po2_encode": (lambda: PK.po2_encode(tok), lambda: PR.po2_encode_ref(tok),
                       "po2_encode", tok.numel(), emb),
        "po2_decode": (lambda: PK.po2_decode(codes), lambda: PR.po2_decode_ref(codes),
                       "po2_decode", codes.numel(), emb),
    }
    for name, (kern, plain, bound, n, shape) in timings.items():
        report[name].update(_timed(name, shape, kern, plain, _side_bound(bound, n),
                                   f"{name}_kernel", phase="side_numerics"), shape=shape,
                            host_us=host_us[name])
    pair.update(_timed("llsmu_multiply", f"{what} element pairs",
                       lambda: MK.llsmu_multiply(a, b), lambda: llsmu_multiply_ref(a, b),
                       _side_bound("llsmu_multiply", n_pop), "llsmu_multiply_kernel<false",
                       phase="side_numerics"),
                host_us=host_us["llsmu_multiply[element pairs]"])
    report["llsmu_multiply"]["element_pairs"] = pair
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
            "counter_conv_delta": NK.counter_conv_delta,
            "counter_fc_delta": NK.counter_fc_delta}


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


def _net_kernels(cfg) -> tuple[str, str | None]:
    """(conv kernel, fc kernel) a net's training launches: the counter
    kernels for the counter rules (the fc delta's batch sum in the fc layer);
    kernel 4 on gathered rows and no dense kernel on ``sparse``; otherwise
    the conv kernel for both, the fc layer's batch sum as its contraction
    over the batch: kernel 4 on a Rank1Rule's magnitude planes (mstdp),
    kernel 3 on the packed history words."""
    from repro_torch.plasticity import Rank1Rule

    if cfg.rule in COUNTER_WINDOWS:
        return "counter_conv_delta", "counter_fc_delta"
    if cfg.backend == "sparse":
        return "itp_stdp_conv_delta", None
    if isinstance(cfg.learning_rule(), Rank1Rule):
        return "itp_stdp_conv_delta", "itp_stdp_conv_delta"
    return "itp_stdp_conv_delta_packed", "itp_stdp_conv_delta_packed"


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
    conv_kernel, fc_kernel = _net_kernels(cfg)
    want = dict.fromkeys(counters, 0)
    want[conv_kernel] = conv_layers * steps
    if fc_kernel is not None:
        want[fc_kernel] += steps
    st = res["state"]
    levels = (1 << (cfg.w_bits - 1)) - 1
    finite = all(bool(torch.isfinite(w).all()) for w in st.weights)
    on_grid = all(bool(torch.allclose(w * levels, torch.round(w * levels), atol=1e-3))
                  for w in st.weights)
    samples = tcfg.batch * tcfg.batches_per_epoch * tcfg.epochs
    _phase("train", f"{net} rule={cfg.rule} {cfg.backend} (full width, batch {tcfg.batch}, "
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
    has_words = conv_kernel == "itp_stdp_conv_delta_packed"   # packed_history applies
    if has_words:
        for fn in counters.values():
            fn.launches = 0
        st_u, cnt_u = _run_batches(dataclasses.replace(flt, packed_history=False), batches,
                                   tcfg.batch, device)
        # the conv layers and the fc layer's batch sum on bitplanes: kernel 4
        unpacked_launches = counters["itp_stdp_conv_delta"].launches
        kernel2 = counters["itp_stdp_update"].launches
        if unpacked_launches != (conv_layers + 1) * tcfg.t_steps * len(batches) or kernel2:
            raise SystemExit(f"{net}: {unpacked_launches} unpacked conv and {kernel2} "
                             f"kernel-2 launches")
        same_u = (all(torch.equal(a, b) for a, b in zip(cnt_p, cnt_u))
                  and all(torch.equal(a, b) for a, b in zip(st_p.weights, st_u.weights)))
    st_r, cnt_r = _run_batches(dataclasses.replace(flt, backend="reference"), batches,
                               tcfg.batch, device)
    counts_ok = all(torch.equal(a, b) for a, b in zip(cnt_p, cnt_r))
    w_err = max((a - b).abs().max().item() for a, b in zip(st_p.weights, st_r.weights))
    w_ok = all(torch.allclose(a, b, **TRAIN_TOL) for a, b in zip(st_p.weights, st_r.weights))
    bitwise = all(torch.equal(a, b) for a, b in zip(st_p.weights, st_r.weights))
    spikes = sum(float(c.sum()) for c in cnt_p)
    unpacked = ("n/a" if not has_words
                else f"{same_u} ({unpacked_launches} unpacked conv launches)")
    _phase("train", f"{net} rule={cfg.rule} backend={cfg.backend} quantise=False on the "
           f"same {len(batches)} "
           f"batches: packed == unpacked {unpacked}; {cfg.backend} vs "
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
    fc_kernel = _net_kernels(cfg)[1]
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


def _kernel_names(counts: dict, rule: str) -> dict:
    """Launch counts keyed as the ``kernels`` line names them (a counter
    kernel per window)."""
    return {(f"{k}[{rule}]" if k.startswith("counter") else k): n
            for k, n in counts.items() if n}


def _assert_close_trees(what: str, got, want, tol: dict) -> float:
    """Two state trees: float tensors within ``tol``, the rest (spikes,
    words, heads) exact; returns the largest float error."""
    import torch

    from repro_torch.tree import tree_leaves

    err = 0.0
    for a, b in zip(tree_leaves(got), tree_leaves(want), strict=True):
        if a is None and b is None:
            continue
        if a.dtype.is_floating_point:
            if not torch.allclose(a, b, **tol):
                raise SystemExit(f"{what}: values differ beyond {tol}")
            err = max(err, (a - b).abs().max().item() if a.numel() else 0.0)
        elif not torch.equal(a, b):
            raise SystemExit(f"{what}: spikes or words differ")
    return err


def _matrix_cell(rule: str, backend: str, kind: str, raster, device):
    """One matrix cell for MATRIX_STEPS steps from a seeded init: (weights and
    membranes, the post spikes or spike counts, the timing states, the
    initial weights).  The sparse cells run uncapped (the audit caps them at
    4 events), so that they compute the reference's function; the capped
    run is phase ``sparse_mstdp``'s."""
    import torch

    from repro_torch.core.engine import EngineConfig, init_engine, run_engine
    from repro_torch.models import snn

    gen = torch.Generator().manual_seed(0)
    if kind == "engine":
        cfg = EngineConfig(n_pre=16, n_post=8, rule=rule, backend=backend)
        st0 = init_engine(cfg, generator=gen, device=device)
        st, out = run_engine(st0, raster, cfg)
        return (st.w, st.neurons), out, (st.pre_hist, st.post_hist), st0.w
    in_shape, spec = MATRIX_SHAPES[kind]
    cfg = snn.SNNConfig(name=f"matrix-{kind}", input_shape=in_shape,
                        layers=(snn.SNNLayerSpec(**spec),), rule=rule, backend=backend)
    st0 = snn.init_snn(cfg, 1, generator=gen, device=device)
    st, counts = snn.run_snn(st0, raster, cfg)
    layer = st.layers[0]
    return ((st.weights, layer.neurons, layer.theta), counts,
            (layer.pre_hist, layer.post_hist), st0.weights[0])


def phase_matrix(device) -> dict:
    """Every fused and sparse cell of BENCH_static.json (rule × backend ×
    kind) on the card against the same cell on ``reference`` on the card:
    spikes and timing words exact, weights within the parity contract (conv
    layers within the net tolerance).  Returns the kernels' launches, the
    counters set to 0 just before and read just after."""
    import torch

    cells = json.loads((ROOT / "BENCH_static.json").read_text())["static_audit"]["cells"]
    cells = [(c["rule"], c["backend"], c["kind"]) for c in cells
             if c["backend"] in MATRIX_BACKENDS]
    counters = _train_counters()
    launches: dict[str, int] = {}
    t0 = time.perf_counter()
    for i, (rule, backend, kind) in enumerate(cells):
        gen = torch.Generator().manual_seed(100 + i)
        shape = (16,) if kind == "engine" else (1, *MATRIX_SHAPES[kind][0])
        raster = (torch.rand((MATRIX_STEPS, *shape), generator=gen) < 0.3).float().to(device)
        for fn in counters.values():
            fn.launches = 0
        vals, out, timing, w0 = _matrix_cell(rule, backend, kind, raster, device)
        cell = _kernel_names({k: fn.launches for k, fn in counters.items()}, rule)
        for k, n in cell.items():
            launches[k] = launches.get(k, 0) + n
        ref_vals, ref_out, ref_timing, _ = _matrix_cell(rule, "reference", kind, raster,
                                                        device)
        what = f"{rule}/{backend}/{kind}"
        tol = MATRIX_TOL if kind in ("engine", "fc") else TRAIN_TOL
        err = _assert_close_trees(what, (vals, out, timing), (ref_vals, ref_out, ref_timing),
                                  tol)
        moved = not torch.equal(vals[0] if kind == "engine" else vals[0][0], w0)
        _phase("matrix", f"{what}: {MATRIX_STEPS} steps vs reference on the card, max|err| "
               f"{err:.3g}, spikes and words exact, weights moved {moved}; launches "
               f"{cell or 'none (no kernel on this path)'}")
        if not moved:
            raise SystemExit(f"{what}: the weights did not move")
    torch.cuda.synchronize()
    _phase("matrix", f"{len(cells)} cells OK in {time.perf_counter() - t0:.2f} s; launches "
           f"{launches}")
    return launches


def _audit_kernel_op(rule: str, backend: str, kind: str) -> str | None:
    """The one kernel operator a step of an audit cell holds: the history
    rules' packed engine update (kernel 1) or conv delta (kernel 3, also the
    fc layers' batch sum), the counter rules' (5, 6, the fc delta), mstdp's on magnitude
    planes (2, 4); the sparse conv delta runs kernel 4 on the gathered rows;
    the reference and fused_interpret cells none."""
    conv = kind in ("conv2d", "conv1d")
    if backend == "sparse":
        return "itp_stdp_conv_delta" if conv else None
    if backend != "fused":
        return None
    if rule in COUNTER_WINDOWS:
        return {"engine": "counter_stdp_update", "fc": "counter_fc_delta"}.get(
            kind, "counter_conv_delta")
    base = "itp_stdp_update" if kind == "engine" else "itp_stdp_conv_delta"
    return base + "_packed" if rule in ("itp", "itp_nocomp") else base


def phase_audit(device) -> dict:
    """The graph audit of the port (``repro_torch.analysis.graph_audit``) with
    CUDA state: every cell of BENCH_static.json traced on fake CUDA tensors,
    0 violations, no stale float64 allowlist entry, and each cell's kernel
    operators as the path predicts.  Then phase ``matrix``'s 36 fused and
    sparse cells: the traced graph run on the card for MATRIX_STEPS steps
    beside the eager step, each step bit-equal, the graph launching what the
    eager step launches (the counters set to 0 just before each step and
    read just after).  Returns the graphs' launches."""
    import torch
    from torch.utils._pytree import tree_leaves

    from repro_torch.analysis import graph_audit as GA

    t0 = time.perf_counter()
    report = GA.run_audit(device=device)
    static = json.loads((ROOT / "BENCH_static.json").read_text())["static_audit"]["cells"]
    cells = {(c["rule"], c["backend"], c["kind"]): c for c in report["cells"]}
    if set(cells) != {(c["rule"], c["backend"], c["kind"]) for c in static}:
        raise SystemExit("audit: the traced cells are not BENCH_static.json's")
    bad = [c for c in report["cells"] if c["violations"]]
    if bad or report["stale_allowlist"]:
        raise SystemExit(f"audit: violations {bad}, stale allowlist "
                         f"{report['stale_allowlist']}")
    for (rule, backend, kind), c in cells.items():
        want = _audit_kernel_op(rule, backend, kind)
        if c["kernel_ops"] != ({f"repro_torch::{want}": 1} if want else {}):
            raise SystemExit(f"audit {rule}/{backend}/{kind}: kernel ops {c['kernel_ops']}, "
                             f"expected {want}")
    trace_s = time.perf_counter() - t0
    f64 = sum(c["has_f64"] for c in report["cells"])
    _phase("audit", f"{report['n_cells']} cells traced on {device} in {trace_s:.2f} s: 0 "
           f"violations, uint8 in every packed cell, float64 in {f64} cells, all at "
           f"allowlisted sites, no stale entry; one kernel op per fused cell")

    counters = _train_counters()
    launches: dict[str, int] = {}
    t0 = time.perf_counter()
    runs = [k for k in cells if k[1] in MATRIX_BACKENDS]
    for i, (rule, backend, kind) in enumerate(runs):
        state, spikes, step = GA.cell_program(rule, backend, kind, device=device)
        gm = GA.trace(step, state, spikes)
        gen = torch.Generator().manual_seed(200 + i)
        eager = graph = state
        for _ in range(MATRIX_STEPS):
            x = (torch.rand(spikes.shape, generator=gen) < 0.3).float().to(device)
            for fn in counters.values():
                fn.launches = 0
            eager, out_e = step(eager, x)
            want = {k: fn.launches for k, fn in counters.items()}
            for fn in counters.values():
                fn.launches = 0
            graph, out_g = gm(graph, x)
            got = {k: fn.launches for k, fn in counters.items()}
            if got != want:
                raise SystemExit(f"audit {rule}/{backend}/{kind}: the graph launched {got}, "
                                 f"the eager step {want}")
            for a, b in zip(tree_leaves((eager, out_e)), tree_leaves((graph, out_g)),
                            strict=True):
                if not torch.equal(a, b):
                    raise SystemExit(f"audit {rule}/{backend}/{kind}: graph != eager")
            for k, n in _kernel_names(got, rule).items():
                launches[k] = launches.get(k, 0) + n
    torch.cuda.synchronize()
    _phase("audit", f"{len(runs)} traced fused/sparse graphs run on the card for "
           f"{MATRIX_STEPS} steps each: bit-equal to eager, launches equal, in "
           f"{time.perf_counter() - t0:.2f} s; graph launches {launches}")
    return {"launches": launches, "cells": report["n_cells"], "graphs": len(runs),
            "trace_s": trace_s}


def _device_total_ms(fn, *, n: int = 50) -> tuple[float, float]:
    """Device time per call of ``fn`` summed over every kernel, copy and
    memset it issues (a profiler trace), and the device events per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    total_us = sum(getattr(e, "device_time", 0.0) or getattr(e, "cuda_time", 0.0)
                   for e in events)
    return total_us / n / 1e3, len(events) / n


def _sparse_engine(device) -> dict:
    """The sparse itp engine at the 2layer-snn fc width beside the fused one,
    step by step from one state: bit-equal weights and spikes at every step;
    a capped run twice, bit-equal; the sparse update's device time beside
    kernel 1's at the state of the middle step."""
    import torch

    from repro_torch import plasticity
    from repro_torch.core.engine import EngineConfig, engine_step, init_engine

    gen = torch.Generator().manual_seed(21)
    lo, hi = SPARSE_W
    w0 = lo + (hi - lo) * torch.rand((SPARSE_ENGINE["n_pre"], SPARSE_ENGINE["n_post"]),
                                     generator=gen)
    raster = (torch.rand((SPARSE_STEPS, SPARSE_ENGINE["n_pre"]), generator=gen)
              < SPARSE_RATE).float().to(device)
    cfgs = {b: EngineConfig(**SPARSE_ENGINE, backend=b) for b in ("fused", "sparse")}
    states = {b: init_engine(cfg, w_init=w0, device=device) for b, cfg in cfgs.items()}
    mid = SPARSE_STEPS // 2
    pre_n = post_n = 0.0
    for t in range(SPARSE_STEPS):
        before = dict(states)
        posts = {}
        for b, cfg in cfgs.items():
            states[b], posts[b] = engine_step(states[b], raster[t], cfg)
        if not (torch.equal(posts["fused"], posts["sparse"])
                and torch.equal(states["fused"].w, states["sparse"].w)):
            raise SystemExit(f"sparse engine: differs from fused at step {t}")
        if t == mid:   # the update's operands at this step, for the timing below
            at_mid = (before, raster[t], posts["sparse"])
        pre_n += float(raster[t].sum())
        post_n += float(posts["sparse"].sum())
    pre_density = pre_n / (SPARSE_STEPS * SPARSE_ENGINE["n_pre"])
    post_density = post_n / (SPARSE_STEPS * SPARSE_ENGINE["n_post"])
    moved = not torch.equal(states["sparse"].w, w0.to(device))
    _phase("sparse_mstdp", f"engine 784x100 itp sparse vs fused, {SPARSE_STEPS} steps at "
           f"input rate {SPARSE_RATE}: bit-equal at every step (w and spikes); observed "
           f"density pre {pre_density:.4f}, post {post_density:.4f}; w moved {moved}")
    if not (moved and post_n > 0):
        raise SystemExit("sparse engine: no post spike or no learning")

    capped = EngineConfig(**SPARSE_ENGINE, backend="sparse", max_events=SPARSE_CAP)
    runs = []
    for _ in range(2):
        st = init_engine(capped, w_init=w0, device=device)
        for t in range(SPARSE_STEPS):
            st, _ = engine_step(st, raster[t], capped)
        runs.append(st.w)
    if not torch.equal(*runs):
        raise SystemExit("capped sparse engine: two runs differ")
    _phase("sparse_mstdp", f"capped (max_events={SPARSE_CAP}) sparse run x2: bit-equal; "
           f"max|w - uncapped w| {(runs[0] - states['sparse'].w).abs().max().item():.3g}")

    # the update of the middle step, alone: the sparse update (every kernel of
    # it) beside kernel 1 and the fused update (kernel 1 and its word packing)
    before, pre, post = at_mid
    calls = {b: (lambda p=plasticity.make_plan(cfg, device), s=before[b]:
                 p.update(s.w, pre, post, s.pre_hist, s.post_hist))
             for b, cfg in cfgs.items()}
    if not torch.equal(calls["fused"](), calls["sparse"]()):
        raise SystemExit("sparse vs fused update at the timed step differ")
    out = {"pre_density": pre_density, "post_density": post_density,
           "pre_events": int(pre.sum()), "post_events": int(post.sum())}
    for b, call in calls.items():
        out[f"{b}_ms"] = _time_ms(call)
        out[f"{b}_device_ms"], out[f"{b}_events"] = _device_total_ms(call)
    out["kernel1_device_ms"] = _device_ms(calls["fused"], "itp_stdp_kernel")
    _phase("sparse_mstdp", f"the update of step {mid} alone ({out['pre_events']} pre, "
           f"{out['post_events']} post events): sparse {out['sparse_device_ms']:.5f} ms "
           f"device ({out['sparse_events']:.0f} device events a call), "
           f"{out['sparse_ms']:.5f} ms by events; fused {out['fused_device_ms']:.5f} ms "
           f"device ({out['fused_events']:.0f} device events), {out['fused_ms']:.5f} ms by "
           f"events; kernel 1 alone {out['kernel1_device_ms']} ms device")
    return out


def phase_sparse_mstdp(device) -> dict:
    """The sparse backend and mstdp at full width: the sparse engine; the
    slice's serving load with mstdp on fused (kernel 2 on magnitude planes,
    2 B/neuron) and with itp on sparse at a realistic input rate, each held
    against reference; the 2layer-snn accuracy protocol with mstdp; one
    6layer-dcsnn batch on mstdp/fused (kernel 4 on magnitude planes) and on
    itp/sparse, each held against reference.  Launches are counted per run,
    the counters set to 0 just before each."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.core.engine import EngineConfig
    from repro_torch.launch.serve import synthetic_load
    from repro_torch.models import snn
    from repro_torch.serve import ServeConfig
    from repro_torch.train.stdp_trainer import TrainerConfig

    out = {"engine": _sparse_engine(device)}
    counters = _train_counters()
    scfg = ServeConfig(**SERVE_SCFG)
    serving = {}
    for rule, backend, rate in (("mstdp", "fused", 0.3), ("itp", "sparse", SPARSE_RATE)):
        cfg = EngineConfig(**dict(SERVE_CFG, rule=rule), backend=backend)
        load = synthetic_load(torch.Generator().manual_seed(1), t_steps=scfg.t_steps,
                              n_pre=cfg.n_pre, rate=rate, **SERVE_LOAD)
        _serve(cfg, scfg, load[:scfg.max_batch], device, threaded=False)     # warm
        for fn in counters.values():
            fn.launches = 0
        server, results, seconds = _serve(cfg, scfg, load, device, threaded=True)
        launches = {k: fn.launches for k, fn in counters.items() if fn.launches}
        want = {"itp_stdp_update": server.batches * scfg.t_steps} if backend == "fused" else {}
        if launches != want:
            raise SystemExit(f"serving {rule}/{backend}: launches {launches}, expected {want}")
        nbytes = server.store.state_bytes_per_session()
        words = server.store.plan.words_per_neuron()
        if nbytes != words * (cfg.n_pre + cfg.n_post) or words != (2 if rule == "mstdp" else 1):
            raise SystemExit(f"serving {rule}: {nbytes} B/session of plasticity cache")
        ref_rps = _serve_parity(cfg, scfg, load, device, server, results, what=rule)
        post_rate = float(np.mean([r.post.mean() for r in results]))
        _phase("sparse_mstdp", f"serving rule={rule} {backend} at input rate {rate}: "
               f"{len(results)}/{len(load)} requests in {server.batches} batches, "
               f"{len(load) / seconds:.2f} requests/s ({ref_rps:.2f} on reference), "
               f"{nbytes} B/session of plasticity cache ({words} B/neuron), mean post "
               f"rate {post_rate:.4f}; fused/sparse == reference (rasters and words "
               f"exact), solo == interleaved (bitwise); launches {launches}")
        serving[f"{rule}/{backend}"] = {"requests_per_s": len(load) / seconds,
                                        "bytes_per_session": nbytes, "launches": launches}
    out["serving"] = serving

    train = {"2layer-snn mstdp": _accuracy_protocol("mstdp", device)}
    dcsnn_t = dataclasses.replace(TrainerConfig(**DCSNN_TRAIN), batches_per_epoch=1)
    for rule, backend in (("mstdp", "fused"), ("itp", "sparse")):
        cfg = snn.fmnist_dcsnn(rule, backend=backend)
        key = f"6layer-dcsnn {rule if rule != 'itp' else backend}"
        train[key] = _train_net("6layer-dcsnn", cfg, dcsnn_t, device, conv_layers=2)
    out["train"] = train
    return out


def _dir_bytes(path: Path) -> tuple[int, int]:
    """(bytes of the ``.npy`` files, bytes of every file) under ``path``."""
    files = [f for f in path.iterdir() if f.is_file()]
    return (sum(f.stat().st_size for f in files if f.suffix == ".npy"),
            sum(f.stat().st_size for f in files))


def _engine_counters() -> dict:
    """The dense kernels the engine paths launch, by the kernels line's names
    (the counter kernel's count goes to the run's window)."""
    from repro_torch.kernels.itp_counter import kernel as NK
    from repro_torch.kernels.itp_stdp import kernel as K

    return {"itp_stdp_update_packed": K.itp_stdp_update_packed,
            "itp_stdp_update": K.itp_stdp_update,
            "counter_stdp_update": NK.counter_stdp_update}


def _launch_name(name: str, rule: str) -> str:
    return f"counter_stdp_update[{rule}]" if name == "counter_stdp_update" else name


def _persist_serving(rule: str, scratch: Path, device) -> dict:
    """The slice load on fused, served in two halves around a checkpoint and
    a restore into a new Server, against one uninterrupted server."""
    import numpy as np
    import torch

    from repro_torch.core.engine import EngineConfig
    from repro_torch.launch.serve import synthetic_load
    from repro_torch.serve import ServeConfig, Server

    cfg = EngineConfig(**dict(SERVE_CFG, rule=rule), backend="fused")
    scfg = ServeConfig(**SERVE_SCFG)
    load = synthetic_load(torch.Generator().manual_seed(1), t_steps=scfg.t_steps,
                          n_pre=cfg.n_pre, rate=0.3, **SERVE_LOAD)
    half = len(load) // 2
    whole, whole_results, _ = _serve(cfg, scfg, load, device, threaded=False)
    ckpt_dir = scratch / rule
    counters = _engine_counters()
    for fn in counters.values():
        fn.launches = 0
    first, results, _ = _serve(cfg, scfg, load[:half], device, threaded=False)
    t0 = time.perf_counter()
    path = Path(first.checkpoint(str(ckpt_dir)))
    save_ms = (time.perf_counter() - t0) * 1e3
    second = Server(cfg, scfg, seed=0, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    second.restore(str(ckpt_dir))
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    tickets = [second.submit(r) for r in load[half:]]
    second.drain()
    torch.cuda.synchronize()
    launches = {_launch_name(k, rule): fn.launches for k, fn in counters.items()
                if fn.launches}
    batches = first.batches + second.batches
    kernel = {"itp": "itp_stdp_update_packed", "exact": "counter_stdp_update[exact]",
              "mstdp": "itp_stdp_update"}[rule]
    if launches != {kernel: batches * scfg.t_steps}:
        raise SystemExit(f"persist {rule}: launches {launches}, expected "
                         f"{ {kernel: batches * scfg.t_steps} }")
    results += [second.poll(t) for t in tickets]
    if not all(r is not None and np.array_equal(r.post, w.post)
               for r, w in zip(results, whole_results)):
        raise SystemExit(f"persist {rule}: post rasters differ from the uninterrupted run")
    if second.store.session_ids != whole.store.session_ids:
        raise SystemExit(f"persist {rule}: LRU order differs")
    _assert_states(_states(second), _states(whole), exact=True,
                   what=f"persist {rule} restored vs uninterrupted")
    npy, total = _dir_bytes(path)
    sessions = len(second.store)
    resident = second.store.resident_bytes_per_session()

    # a leaf corrupted on purpose: the restore must refuse it
    victim = path / "user0__.w.npy"
    arr = np.load(victim)
    arr[0, 0] += 1.0
    np.save(victim, arr)
    try:
        Server(cfg, scfg, seed=0, device=device).restore(str(ckpt_dir))
    except IOError as e:
        refused = str(e)
    else:
        raise SystemExit(f"persist {rule}: a corrupted leaf was restored")
    if "checksum" not in refused:
        raise SystemExit(f"persist {rule}: corrupted leaf refused for another reason: {refused}")
    _phase("persist", f"serving {rule}/fused: {half} + {len(load) - half} requests around a "
           f"checkpoint and a restore into a new Server == uninterrupted (rasters, words, "
           f"w, v, theta, t bitwise; LRU order kept); save {save_ms:.3f} ms, restore "
           f"{restore_ms:.3f} ms wall ({sessions} sessions); on disk {npy / sessions:.1f} "
           f"B/session of .npy ({total / sessions:.1f} with the manifest; resident "
           f"{resident} B); corrupted leaf refused ({refused}); launches {launches}")
    return {"save_ms": save_ms, "restore_ms": restore_ms, "npy_bytes_per_session":
            npy / sessions, "bytes_per_session": total / sessions, "launches": launches}


def _persist_runner(scratch: Path, device) -> dict:
    """TrainingRunner over the engine population: a failure at step
    RUNNER_FAIL_AT, restore and replay, against an uninterrupted run."""
    import torch

    from repro_torch.core.engine import EngineConfig, engine_step, init_engine_population
    from repro_torch.distributed import FailureInjector, RunnerConfig, TrainingRunner

    cfg = EngineConfig(n_pre=ENGINE_DEFAULTS["engine_pre"],
                       n_post=ENGINE_DEFAULTS["engine_post"], backend="fused")
    replicas, steps = ENGINE_DEFAULTS["replicas"], ENGINE_DEFAULTS["steps"]

    def batch_fn(step):
        g = torch.Generator().manual_seed(10_000 + step)
        return (torch.rand((replicas, cfg.n_pre), generator=g)
                < ENGINE_DEFAULTS["engine_rate"]).float().to(device)

    def step_fn(state, x):
        state, post = engine_step(state, x, cfg)
        return state, {"post_rate": post.float().mean()}

    kernel = _engine_counters()["itp_stdp_update_packed"]
    runs = {}
    for name, injector in (("uninterrupted", None),
                           ("failure", FailureInjector({RUNNER_FAIL_AT}))):
        state = init_engine_population(cfg, replicas, device=device,
                                       generator=torch.Generator().manual_seed(0))
        runner = TrainingRunner(RunnerConfig(ckpt_dir=str(scratch / f"runner_{name}"),
                                             ckpt_every=RUNNER_CKPT_EVERY), step_fn, batch_fn)
        torch.cuda.synchronize()
        kernel.launches = 0
        t0 = time.perf_counter()
        final = runner.run(state, steps, injector)
        torch.cuda.synchronize()
        runs[name] = (final, kernel.launches, time.perf_counter() - t0, runner)
    (a, na, sa, _), (b, nb, sb, rb) = runs["uninterrupted"], runs["failure"]
    resume = RUNNER_FAIL_AT // RUNNER_CKPT_EVERY * RUNNER_CKPT_EVERY
    want = steps + RUNNER_FAIL_AT - resume
    same = all(torch.equal(x, y) for x, y in zip(
        (a.w, a.pre_hist.planes, a.pre_hist.head, a.post_hist.planes, a.post_hist.head,
         a.neurons.v),
        (b.w, b.pre_hist.planes, b.pre_hist.head, b.post_hist.planes, b.post_hist.head,
         b.neurons.v)))
    restart = [e for e in rb.log if e.get("event") == "restart"]
    _phase("persist", f"TrainingRunner {replicas}x{cfg.n_pre}x{cfg.n_post} itp/fused, "
           f"{steps} steps, ckpt_every {RUNNER_CKPT_EVERY}, failure at step "
           f"{RUNNER_FAIL_AT}: restarts {rb.restarts} ({restart}), kernel-1 launches {nb} "
           f"(uninterrupted {na}), final state == uninterrupted bitwise {same}; wall "
           f"{sb * 1e3:.1f} ms with the failure, {sa * 1e3:.1f} ms without; stragglers "
           f"{len(rb.watchdog.stragglers)}")
    if not (same and rb.restarts == 1 and na == steps and nb == want
            and restart[0]["resume_step"] == resume):
        raise SystemExit(f"runner restart: equal {same}, restarts {rb.restarts}, launches "
                         f"{nb} (want {want}), log {restart}")
    return {"launches": nb, "seconds": sb, "uninterrupted_seconds": sa}


def phase_persist(device) -> dict:
    """Session checkpointing and the restart runner: the slice load with
    itp, exact and mstdp on fused around a checkpoint and a restore (each ==
    the uninterrupted server bitwise, a corrupted leaf refused); then the
    engine population through TrainingRunner with a failure injected.  The
    checkpoints go under the checkout's ``build/`` and are removed."""
    import shutil
    import tempfile

    (ROOT / "build").mkdir(exist_ok=True)
    scratch = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=ROOT / "build"))
    try:
        serving = {rule: _persist_serving(rule, scratch, device)
                   for rule in ("itp", "exact", "mstdp")}
        runner = _persist_runner(scratch, device)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    return {"serving": serving, "runner": runner}


def phase_engine(device) -> dict:
    """``launch.train --engine`` at its defaults (the launcher's own parser and
    training function) with itp/fused, exact/fused and itp/sparse; each
    against the same run on reference on the card (itp/fused bitwise)."""
    import torch

    from repro_torch.launch.train import build_parser, engine_training

    counters = _engine_counters()
    out = {}
    for rule, backend in (("itp", "fused"), ("exact", "fused"), ("itp", "sparse")):
        args = build_parser().parse_args(["--engine", "--rule", rule, "--backend", backend,
                                          "--device", str(device)])
        for fn in counters.values():
            fn.launches = 0
        summary, states, post = engine_training(args)
        launches = {_launch_name(k, rule): fn.launches for k, fn in counters.items()
                    if fn.launches}
        steps = summary["steps"]
        shape = dict(engine_pre=summary["n_pre"], engine_post=summary["n_post"],
                     replicas=summary["replicas"], engine_rate=args.engine_rate, steps=steps)
        if shape != ENGINE_DEFAULTS:
            raise SystemExit(f"engine: the launcher's defaults {shape} are not "
                             f"{ENGINE_DEFAULTS}")
        want = ({} if backend == "sparse" else
                {_launch_name("counter_stdp_update" if rule == "exact"
                              else "itp_stdp_update_packed", rule): 2 * steps})
        if launches != want:
            raise SystemExit(f"engine {rule}/{backend}: launches {launches}, expected {want}")
        ref_args = build_parser().parse_args(["--engine", "--rule", rule, "--backend",
                                              "reference", "--device", str(device)])
        ref_summary, ref_states, ref_post = engine_training(ref_args)
        err = (states.w - ref_states.w).abs().max().item()
        bitwise = torch.equal(states.w, ref_states.w) and torch.equal(post, ref_post)
        ok = (torch.equal(post, ref_post) and torch.allclose(states.w, ref_states.w,
                                                             **MATRIX_TOL)
              and (bitwise or (rule, backend) != ("itp", "fused"))
              and bool(torch.isfinite(states.w).all()))
        _phase("engine", f"launch.train --engine --rule {rule} --backend {backend} "
               f"({summary['replicas']} x {summary['n_pre']}x{summary['n_post']} x {steps} "
               f"steps at rate {args.engine_rate}): {summary['sops_per_s']:.4e} SOP/s, run "
               f"{summary['run_seconds']} s, warm-up {summary['compile_seconds']} s, mean "
               f"post rate {summary['mean_post_rate']:.4f}; reference {ref_summary['sops_per_s']:.4e} "
               f"SOP/s; vs reference max|err| {err:.3g} (bitwise {bitwise}); launches "
               f"{launches} -> {'OK' if ok else 'MISMATCH'}")
        if not ok:
            raise SystemExit(f"engine {rule}/{backend} differs from reference")
        out[f"{rule}/{backend}"] = dict(summary, launches=launches)
    return out


def _free_port() -> int:
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_sharded(device) -> dict:
    """The weight-sharded engine on a 1 x 1 NCCL grid in this process: at the
    2layer-snn fc width over SHARDED_STEPS steps for itp, exact and linear on
    fused and itp on sparse, each == the unsharded run_engine (spikes and
    weights bitwise), one kernel launch a step on fused; the sharded step's
    wall ms beside the unsharded one's.  The group is destroyed at the end."""
    import os

    import torch
    import torch.distributed as dist

    from repro_torch.core.engine import EngineConfig, init_engine, run_engine
    from repro_torch.core.engine_sharded import make_sharded_engine_step, shard_engine_state
    from repro_torch.distributed.sharding import init_process_group, make_grid

    port = _free_port()
    os.environ["MASTER_ADDR"], os.environ["MASTER_PORT"] = "127.0.0.1", str(port)
    init_process_group(device, rank=0, world_size=1, init_method=f"tcp://127.0.0.1:{port}")
    out = {}
    try:
        grid = make_grid(1, 1, device=device)
        gen = torch.Generator().manual_seed(31)
        lo, hi = SPARSE_W
        w0 = lo + (hi - lo) * torch.rand((SPARSE_ENGINE["n_pre"], SPARSE_ENGINE["n_post"]),
                                         generator=gen)
        raster = (torch.rand((SHARDED_STEPS, SPARSE_ENGINE["n_pre"]), generator=gen)
                  < SPARSE_RATE).float().to(device)
        counters = _engine_counters()
        for rule, backend in (("itp", "fused"), ("exact", "fused"), ("linear", "fused"),
                              ("itp", "sparse")):
            cfg = EngineConfig(**SPARSE_ENGINE, rule=rule, backend=backend)
            step = make_sharded_engine_step(cfg, grid)

            def sharded():
                st = shard_engine_state(init_engine(cfg, w_init=w0, device=device), grid)
                posts = []
                for x in raster:
                    st, post = step(st, x)
                    posts.append(post)
                return st, torch.stack(posts)

            def unsharded():
                return run_engine(init_engine(cfg, w_init=w0, device=device), raster, cfg)

            for fn in counters.values():
                fn.launches = 0
            st, post = sharded()
            torch.cuda.synchronize()
            launches = {_launch_name(k, rule): fn.launches for k, fn in counters.items()
                        if fn.launches}
            want = ({} if backend == "sparse" else
                    {_launch_name("counter_stdp_update" if rule != "itp"
                                  else "itp_stdp_update_packed", rule): SHARDED_STEPS})
            ref_st, ref_post = unsharded()
            ok = (torch.equal(post, ref_post) and torch.equal(st.w, ref_st.w)
                  and torch.equal(st.neurons.v, ref_st.neurons.v) and launches == want)
            times = {"sharded": [], "unsharded": []}
            for order in ((sharded, unsharded), (unsharded, sharded)):
                for fn in order:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    times[fn.__name__].append((time.perf_counter() - t0) * 1e3 / SHARDED_STEPS)
            ms = {k: min(v) for k, v in times.items()}
            rate = post.float().mean().item()
            _phase("sharded", f"{rule}/{backend} 784x100 on a 1x1 {dist.get_backend()} grid, "
                   f"{SHARDED_STEPS} steps (post rate {rate:.4f}): == run_engine (spikes, w, "
                   f"v bitwise) {ok}; launches {launches}; step wall "
                   f"{ms['sharded']:.4f} ms sharded vs {ms['unsharded']:.4f} ms unsharded "
                   f"(the least of two runs each)")
            if not ok:
                raise SystemExit(f"sharded {rule}/{backend}: differs from run_engine or "
                                 f"launches {launches} != {want}")
            if not 0 < rate < 1:
                raise SystemExit(f"sharded {rule}/{backend}: post rate {rate}")
            out[f"{rule}/{backend}"] = {"launches": launches, "sharded_ms": ms["sharded"],
                                        "unsharded_ms": ms["unsharded"]}
            if (rule, backend) == ("itp", "fused"):
                from torch.profiler import ProfilerActivity, profile

                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    sharded()
                    torch.cuda.synchronize()
                    seconds = time.perf_counter() - t0
                _report_profile(prof, seconds, f"one sharded itp/fused run of {SHARDED_STEPS} "
                                "steps")

        # the step's two collectives alone, at its sizes: the current's
        # all_reduce over the column and the spikes' and membrane's all_gather
        # over the row
        current = torch.zeros(SPARSE_ENGINE["n_post"], device=device)
        local = torch.zeros((2, SPARSE_ENGINE["n_post"]), device=device)
        parts = [torch.empty_like(local) for _ in range(grid.model)]

        def collectives():
            for _ in range(SHARDED_STEPS):
                dist.all_reduce(current, group=grid.col_group)
                dist.all_gather(parts, local, group=grid.row_group)

        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            collectives()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3 / SHARDED_STEPS)
        out["collectives_ms"] = min(walls)
        _phase("sharded", f"the two collectives of a step alone: {out['collectives_ms']:.4f} "
               f"ms wall a step (the least of three runs of {SHARDED_STEPS})")
    finally:
        dist.destroy_process_group()
    return out


def _lm_close(what: str, got, want, tol: dict) -> float:
    """Hold ``got`` against ``want`` (any devices) within ``tol``, as
    ``assert_allclose`` does; the largest absolute difference."""
    import torch

    g, w = got.detach().cpu().double(), want.detach().cpu().double()
    if g.shape != w.shape:
        raise SystemExit(f"lm: {what}: shape {tuple(g.shape)} != {tuple(w.shape)}")
    err = (g - w).abs().max().item() if g.numel() else 0.0
    if not torch.allclose(g, w, **tol):
        raise SystemExit(f"lm: {what} differs: max|err| {err:.3g} beyond {tol}")
    return err


def _lm_leaves(x) -> list:
    """The tensors of a decode cache (nested named tuples), Nones left out."""
    if x is None:
        return []
    if isinstance(x, tuple):
        return [leaf for kid in x for leaf in _lm_leaves(kid)]
    return [x]


def _lm_perturbed(node: dict, gen) -> dict:
    """Every bias, norm scale, gate and SSM vector drawn away from its init
    (zeros and ones would hide them)."""
    import torch

    return {k: _lm_perturbed(v, gen) if isinstance(v, dict) else
            v + 0.3 * torch.randn(v.shape, generator=gen) if k in LM_PERTURBED else v
            for k, v in node.items()}


def _lm_walls(fn, reps: int = 3) -> list[float]:
    """Host seconds of ``reps`` synchronised calls of ``fn`` after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return walls


def _lm_profile(fn, what: str) -> float | None:
    """One profiled, synchronised call of ``fn``: its wall, busy share and
    top device kernels (``_report_profile``); returns the busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    return _report_profile(prof, seconds, what)


def _lm_run(cfg, params, toks, vis, device, steps: int) -> list:
    """``forward`` then ``steps`` teacher-forced ``decode_step``s on a float32
    cache: [logits, aux losses, decode logits, every cache leaf]."""
    import torch

    from repro_torch.models.transformer import decode_step, forward, init_decode_cache

    kw = {} if vis is None else {"vis_embed": vis}
    logits, aux = forward(params, cfg, tokens=toks, **kw)
    if cfg.family == "interleaved":          # training and prefill only: no decode cache
        return [logits, aux["moe_aux"], aux["moe_z"]]
    cache = init_decode_cache(cfg, toks.shape[0], steps, torch.float32, device=device)
    dec = []
    for t in range(steps):
        d, cache = decode_step(params, cfg, cache, t, tokens=toks[:, t:t + 1], **kw)
        dec.append(d)
    return [logits, aux["moe_aux"], aux["moe_z"], torch.cat(dec, 1)] + _lm_leaves(cache)


def _lm_families(device, cpu) -> dict:
    """Every registered smoke config at float32: the card against the CPU."""
    import dataclasses

    import torch

    from repro_torch.configs import ARCH_NAMES, get_smoke_config
    from repro_torch.models.transformer import init_model
    from repro_torch.tree import tree_map

    B, S, steps = LM_SMOKE["batch"], LM_SMOKE["seq"], LM_SMOKE["steps"]
    out = {}
    for i, arch in enumerate(ARCH_NAMES):
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        gen = torch.Generator().manual_seed(40 + i)
        params = _lm_perturbed(init_model(gen, cfg, device=cpu), gen)
        toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
        vis = (torch.randn((B, 8, cfg.vis_dim), generator=gen) * 0.5
               if cfg.family == "vlm" else None)
        card = tree_map(lambda a: a.to(device), params)
        on_card = (cfg, card, toks.to(device), None if vis is None else vis.to(device), device,
                   steps)
        got = _lm_run(*on_card)
        want = _lm_run(cfg, params, toks, vis, cpu, steps)
        tol = LM_SSM_TOL if cfg.family in ("ssm", "interleaved") else LM_TOL
        if len(got) != len(want):
            raise SystemExit(f"lm: {arch}: {len(got)} outputs on the card, {len(want)} on the CPU")
        err = max(_lm_close(f"{arch} output {j}", g, w, tol)
                  for j, (g, w) in enumerate(zip(got, want)))
        twice = ""
        if cfg.is_moe:
            same = all(torch.equal(a, b) for a, b in zip(got, _lm_run(*on_card)))
            twice = f"; two card runs bit-equal {same}"
            if not same:
                raise SystemExit(f"lm: {arch}: two CUDA runs differ")
        decoded = len(got) > 3
        what = ("logits, two aux losses" + (f", decode logits, {len(got) - 4} cache leaves"
                                           if decoded else ""))
        _phase("lm", f"{arch} smoke (float32, B={B}, S={S}, {steps if decoded else 0} decode "
               f"steps): card == CPU within {tol}, max|err| {err:.3g} over {len(got)} outputs "
               f"({what}){twice}")
        out[arch] = err
    return out


def _lm_dense(device, cpu, smi: str) -> dict:
    """qwen3-0.6b at full width and depth."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import decode_step, forward, init_decode_cache, init_model
    from repro_torch.tree import tree_leaves, tree_map

    cfg = get_config(LM_DENSE)
    f32 = dataclasses.replace(cfg, dtype="float32")
    gen = torch.Generator(device=device).manual_seed(50)
    params = init_model(gen, cfg, device=device)
    n_params = sum(a.numel() for a in tree_leaves(params))
    if n_params != LM_PARAMS[LM_DENSE]:
        raise SystemExit(f"lm: {LM_DENSE} has {n_params} parameters")
    out = {"params": n_params}

    B, S = LM_DECODE_CHECK
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=device)
    fwd, _ = forward(params, f32, tokens=toks)
    cache = init_decode_cache(f32, B, S, torch.float32, device=device)
    dec = []
    for t in range(S):
        d, cache = decode_step(params, f32, cache, t, tokens=toks[:, t:t + 1])
        dec.append(d)
    gap = (torch.cat(dec, 1) - fwd).abs().max().item()
    scale = fwd.abs().max().item()
    _phase("lm", f"{LM_DENSE} ({n_params} float32 parameters, {cfg.n_layers} layers, d "
           f"{cfg.d_model}): float32 teacher-forced decode vs forward at B={B}, S={S}: "
           f"max|dlogit| {gap:.3g} against {LM_DECODE_REL} x max|logit| {scale:.4g}")
    if not gap <= LM_DECODE_REL * scale:
        raise SystemExit(f"lm: {LM_DENSE} decode differs from forward by {gap}")
    del cache, dec, fwd

    layers, B, S = LM_CUT
    cut_cfg = dataclasses.replace(f32, n_layers=layers)
    cut = {"embed": params["embed"], "final_norm": params["final_norm"],
           "blocks": tree_map(lambda a: a[:layers], params["blocks"])}
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=device)
    got, _ = forward(cut, cut_cfg, tokens=toks)
    want, _ = forward(tree_map(lambda a: a.to(cpu), cut), cut_cfg, tokens=toks.to(cpu))
    err = _lm_close(f"{LM_DENSE} {layers}-layer cut", got, want, LM_TOL)
    _phase("lm", f"{LM_DENSE} cut to {layers} layers, float32 forward at B={B}, S={S}: card == "
           f"CPU within {LM_TOL}, max|err| {err:.3g} (max|logit| {want.abs().max().item():.4g})")
    del got, want

    B, S = LM_PREFILL
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=device)
    torch.cuda.reset_peak_memory_stats()
    walls = _lm_walls(lambda: forward(params, cfg, tokens=toks, last_logits_only=True))
    prefill_s = statistics.median(walls)
    out.update(prefill_tok_s=B * S / prefill_s, prefill_ms=prefill_s * 1e3,
               prefill_peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    _phase("lm", f"{LM_DENSE} bfloat16 prefill B={B} x S={S} (last_logits_only, blockwise "
           f"attention, {S // 1024} query blocks): {out['prefill_ms']:.2f} ms, "
           f"{out['prefill_tok_s']:.1f} tokens/s (median of {len(walls)}: "
           f"{[round(w * 1e3, 2) for w in walls]} ms), peak {out['prefill_peak_gb']:.3f} GB "
           f"allocated [{smi}]")
    out["prefill_busy"] = _lm_profile(
        lambda: forward(params, cfg, tokens=toks, last_logits_only=True),
        f"one {LM_DENSE} bfloat16 prefill ({B} x {S})")

    # the float32 master weights cast to bfloat16: once per step for each
    # leaf, as the reference casts them (``p[...].astype(dt)``)
    out["cast_ms"] = _time_ms(lambda: [a.to(torch.bfloat16) for a in tree_leaves(params)],
                              reps=5, inner=3)
    out["embed_cast_ms"] = _time_ms(lambda: params["embed"]["tok"].to(torch.bfloat16),
                                    reps=10, inner=5)
    _phase("lm", f"{LM_DENSE} weight casts float32 -> bfloat16: every leaf {out['cast_ms']:.4f} "
           f"ms, the {tuple(params['embed']['tok'].shape)} table alone "
           f"{out['embed_cast_ms']:.4f} ms (CUDA events) [{smi}]")

    B, T, steps = LM_DECODE["batch"], LM_DECODE["max_t"], LM_DECODE["steps"]
    toks = torch.randint(0, cfg.vocab_size, (B, steps + 1), generator=gen, device=device)
    finals = {}
    for kv in (torch.bfloat16, torch.int8):
        warm = init_decode_cache(cfg, B, T, kv, device=device)
        for t in range(2):
            decode_step(params, cfg, warm, t, tokens=toks[:, t:t + 1])
        del warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cache = init_decode_cache(cfg, B, T, kv, device=device)
        t0 = time.perf_counter()
        for t in range(steps):
            logits, cache = decode_step(params, cfg, cache, t, tokens=toks[:, t:t + 1])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        name = str(kv).replace("torch.", "")
        finals[name] = logits.float()
        out[f"decode_{name}"] = {"tok_s": B * steps / wall, "step_ms": wall / steps * 1e3,
                                 "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        r = out[f"decode_{name}"]
        _phase("lm", f"{LM_DENSE} bfloat16 decode B={B}, {steps} steps on a {T}-slot {name} "
               f"cache: {r['step_ms']:.3f} ms a step, {r['tok_s']:.1f} tokens/s, peak "
               f"{r['peak_gb']:.3f} GB allocated [{smi}]")
        if kv == torch.bfloat16:
            out["decode_busy"] = _lm_profile(
                lambda: decode_step(params, cfg, cache, steps, tokens=toks[:, steps:]),
                f"one {LM_DENSE} bfloat16 decode step (B={B}, {T}-slot cache)")
        del cache
    a, b = finals["bfloat16"], finals["int8"]
    rmse = ((a - b).square().mean().sqrt() / a.square().mean().sqrt()).item()
    out["int8_rmse"] = rmse
    _phase("lm", f"{LM_DENSE} int8 against bfloat16 cache after {steps} steps: relative RMSE "
           f"{rmse:.5f} (bound {LM_INT8_RMSE}); logits finite {bool(a.isfinite().all())}")
    if not (rmse < LM_INT8_RMSE and a.isfinite().all() and b.isfinite().all()):
        raise SystemExit(f"lm: {LM_DENSE} int8 decode: relative RMSE {rmse}")
    return out


def _lm_ssm(device, smi: str) -> dict:
    """mamba2-1.3b at full width and depth."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import decode_step, forward, init_decode_cache, init_model
    from repro_torch.tree import tree_leaves

    cfg = get_config(LM_SSM)
    gen = torch.Generator(device=device).manual_seed(60)
    params = init_model(gen, cfg, device=device)
    n_params = sum(a.numel() for a in tree_leaves(params))
    if n_params != LM_PARAMS[LM_SSM]:
        raise SystemExit(f"lm: {LM_SSM} has {n_params} parameters")
    out = {"params": n_params}

    B, S = SSM_PREFILL
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=device)
    torch.cuda.reset_peak_memory_stats()
    walls = _lm_walls(lambda: forward(params, cfg, tokens=toks, last_logits_only=True))
    prefill_s = statistics.median(walls)
    out.update(prefill_tok_s=B * S / prefill_s, prefill_ms=prefill_s * 1e3,
               prefill_peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    _phase("lm", f"{LM_SSM} ({n_params} float32 parameters, {cfg.n_layers} layers, d "
           f"{cfg.d_model}) bfloat16 prefill B={B} x S={S} ({S // cfg.ssd_chunk} SSD chunks, "
           f"last_logits_only): {out['prefill_ms']:.2f} ms, {out['prefill_tok_s']:.1f} tokens/s "
           f"(median of {len(walls)}), peak {out['prefill_peak_gb']:.3f} GB allocated [{smi}]")
    out["prefill_busy"] = _lm_profile(
        lambda: forward(params, cfg, tokens=toks, last_logits_only=True),
        f"one {LM_SSM} bfloat16 prefill ({B} x {S})")

    steps = SSM_DECODE_STEPS
    warm = init_decode_cache(cfg, B, steps, device=device)
    for t in range(2):
        decode_step(params, cfg, warm, t, tokens=toks[:, t:t + 1])
    torch.cuda.synchronize()
    cache = init_decode_cache(cfg, B, steps, device=device)
    t0 = time.perf_counter()
    for t in range(steps):
        logits, cache = decode_step(params, cfg, cache, t, tokens=toks[:, t:t + 1])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out.update(decode_tok_s=B * steps / wall, decode_step_ms=wall / steps * 1e3)
    _phase("lm", f"{LM_SSM} bfloat16 decode B={B}, {steps} steps: {out['decode_step_ms']:.3f} "
           f"ms a step, {out['decode_tok_s']:.1f} tokens/s; logits finite "
           f"{bool(logits.isfinite().all())} [{smi}]")
    if not logits.isfinite().all():
        raise SystemExit(f"lm: {LM_SSM} decode logits not finite")
    out["decode_busy"] = _lm_profile(
        lambda: decode_step(params, cfg, cache, steps, tokens=toks[:, :1]),
        f"one {LM_SSM} bfloat16 decode step (B={B})")
    del warm, cache

    f32 = dataclasses.replace(cfg, dtype="float32")
    B, S = SSM_DECODE_CHECK
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=device)
    fwd, _ = forward(params, f32, tokens=toks)
    cache = init_decode_cache(f32, B, S, torch.float32, device=device)
    dec = []
    for t in range(S):
        d, cache = decode_step(params, f32, cache, t, tokens=toks[:, t:t + 1])
        dec.append(d)
    err = _lm_close(f"{LM_SSM} decode vs forward", torch.cat(dec, 1), fwd, LM_SSM_TOL)
    _phase("lm", f"{LM_SSM} float32 teacher-forced decode vs forward at B={B}, S={S}: within "
           f"{LM_SSM_TOL}, max|err| {err:.3g} (max|logit| {fwd.abs().max().item():.4g})")
    out["decode_vs_forward"] = err
    return out


def _lm_moe(device, cpu, smi: str) -> dict:
    """One qwen2-moe-a2.7b MoE layer at full width."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.moe import apply_moe, init_moe, moe_capacity
    from repro_torch.tree import tree_leaves, tree_map

    cfg = get_config(LM_MOE)
    gen = torch.Generator(device=device).manual_seed(70)
    p = init_moe(gen, cfg, device=device)
    n_params = sum(a.numel() for a in tree_leaves(p))
    B, S = MOE_LOAD
    x = torch.randn((B, S, cfg.d_model), generator=gen, device=device).to(torch.bfloat16)
    o1, l1 = apply_moe(p, x, cfg)
    o2, l2 = apply_moe(p, x, cfg)
    same = torch.equal(o1, o2) and all(torch.equal(l1[k], l2[k]) for k in l1)
    walls = _lm_walls(lambda: apply_moe(p, x, cfg))
    ms = statistics.median(walls) * 1e3
    out = {"params": n_params, "ms": ms, "tok_s": B * S / ms * 1e3, "bit_equal": same}
    _phase("lm", f"{LM_MOE} MoE layer ({cfg.n_experts} experts padded to {cfg.experts_alloc}, "
           f"top-{cfg.n_experts_per_tok}, d {cfg.d_model}, moe_d_ff {cfg.moe_d_ff}, shared "
           f"{cfg.shared_d_ff}; {n_params} float32 parameters) bfloat16 at B={B} x S={S} "
           f"(capacity {moe_capacity(cfg, S)}): two runs bit-equal {same}; {ms:.3f} ms, "
           f"{out['tok_s']:.1f} tokens/s (median of {len(walls)}) [{smi}]")
    if not (same and o1.isfinite().all()):
        raise SystemExit(f"lm: {LM_MOE} MoE layer: bit-equal {same}")
    del o1, o2, x

    f32 = dataclasses.replace(cfg, dtype="float32")
    B, S = MOE_CHECK
    x = torch.randn((B, S, cfg.d_model), generator=gen, device=device)
    got, got_l = apply_moe(p, x, f32)
    want, want_l = apply_moe(tree_map(lambda a: a.to(cpu), p), x.to(cpu), f32)
    err = max([_lm_close(f"{LM_MOE} MoE layer float32", got, want, LM_TOL)]
              + [_lm_close(f"{LM_MOE} {k}", got_l[k], want_l[k], LM_TOL) for k in got_l])
    _phase("lm", f"{LM_MOE} MoE layer float32 at B={B} x S={S}: card == CPU within {LM_TOL} "
           f"(output and both losses), max|err| {err:.3g}")
    return out


def phase_lm(device, smi: str) -> dict:
    """The LM stack's forward and decode (ROADMAP item 18b) on the card: the
    smoke configs against the port on the CPU, qwen3-0.6b and
    mamba2-1.3b at full width and depth, one qwen2-moe-a2.7b MoE layer at
    full width.  Each load frees its parameters before the next."""
    import torch

    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    out = {"families": _lm_families(device, cpu)}
    for name, part in (("dense", lambda: _lm_dense(device, cpu, smi)),
                       ("ssm", lambda: _lm_ssm(device, smi)),
                       ("moe", lambda: _lm_moe(device, cpu, smi))):
        out[name] = part()
        torch.cuda.empty_cache()
    _phase("lm", f"phase wall {time.perf_counter() - t0:.1f} s")
    return out


def _to_device(tree, device):
    """A parameter tree, batch or ``OptState`` with every tensor on ``device``."""
    from repro_torch.train import OptState
    from repro_torch.tree import tree_map

    if isinstance(tree, OptState):
        return OptState(*(_to_device(x, device) for x in tree))
    return tree_map(lambda a: a.to(device), tree)


def _lm_train_step(cfg, *, remat: str = "full", po2_update: bool = True,
                   use_kernel: bool = True):
    from repro_torch.train import OptimizerConfig, TrainConfig, make_train_step

    return make_train_step(cfg, OptimizerConfig(**LM_TRAIN_OPT, po2_update=po2_update),
                           TrainConfig(remat=remat), use_kernel=use_kernel)


def _bitwise(a, b) -> bool:
    from repro_torch.tree import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(x.equal(y) for x, y in zip(la, lb))


def _lm_train_smoke(device, cpu) -> dict:
    """Every registered smoke config at float32: one AdamW step on the card
    against the CPU, one ITP-AdamW step twice on the card."""
    import dataclasses

    import torch

    from repro_torch.configs import ARCH_NAMES, get_smoke_config
    from repro_torch.data import LMBatchSpec, lm_batches
    from repro_torch.models.transformer import init_model
    from repro_torch.train import init_opt_state
    from repro_torch.tree import tree_leaves

    B, S = LM_TRAIN_SMOKE
    out = {}
    for i, arch in enumerate(ARCH_NAMES):
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        gen = torch.Generator().manual_seed(80 + i)
        params = _lm_perturbed(init_model(gen, cfg, device=cpu), gen)
        batch = next(lm_batches(gen, LMBatchSpec(batch=B, seq=S, vocab=cfg.vocab_size)))
        if cfg.family == "vlm":
            batch["vis_embed"] = torch.randn((B, 8, cfg.vis_dim), generator=gen) * 0.5
        state = init_opt_state(params)
        card = [_to_device(x, device) for x in (params, state, batch)]
        adamw = _lm_train_step(cfg, remat="none", po2_update=False)
        want, got = adamw(params, state, batch), adamw(*card)
        tol = LM_SSM_TOL if cfg.family in ("ssm", "hybrid", "interleaved") else LM_TOL
        err = max(_lm_close(f"{arch} step: leaf {j}", g, w, tol) for j, (g, w) in
                  enumerate(zip(tree_leaves(got[:2]), tree_leaves(want[:2]))))
        for name in want[2]:
            _lm_close(f"{arch} step: {name}", got[2][name], want[2][name], LM_TOL)
        itp = _lm_train_step(cfg, remat="none")
        same = _bitwise(itp(*card), itp(*card))
        _phase("lm_train", f"{arch} smoke (float32, B={B}, S={S}): AdamW step card == CPU "
               f"within {tol}, max|err| {err:.3g} over params and moments; ITP-AdamW step "
               f"twice on the card bit-equal {same}")
        if not same:
            raise SystemExit(f"lm_train: {arch}: two card steps differ")
        out[arch] = err
    return out


# device kernels of the LM train step by kind: the first pattern a kernel's
# name contains decides (float32 products run on SIMT/FFMA kernels, bf16 ones
# on tensor-core GEMMs)
LM_KINDS = (("float32 products", ("sgemm", "f32f32_f32f32", "ffma")),
            ("bf16 products", ("gemm", "nvjet", "xmma")),
            ("copies and casts", ("copy",)),
            ("reductions", ("reduce",)),
            ("po2 kernels", ("po2_",)))


def _device_kinds(prof) -> dict:
    """Device ms of one profiled run by kind (``LM_KINDS``, the rest
    "other elementwise"), each kernel's own time counted once."""
    import torch

    kinds = {name: 0.0 for name, _ in LM_KINDS}
    kinds["other elementwise"] = 0.0
    for row in prof.key_averages():
        if row.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(row, "self_device_time_total", 0.0) or getattr(
            row, "self_cuda_time_total", 0.0)
        kind = next((name for name, pats in LM_KINDS if any(p in row.key for p in pats)),
                    "other elementwise")
        kinds[kind] += us / 1e3
    return kinds


def _lm_flat_grad(params, cfg, batch):
    """(loss, the gradient flattened) of ``lm_loss`` with ``remat="full"``."""
    import torch

    from repro_torch.train import TrainConfig, loss_and_grads
    from repro_torch.tree import tree_leaves

    loss, _, grads = loss_and_grads(params, cfg, batch, train_cfg=TrainConfig(remat="full"))
    return loss, torch.cat([g.flatten() for g in tree_leaves(grads)])


def _lm_train_full(device, smi: str) -> dict:
    """qwen3-0.6b trained at full width and depth with ITP-AdamW."""
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data import LMBatchSpec, lm_batches
    from repro_torch.kernels.po2_quant import kernel as PK
    from repro_torch.train import OptimizerConfig, init_training
    from repro_torch.tree import tree_leaves

    cfg = get_config(LM_DENSE)
    cpu = torch.device("cpu")
    gen = torch.Generator(device=device).manual_seed(90)
    params, opt = init_training(gen, cfg, OptimizerConfig(**LM_TRAIN_OPT, po2_update=True),
                                device=device)
    # counted without keeping a list of the leaves: a reference to the
    # initial params would stay allocated through the timed steps
    n_params = sum(a.numel() for a in tree_leaves(params))
    n_leaves = len(tree_leaves(params))
    if n_params != LM_PARAMS[LM_DENSE]:
        raise SystemExit(f"lm_train: {LM_DENSE} has {n_params} parameters")

    def batches(shape):
        spec = LMBatchSpec(batch=shape[0], seq=shape[1], vocab=cfg.vocab_size)
        return lambda step: next(lm_batches(torch.Generator(device).manual_seed(1000 + step),
                                            spec, n_steps=1))

    B, S = LM_TRAIN
    batch_for = batches(LM_TRAIN)
    if not all(torch.equal(a, b) for a, b in zip(batch_for(0).values(),
                                                 batch_for(0).values())):
        raise SystemExit("lm_train: one seed gave two batches")     # a replay needs one
    step = _lm_train_step(cfg)
    counters = (PK.po2_encode, PK.po2_decode)

    # --- the main path: a warm-up step, the timed steps, one profiled step
    for fn in counters:
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, opt, m = step(params, opt, batch_for(0))
    losses = [float(m["loss"])]
    warm_s = time.perf_counter() - t0
    walls = []
    for k in range(1, LM_TRAIN_STEPS + 1):
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch_for(k))
        losses.append(float(m["loss"]))            # reads the loss back: the step is done
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 1e9
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch_for(LM_TRAIN_STEPS + 1))
        losses.append(float(m["loss"]))
        seconds = time.perf_counter() - t0
    n_steps = LM_TRAIN_STEPS + 2
    launches = {fn.__name__: fn.launches for fn in counters}
    # the state's float32 bits summed: equal in two processes if the run is
    # deterministic across processes, not only within one
    checksum = sum(int(a.view(torch.int32).sum(dtype=torch.int64))
                   for a in tree_leaves((params, opt.mu, opt.nu)))
    step_s = statistics.median(walls)
    out = {"params": n_params, "leaves": n_leaves, "steps": n_steps, "step_ms": step_s * 1e3,
           "tok_s": B * S / step_s, "warm_ms": warm_s * 1e3, "peak_gb": peak, "losses": losses,
           "launches": launches, "grad_norm": float(m["grad_norm"])}
    _phase("lm_train", f"{LM_DENSE} ({n_params} float32 parameters, {n_leaves} leaves, "
           f"{cfg.n_layers} layers, d {cfg.d_model}, vocab {cfg.vocab_size}; bfloat16 compute) "
           f"trained with ITP-AdamW at B={B} x S={S}, remat full, Zipf tokens: "
           f"{out['step_ms']:.2f} ms a step, {out['tok_s']:.1f} tokens/s (median of "
           f"{len(walls)}: {[round(w * 1e3, 2) for w in walls]} ms; warm-up step "
           f"{out['warm_ms']:.2f} ms), peak {peak:.3f} GB allocated; losses {losses}; state "
           f"checksum {checksum}; po2 launches {launches} over {n_steps} steps [{smi}]")
    out["busy"] = _report_profile(prof, seconds, f"one {LM_DENSE} ITP-AdamW train step "
                                  f"({B} x {S}, remat full)")
    out["device_kinds_ms"] = _device_kinds(prof)
    _phase("profile", "  by kind: " + ", ".join(f"{k} {v:.2f} ms"
                                                for k, v in out["device_kinds_ms"].items()))
    want = {name: n_leaves * n_steps for name in launches}
    if launches != want or not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"lm_train: launches {launches} (want {want}), losses {losses}")

    # --- kernels 9-10 against the plain quantiser on this run's gradients
    b = batch_for(n_steps)
    kern = step(params, opt, b)
    plain = _lm_train_step(cfg, use_kernel=False)(params, opt, b)
    same = _bitwise(kern, plain)
    moved = sum(int((x != y).sum()) for x, y in zip(tree_leaves(kern[0]), tree_leaves(params)))
    _phase("lm_train", f"{LM_DENSE} step {n_steps + 1}: kernels po2_encode/po2_decode == the "
           f"plain quantiser (params, moments, metrics) bitwise {same}; {moved} parameters "
           f"moved")
    if not same:
        raise SystemExit("lm_train: the ITP-AdamW step on kernels 9-10 differs from the plain "
                         "quantiser's")
    del kern, plain

    # --- remat none / full / dots at a shorter sequence: each policy's
    # first step is held on the host against the others' (so no step's peak
    # holds another's result), then timed over LM_REMAT_REPS more
    rb = batches(LM_REMAT)(100)
    remat, first = {}, None
    for policy in ("none", "full", "dots"):
        remat_step = _lm_train_step(cfg, remat=policy)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res = remat_step(params, opt, rb)
        peak = torch.cuda.max_memory_allocated() / 1e9
        res = _to_device(res[:2], cpu) + (_to_device(res[2], cpu),)
        if first is None:
            first = res
        elif not _bitwise(res, first):
            raise SystemExit(f"lm_train: remat {policy} differs from remat none")
        del res
        walls = []
        for _ in range(LM_REMAT_REPS):
            t0 = time.perf_counter()
            float(remat_step(params, opt, rb)[2]["loss"])
            walls.append((time.perf_counter() - t0) * 1e3)
        remat[policy] = {"ms": statistics.median(walls), "peak_gb": peak}
    out["remat"] = remat
    _phase("lm_train", f"{LM_DENSE} remat at B={LM_REMAT[0]} x S={LM_REMAT[1]}: none / full / "
           f"dots bit-equal (loss {float(first[2]['loss']):.6f}, params, moments); "
           + ", ".join(f"{k} {v['ms']:.2f} ms peak {v['peak_gb']:.3f} GB"
                       for k, v in remat.items())
           + f" (median of {LM_REMAT_REPS} steps each) [{smi}]")
    del first

    # --- PyTorch's reduced-precision bf16 reduction against float32 compute
    pb = batches(LM_BF16_PROBE)(200)
    loss32, g32 = _lm_flat_grad(params, dataclasses.replace(cfg, dtype="float32"), pb)
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    probe = {}
    try:
        for on in (True, False):
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = on
            loss, g = _lm_flat_grad(params, cfg, pb)
            probe[on] = {"loss_rel": abs(float(loss) - float(loss32)) / abs(float(loss32)),
                         "grad_rel": float(torch.linalg.vector_norm(g - g32)
                                           / torch.linalg.vector_norm(g32)),
                         "grad_corr": float(torch.corrcoef(torch.stack([g, g32]))[0, 1])}
            del g
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = flag
    out["bf16_reduction"] = probe
    _phase("lm_train", f"{LM_DENSE} bfloat16 against float32 compute at B={LM_BF16_PROBE[0]} x "
           f"S={LM_BF16_PROBE[1]} (the process default allow_bf16_reduced_precision_reduction="
           f"{flag}): " + "; ".join(
               f"reduced-precision reduction {'on' if on else 'off'}: loss relative "
               f"{r['loss_rel']:.3g}, gradient relative error {r['grad_rel']:.5g}, correlation "
               f"{r['grad_corr']:.7f}" for on, r in probe.items()))
    return out


def _lm_train_launcher(device, smi: str) -> dict:
    """``launch.train``'s LM mode on the card at smoke size: a failure
    injected, one restart, the final state bit-equal to an uninterrupted run."""
    import shutil
    import tempfile

    from repro_torch.launch import train as launch_train

    (ROOT / "build").mkdir(exist_ok=True)
    scratch = Path(tempfile.mkdtemp(prefix="chip_smoke_lm_", dir=ROOT / "build"))
    ap = launch_train.build_parser()
    try:
        argv = LM_LAUNCH + ["--device", str(device)]
        clean, a = launch_train.lm_training(ap.parse_args(argv + ["--ckpt-dir",
                                                                  str(scratch / "a")]))
        failed, b = launch_train.lm_training(ap.parse_args(
            argv + ["--ckpt-dir", str(scratch / "b"), "--inject-failure-at",
                    str(LM_LAUNCH_FAIL_AT)]))
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    same = _bitwise(a, b)
    _phase("lm_train", f"launch.train LM mode {' '.join(LM_LAUNCH)} on {device}: "
           f"{clean['tokens_per_s']:.1f} tokens/s, final loss {clean['final_loss']:.5f}; with a "
           f"failure at step {LM_LAUNCH_FAIL_AT}: restarts {failed['restarts']}, final state "
           f"bit-equal {same} [{smi}]")
    if not (same and clean["restarts"] == 0 and failed["restarts"] == 1):
        raise SystemExit(f"lm_train: launcher restart: bit-equal {same}, restarts "
                         f"{clean['restarts']} / {failed['restarts']}")
    return {"clean": clean, "failed": failed}


# the dry run's count of one lm_train step, in a process of its own (a
# ``fake`` group cannot share a process with the NCCL group), on the CPU
_DRYRUN_COUNT = """
import json, sys
from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import dryrun
from repro_torch.launch.specs import plan_cell
from repro_torch.train import OptimizerConfig, TrainConfig
import torch.distributed as dist

arch, batch, seq = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
opt = json.loads(sys.argv[4])
dryrun._fake_group(1)
try:
    mesh = dryrun._mesh_for(False, (1, 1))
    plan = plan_cell(get_config(arch), ShapeSpec("lm_train", seq, batch, "train"), mesh,
                     opt_cfg=OptimizerConfig(**opt, po2_update=True),
                     train_cfg=TrainConfig(remat="full"))
    run = dryrun.run_plan(plan, mesh)
finally:
    dist.destroy_process_group()
print(json.dumps(run))
"""


def _start_dryrun_count() -> subprocess.Popen:
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen([sys.executable, "-c", _DRYRUN_COUNT, LM_DENSE, str(LM_TRAIN[0]),
                             str(LM_TRAIN[1]), json.dumps(LM_TRAIN_OPT)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


def _timed_steps(step, init, batch_for, n: int, counters, *, profile_last=False):
    """``n`` steps from the state ``init()`` draws: the walls of steps 2..
    (the first warms up), the peak GB, the launches of ``counters`` (set to
    0 first), the metrics of every step and, with ``profile_last``, one more
    step under the profiler ``(prof, seconds)``.  The initial state is drawn
    here, so no caller's reference keeps it allocated through the steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    params, opt = init()
    for fn in counters:
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls, metrics = [], []
    for k in range(n):
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch_for(k))
        metrics.append({name: float(v) for name, v in m.items()})   # the step is done
        if k:
            walls.append(time.perf_counter() - t0)
    launches = {fn.__name__: fn.launches for fn in counters}
    peak = torch.cuda.max_memory_allocated() / 1e9
    prof = None
    if profile_last:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, batch_for(n))
            float(m["loss"])
            prof = (p, time.perf_counter() - t0)
    return params, opt, {"walls": walls, "peak_gb": peak, "launches": launches,
                         "metrics": metrics, "prof": prof}


def _lm_sharded_steps(device, mesh, smi: str) -> dict:
    """(a) the fsdp step on the 1 x 1 mesh, tensor-parallel over 'model'
    (every one-rank collective skipped), against the unsharded step and
    beside the gather-on-use step (profile ``dp``: every weight gathered
    whole), and (b) the pod branch on the 1 x 1 x 1 mesh against the
    unsharded step fed the plain po2 round trip of its gradients, each from
    seed 90."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import LMBatchSpec, lm_batches
    from repro_torch.distributed.sharding import gather_tree, tp_mesh, use_sharding_profile
    from repro_torch.kernels.po2_quant import kernel as PK
    from repro_torch.kernels.po2_quant.ref import po2_roundtrip_ref
    from repro_torch.launch.mesh import describe, make_debug_mesh
    from repro_torch.train import (OptimizerConfig, TrainConfig, adamw_update, init_training,
                                   make_train_step)
    from repro_torch.train import train_step as TS
    from repro_torch.train.train_step import loss_and_grads
    from repro_torch.tree import tree_leaves, tree_map

    cfg = get_config(LM_DENSE)
    ocfg = OptimizerConfig(**LM_TRAIN_OPT, po2_update=True)
    tcfg = TrainConfig(remat="full")
    spec = LMBatchSpec(batch=LM_TRAIN[0], seq=LM_TRAIN[1], vocab=cfg.vocab_size)

    def batch_for(step):
        return next(lm_batches(torch.Generator(device).manual_seed(1000 + step), spec,
                               n_steps=1))

    def draw(m=None):
        return init_training(torch.Generator(device=device).manual_seed(90), cfg, ocfg,
                             mesh=m, device=device)

    def gathered(params, opt):
        return {"params": gather_tree(params), "mu": gather_tree(opt.mu),
                "nu": gather_tree(opt.nu)}

    counters = (PK.po2_encode, PK.po2_decode)
    out = {}

    # the steps that enter the tensor-parallel context: the step's loss and
    # gradients run with the mesh as its tp_mesh()
    entered = []
    enter = TS.use_tensor_parallel

    def counted_enter(m):
        entered.append(m)
        return enter(m)

    # (a) the single-pod fsdp step, tensor-parallel; then the gather-on-use
    # step and the unsharded one from the same draw
    TS.use_tensor_parallel = counted_enter
    try:
        params, opt, sh = _timed_steps(make_train_step(cfg, ocfg, tcfg, mesh),
                                       lambda: draw(mesh), batch_for, LM_SHARDED_STEPS, counters,
                                       profile_last=True)
    finally:
        TS.use_tensor_parallel = enter
    n_leaves = len(tree_leaves(params))
    sh["tp_steps"] = sum(m is mesh for m in entered)
    prof, prof_s = sh.pop("prof")
    sh["busy"] = _report_profile(prof, prof_s, f"one {LM_DENSE} ITP-AdamW train step on the "
                                 f"{describe(mesh)} mesh, tensor-parallel ({LM_TRAIN[0]} x "
                                 f"{LM_TRAIN[1]}, remat full)")
    del prof
    end_sharded = _to_device(gathered(params, opt), torch.device("cpu"))
    del params, opt
    torch.cuda.empty_cache()
    def draw_dp():
        with use_sharding_profile("dp"):
            return draw(mesh)
    params, opt, gou = _timed_steps(
        make_train_step(cfg, ocfg, TrainConfig(remat="full", sharding_profile="dp"), mesh),
        draw_dp, batch_for, LM_SHARDED_STEPS + 1, counters)
    gou.pop("prof")
    end_gou = _to_device(gathered(params, opt), torch.device("cpu"))
    del params, opt
    torch.cuda.empty_cache()
    params, opt, un = _timed_steps(make_train_step(cfg, ocfg, tcfg), draw, batch_for,
                                   LM_SHARDED_STEPS + 1, counters)
    un.pop("prof")
    # the unsharded run took one step more (the sharded run's profiled step)
    plain = _to_device({"params": params, "mu": opt.mu, "nu": opt.nu}, torch.device("cpu"))
    same = (_bitwise(end_sharded, plain) and sh["metrics"] == un["metrics"][:LM_SHARDED_STEPS])
    gou_same = gou["metrics"] == un["metrics"] and _bitwise(end_gou, plain)
    want = {fn.__name__: n_leaves * LM_SHARDED_STEPS for fn in counters}
    # every timed step and the profiled one, and no step outside the context
    tp_want = LM_SHARDED_STEPS + 1
    out["fsdp"] = dict(sh, same=same, unsharded=un, gather_on_use=dict(gou, same=gou_same),
                       want=want)
    _phase("lm_sharded", f"{LM_DENSE} on the {describe(mesh)} NCCL mesh (fsdp, DTensor state, "
           f"tensor-parallel over 'model': {sh['tp_steps']} steps in the context, every "
           f"one-rank collective skipped) at B={LM_TRAIN[0]} x S={LM_TRAIN[1]}, ITP-AdamW, "
           f"remat full: {LM_SHARDED_STEPS} steps + 1 profiled == the unsharded step (params, "
           f"moments, metrics) bitwise {same}; step ms tensor-parallel "
           f"{[round(w * 1e3, 2) for w in sh['walls']]} / gather-on-use (dp) "
           f"{[round(w * 1e3, 2) for w in gou['walls']]} / unsharded "
           f"{[round(w * 1e3, 2) for w in un['walls']]}; peak {sh['peak_gb']:.3f} / "
           f"{gou['peak_gb']:.3f} / {un['peak_gb']:.3f} GB; gather-on-use == unsharded bitwise "
           f"{gou_same}; busy share {sh['busy']}; po2 launches {sh['launches']} (want {want}) "
           f"[{smi}]")
    if (not same or sh["launches"] != want or sh["tp_steps"] != tp_want or not gou_same
            or tp_mesh() is not None):
        raise SystemExit(f"lm_sharded: the 1 x 1 fsdp step: bitwise {same}, launches "
                         f"{sh['launches']} (want {want}), tensor-parallel steps "
                         f"{sh['tp_steps']} (want {tp_want}), gather-on-use == unsharded "
                         f"{gou_same}")
    del params, opt, end_sharded, end_gou, plain
    torch.cuda.empty_cache()

    # (b) the pod branch: pod-local gradients, the po2 mean over one pod
    pod_mesh = make_debug_mesh(1, 1, pod=1, device=device)
    params, opt, pod = _timed_steps(
        make_train_step(cfg, ocfg, TrainConfig(remat="full", pod_compression=True), pod_mesh),
        lambda: draw(pod_mesh), batch_for, LM_POD_STEPS, counters)
    pod.pop("prof")
    end_pod = _to_device(gathered(params, opt), torch.device("cpu"))
    del params, opt
    torch.cuda.empty_cache()
    params, opt = draw()

    def roundtrip_step(params, opt, batch):
        _, metrics, grads = loss_and_grads(params, cfg, batch, train_cfg=tcfg)
        grads = tree_map(po2_roundtrip_ref, grads)          # the plain versions
        new_p, new_o, om = adamw_update(ocfg, params, grads, opt)
        return new_p, new_o, dict(metrics, **om)

    metrics = []
    for k in range(LM_POD_STEPS):
        params, opt, m = roundtrip_step(params, opt, batch_for(k))
        metrics.append({name: float(v) for name, v in m.items()})
    same = (_bitwise(end_pod, _to_device({"params": params, "mu": opt.mu, "nu": opt.nu},
                                         torch.device("cpu")))
            and pod["metrics"] == metrics)
    want = {fn.__name__: 2 * n_leaves * LM_POD_STEPS for fn in counters}
    out["pod"] = dict(pod, same=same, want=want)
    _phase("lm_sharded", f"{LM_DENSE} on the {describe(pod_mesh)} mesh, pod_compression: "
           f"{LM_POD_STEPS} steps == the unsharded step fed the plain po2 round trip of its "
           f"gradients bitwise {same}; step ms {[round(w * 1e3, 2) for w in pod['walls']]}; "
           f"po2 launches {pod['launches']} (want {want}: the pod mean's encode and decode "
           f"and ITP-AdamW's, per leaf per step) [{smi}]")
    if not same or pod["launches"] != want:
        raise SystemExit(f"lm_sharded: the pod branch: bitwise {same}, launches "
                         f"{pod['launches']} (want {want})")
    del params, opt, end_pod
    torch.cuda.empty_cache()
    return out


def _lm_sharded_ssm(device, mesh, smi: str) -> dict:
    """mamba2-1.3b's ITP-AdamW step at full width on the 1 x 1 mesh under
    fsdp, its SSM mixer split over 'model' (ROADMAP item 19b), against the
    unsharded step from the same draw, bitwise."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import LMBatchSpec, lm_batches
    from repro_torch.distributed.sharding import gather_tree
    from repro_torch.kernels.po2_quant import kernel as PK
    from repro_torch.launch.mesh import describe
    from repro_torch.train import OptimizerConfig, TrainConfig, init_training, make_train_step
    from repro_torch.train import train_step as TS
    from repro_torch.tree import tree_leaves

    cfg = get_config(LM_SSM)
    ocfg = OptimizerConfig(**LM_TRAIN_OPT, po2_update=True)
    tcfg = TrainConfig(remat="full")
    spec = LMBatchSpec(batch=SSM_TRAIN[0], seq=SSM_TRAIN[1], vocab=cfg.vocab_size)

    def batch_for(step):
        return next(lm_batches(torch.Generator(device).manual_seed(2000 + step), spec,
                               n_steps=1))

    def draw(m=None):
        return init_training(torch.Generator(device=device).manual_seed(92), cfg, ocfg,
                             mesh=m, device=device)

    counters = (PK.po2_encode, PK.po2_decode)
    entered = []
    enter = TS.use_tensor_parallel

    def counted_enter(m):
        entered.append(m)
        return enter(m)

    TS.use_tensor_parallel = counted_enter
    try:
        params, opt, sh = _timed_steps(make_train_step(cfg, ocfg, tcfg, mesh),
                                       lambda: draw(mesh), batch_for, SSM_TRAIN_STEPS, counters)
    finally:
        TS.use_tensor_parallel = enter
    sh.pop("prof")
    n_leaves = len(tree_leaves(params))
    n_params = sum(a.numel() for a in tree_leaves(params))
    # the end states are held on the host, so neither run's peak counts the
    # other's state
    cpu = torch.device("cpu")
    end = _to_device({"params": gather_tree(params), "mu": gather_tree(opt.mu),
                      "nu": gather_tree(opt.nu)}, cpu)
    del params, opt
    torch.cuda.empty_cache()
    params, opt, un = _timed_steps(make_train_step(cfg, ocfg, tcfg), draw, batch_for,
                                   SSM_TRAIN_STEPS, counters)
    un.pop("prof")
    same = (_bitwise(end, _to_device({"params": params, "mu": opt.mu, "nu": opt.nu}, cpu))
            and sh["metrics"] == un["metrics"])
    tp_steps = sum(m is mesh for m in entered)
    want = {fn.__name__: n_leaves * SSM_TRAIN_STEPS for fn in counters}
    B, S = SSM_TRAIN
    _phase("lm_sharded", f"{LM_SSM} ({n_params} float32 parameters, {cfg.n_layers} layers, d "
           f"{cfg.d_model}) on the {describe(mesh)} NCCL mesh (fsdp, the SSM mixer split over "
           f"'model': {tp_steps} steps in the context) at B={B} x S={S}, ITP-AdamW, remat full: "
           f"{SSM_TRAIN_STEPS} steps == the unsharded step (params, moments, metrics) bitwise "
           f"{same}; step ms tensor-parallel {[round(w * 1e3, 2) for w in sh['walls']]} / "
           f"unsharded {[round(w * 1e3, 2) for w in un['walls']]}; peak {sh['peak_gb']:.3f} / "
           f"{un['peak_gb']:.3f} GB; losses {[round(m['loss'], 6) for m in sh['metrics']]}; po2 "
           f"launches {sh['launches']} (want {want}) [{smi}]")
    if not same or sh["launches"] != want or tp_steps != SSM_TRAIN_STEPS:
        raise SystemExit(f"lm_sharded: the {LM_SSM} step: bitwise {same}, launches "
                         f"{sh['launches']} (want {want}), tensor-parallel steps {tp_steps}")
    del params, opt, end
    torch.cuda.empty_cache()
    return dict(sh, same=same, unsharded=un, want=want)


def _lm_sharded_plans(device, mesh, smi: str) -> dict:
    """``launch.specs``' prefill and decode plans (ROADMAP item 19b) for
    qwen3-0.6b and mamba2-1.3b at full width on the 1 x 1 mesh under fsdp,
    on DTensors, against ``forward(last_logits_only=True)`` and
    ``decode_step``: logits and every cache leaf bitwise; each call's ms
    beside the unsharded one's."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.distributed.sharding import (distribute_like, distribute_tree,
                                                  map_with_path, param_spec_tree)
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import describe
    from repro_torch.models.transformer import decode_step, forward, init_decode_cache, init_model

    entered = []
    enter = specs.use_tensor_parallel

    def counted_enter(m):
        entered.append(m)
        return enter(m)

    def placed(tree, shardings):
        by_path: dict = {}
        map_with_path(by_path.__setitem__, shardings)
        return map_with_path(lambda path, x: distribute_like(x, mesh, by_path[path].placements),
                             tree)

    def local(tree):
        out: list = []
        map_with_path(lambda _, x: out.append(x.to_local() if hasattr(x, "to_local") else x),
                      tree)
        return out

    out = {}
    specs.use_tensor_parallel = counted_enter
    try:
        for arch in (LM_DENSE, LM_SSM):
            cfg = get_config(arch)
            gen = torch.Generator(device=device).manual_seed(93)
            params = init_model(gen, cfg, device=device)
            dparams = distribute_tree(params, param_spec_tree(cfg, params, mesh), mesh)
            B, S = PLAN_PREFILL[arch]
            toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=device)
            plan = specs.plan_cell(cfg, ShapeSpec("prefill", S, B, "prefill"), mesh)
            batch = placed({"tokens": toks}, plan.in_shardings[1])
            n0 = len(entered)
            got = plan.fn(dparams, batch)
            with torch.no_grad():
                want, _ = forward(params, cfg, tokens=toks, last_logits_only=True)
            prefill_same = got.equal(want) and len(entered) == n0 + 1
            plan_ms = statistics.median(_lm_walls(lambda: plan.fn(dparams, batch))) * 1e3
            with torch.no_grad():
                plain_ms = statistics.median(_lm_walls(
                    lambda: forward(params, cfg, tokens=toks, last_logits_only=True))) * 1e3
            del got, want

            d = PLAN_DECODE[arch]
            Bd, T = d["batch"], d["max_t"]
            cache = init_decode_cache(cfg, Bd, T, device=device)
            for x in _lm_leaves(cache):                      # every slot prefilled
                x.copy_(torch.randn(x.shape, generator=gen, device=device) * 0.5)
            twin = map_with_path(lambda _, x: x.clone(), cache)
            dplan = specs.plan_cell(cfg, ShapeSpec("decode", T, Bd, "decode"), mesh)
            dcache = placed(cache, dplan.in_shardings[1])
            steps = torch.randint(0, cfg.vocab_size, (Bd, PLAN_DECODE_STEPS), generator=gen,
                                  device=device)
            decode_same, walls, plain_walls = True, [], []
            n0 = len(entered)
            with torch.no_grad():
                for i in range(PLAN_DECODE_STEPS):
                    pos = T - PLAN_DECODE_STEPS + 1 + i      # the last one past the end
                    tok = placed({"t": steps[:, i:i + 1]}, {"t": dplan.in_shardings[2]})["t"]
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    lg, dcache = dplan.fn(dparams, dcache, tok, pos)
                    torch.cuda.synchronize()
                    walls.append(time.perf_counter() - t0)
                    t0 = time.perf_counter()
                    wl, twin = decode_step(params, cfg, twin, pos, tokens=steps[:, i:i + 1])
                    torch.cuda.synchronize()
                    plain_walls.append(time.perf_counter() - t0)
                    decode_same = decode_same and lg.equal(wl)
            decode_same = (decode_same and len(entered) == n0 + PLAN_DECODE_STEPS
                           and all(a.equal(b) for a, b in zip(local(dcache), _lm_leaves(twin))))
            out[arch] = {"prefill_same": prefill_same, "prefill_ms": plan_ms,
                         "prefill_plain_ms": plain_ms, "decode_same": decode_same,
                         "decode_ms": [w * 1e3 for w in walls],
                         "decode_plain_ms": [w * 1e3 for w in plain_walls],
                         "parallelism": (plan.parallelism, dplan.parallelism)}
            _phase("lm_sharded", f"{arch} plans on the {describe(mesh)} mesh ({plan.parallelism}"
                   f", DTensor weights and cache): prefill B={B} x S={S} == forward("
                   f"last_logits_only) bitwise {prefill_same}, {plan_ms:.2f} ms against "
                   f"{plain_ms:.2f}; decode B={Bd} on a {T}-slot cache at positions "
                   f"{T - PLAN_DECODE_STEPS + 1}..{T} == decode_step (logits, every cache leaf) "
                   f"bitwise {decode_same}, ms a step {[round(w * 1e3, 3) for w in walls]} "
                   f"against {[round(w * 1e3, 3) for w in plain_walls]} [{smi}]")
            if not (prefill_same and decode_same):
                raise SystemExit(f"lm_sharded: the {arch} plans differ from the unsharded paths "
                                 f"(prefill {prefill_same}, decode {decode_same})")
            del params, dparams, cache, twin, dcache
            torch.cuda.empty_cache()
    finally:
        specs.use_tensor_parallel = enter
    return out


def _lm_mesh_launcher(device, smi: str) -> dict:
    """``launch.train``'s LM mode with ``--data 1 --model 1`` (a one-rank
    NCCL group in this process) and a failure injected, against ``--data 0``."""
    import shutil
    import tempfile

    from repro_torch.launch import train as launch_train

    (ROOT / "build").mkdir(exist_ok=True)
    scratch = Path(tempfile.mkdtemp(prefix="chip_smoke_lm_mesh_", dir=ROOT / "build"))
    ap = launch_train.build_parser()
    argv = LM_LAUNCH + ["--device", str(device), "--inject-failure-at", str(LM_LAUNCH_FAIL_AT)]
    try:
        plain, a = launch_train.lm_training(ap.parse_args(argv + ["--ckpt-dir",
                                                                  str(scratch / "a")]))
        meshed, b = launch_train.mesh_lm_training(ap.parse_args(
            argv + ["--ckpt-dir", str(scratch / "b"), "--data", "1", "--model", "1"]))
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    b = {"params": b["params"], "opt": b["opt"]}
    same = _bitwise(a, b) and plain["final_loss"] == meshed["final_loss"]
    _phase("lm_sharded", f"launch.train {' '.join(argv)} --data 1 --model 1: mesh "
           f"{meshed['mesh']}, restarts {meshed['restarts']}, {meshed['tokens_per_s']:.1f} "
           f"tokens/s; final state bit-equal to --data 0 {same} [{smi}]")
    if not (same and meshed["restarts"] == 1 and plain["restarts"] == 1):
        raise SystemExit(f"lm_sharded: the launcher's mesh mode: bit-equal {same}, restarts "
                         f"{meshed['restarts']} / {plain['restarts']}")
    return {"plain": plain, "mesh": meshed}


def phase_lm_sharded(device, smi: str) -> dict:
    """Sharded LM training and serving plans (ROADMAP items 18d, 19a, 19b) on
    the card: (a) the fsdp step on a 1 x 1 NCCL mesh, tensor-parallel over
    'model', beside the gather-on-use step, and (b) the pod branch on a
    1 x 1 x 1 mesh, each against the unsharded step; mamba2-1.3b's step with
    its SSM mixer split, and the prefill and decode plans, against the
    unsharded paths; (c) their times beside the dry run's flop count of the
    step; (d) the launcher's mesh mode.  The group is
    initialised here on a free localhost port and destroyed before (d),
    which starts its own."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed.sharding import init_process_group
    from repro_torch.launch.mesh import make_debug_mesh

    t0 = time.perf_counter()
    counting = _start_dryrun_count()
    port = _free_port()
    init_process_group(device, rank=0, world_size=1, init_method=f"tcp://127.0.0.1:{port}")
    try:
        mesh = make_debug_mesh(1, 1, device=device)
        out = _lm_sharded_steps(device, mesh, smi)
        out["ssm"] = _lm_sharded_ssm(device, mesh, smi)
        out["plans"] = _lm_sharded_plans(device, mesh, smi)
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    out["launcher"] = _lm_mesh_launcher(device, smi)
    stdout, stderr = counting.communicate(timeout=600)
    if counting.returncode != 0:
        raise SystemExit(f"lm_sharded: the dry run's count failed: {stderr[-2000:]}")
    count = json.loads(stdout.strip().splitlines()[-1])
    flops = count["cost"]["flops"]
    a = out["fsdp"]
    step_s = statistics.median(a["walls"])
    out["dryrun"] = {"flops": flops, "collectives": count["collectives"]["total_operand_bytes"],
                     "count_s": count["seconds"],
                     "tflops_sharded": flops / step_s / 1e12,
                     "tflops_unsharded": flops / statistics.median(a["unsharded"]["walls"]) / 1e12}
    _phase("lm_sharded", f"launch.dryrun's count of one {LM_DENSE} step at B={LM_TRAIN[0]} x "
           f"S={LM_TRAIN[1]} on a 1 x 1 fake mesh: {flops:.4e} flops (counted in "
           f"{count['seconds']:.1f} s on the host); achieved {out['dryrun']['tflops_sharded']:.2f} "
           f"TFLOP/s sharded, {out['dryrun']['tflops_unsharded']:.2f} unsharded [{smi}]")
    _phase("lm_sharded", f"phase wall {time.perf_counter() - t0:.1f} s")
    return out


def phase_lm_train(device, smi: str) -> dict:
    """LM training with ITP-AdamW (ROADMAP item 18c) on the card."""
    import torch

    t0 = time.perf_counter()
    out = {"smoke": _lm_train_smoke(device, torch.device("cpu"))}
    out["full"] = _lm_train_full(device, smi)
    torch.cuda.empty_cache()
    out["launcher"] = _lm_train_launcher(device, smi)
    _phase("lm_train", f"phase wall {time.perf_counter() - t0:.1f} s")
    return out


def _dense_launches(serve: dict, train: dict, kernels: dict, engine: dict) -> dict:
    """A dense kernel launches in serving and in the engine paths
    (``engine``: launches by kernel and shape), the counter fc delta once per
    step in every fc layer of the counter training runs: their launches by
    shape, summed.  Each report takes its times at the shape where most of
    its launches fall (serving's where only the matrix and audit phases
    launch it).  Returns the summed launches."""
    fc_case = {"6layer-dcsnn": "DCSNN fc", "5layer-csnn": "CSNN fc",
               "2layer-snn": "2layer-snn fc"}
    dense = {name: {"serving": n} for name, n in serve["launches"].items() if n}
    for name, by_shape in engine.items():
        for shape, n in by_shape.items():
            dense.setdefault(name, {})[shape] = dense.get(name, {}).get(shape, 0) + n
    for run, r in train.items():   # the other rules' fc layers run kernels 3-4
        net, _, rule = run.partition(" ")
        n = r["launches"].get("counter_fc_delta", 0)
        if n:
            by_shape = dense.setdefault(f"counter_fc_delta[{rule}]", {})
            by_shape[fc_case[net]] = by_shape.get(fc_case[net], 0) + n
    for name, by_shape in dense.items():
        most = max(by_shape, key=by_shape.get)
        kernels[name].update(kernels[name]["cases"][most], launches_by_shape=by_shape)
        _phase("kernels", f"{name}: launches {by_shape}; timed at {most}")
    for name, k in kernels.items():
        if "cases" in k and name not in dense:
            k.update(k["cases"]["serving"])
            _phase("kernels", f"{name}: no launch on the main paths; timed at serving")
    return {name: sum(by_shape.values()) for name, by_shape in dense.items()}


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
    matrix = phase_matrix(device)
    audit = phase_audit(device)
    sparse_mstdp = phase_sparse_mstdp(device)
    # the mstdp serving load launches kernel 2 at serving's shape, the mstdp
    # and sparse training runs kernel 4
    serve["launches"]["itp_stdp_update"] += (
        sparse_mstdp["serving"]["mstdp/fused"]["launches"]["itp_stdp_update"])
    train.update(sparse_mstdp["train"])
    persist = phase_persist(device)
    engine = phase_engine(device)
    sharded = phase_sharded(device)
    lm = phase_lm(device, smi)
    lm_train = phase_lm_train(device, smi)
    lm_sharded = phase_lm_sharded(device, smi)
    # the persist phase's serving loads launch at serving's shape; the restart
    # runner and the engine launcher at the population's, the sharded engine
    # at its tile's
    engine_launches = {}
    for shape, runs in (("serving", persist["serving"].values()),
                        ("engine", [persist["runner"]] + list(engine.values())),
                        ("sharded", [r for k, r in sharded.items()
                                     if k != "collectives_ms"])):
        for r in runs:
            launched = r["launches"]
            if isinstance(launched, int):            # the runner: kernel 1 only
                launched = {"itp_stdp_update_packed": launched}
            for name, n in launched.items():
                by_shape = engine_launches.setdefault(name, {})
                by_shape[shape] = by_shape.get(shape, 0) + n
    # launches: each kernel's count from the runs of its main path (kernels
    # 3-4 every training run's, kernel 4 the unpacked runs' too; the counter
    # conv windows the exact DCSNN, linear CSNN and imstdp DCSNN runs), then
    # the matrix phase's cells
    launches = _dense_launches(serve, train, kernels, engine_launches)
    launches.update(_conv_launches(train, kernels))
    for window, run in (("exact", "6layer-dcsnn exact"), ("linear", "5layer-csnn linear"),
                        ("imstdp", "6layer-dcsnn imstdp")):
        launches[f"counter_conv_delta[{window}]"] = train[run]["launches"]["counter_conv_delta"]
    launches.update(side["launches"])   # the neuron datapath and ITP-AdamW runs
    for name, n in matrix.items():
        launches[name] = launches.get(name, 0) + n
        kernels[name].setdefault("launches_by_shape", {})["matrix"] = n
    for name, n in audit["launches"].items():
        launches[name] = launches.get(name, 0) + n
        kernels[name].setdefault("launches_by_shape", {})["audit"] = n
    for name, n in lm_train["full"]["launches"].items():   # ITP-AdamW at full width
        launches[name] += n
        kernels[name].setdefault("launches_by_shape", {})["lm_train"] = n
    for run in ("fsdp", "pod", "ssm"):  # the sharded steps and the pod mean at full width
        for name, n in lm_sharded[run]["launches"].items():
            launches[name] += n
            by_shape = kernels[name].setdefault("launches_by_shape", {})
            by_shape["lm_sharded"] = by_shape.get("lm_sharded", 0) + n
    e = sparse_mstdp["engine"]
    _phase("sparse_mstdp", f"sparse update at 784x100 (density pre {e['pre_density']:.4f}, "
           f"post {e['post_density']:.4f}): {e['sparse_device_ms']:.5f} ms device against "
           f"kernel 1's {e['kernel1_device_ms']} ms and the fused update's "
           f"{e['fused_device_ms']:.5f} ms")
    if not all(launches.get(name, 0) > 0 for name in kernels):
        raise SystemExit(f"a kernel of the path was never launched: {launches}")
    for net, r in train.items():
        _phase("train", f"{net}: {r['sim_steps_per_s']:.1f} sim-steps/s")
    for rule, r in persist["serving"].items():
        _phase("persist", f"{rule}: save {r['save_ms']:.3f} ms, restore {r['restore_ms']:.3f} "
               f"ms, {r['bytes_per_session']:.1f} B/session on disk")
    for run, r in engine.items():
        _phase("engine", f"{run}: {r['sops_per_s']:.4e} SOP/s, warm-up "
               f"{r['compile_seconds']} s")
    for run, r in sharded.items():
        if run != "collectives_ms":
            _phase("sharded", f"{run}: step {r['sharded_ms']:.4f} ms sharded, "
                   f"{r['unsharded_ms']:.4f} ms unsharded")
    d = lm["dense"]
    _phase("lm", f"{LM_DENSE}: prefill {d['prefill_tok_s']:.1f} tokens/s, decode "
           f"{d['decode_bfloat16']['tok_s']:.1f} (bfloat16 cache) / {d['decode_int8']['tok_s']:.1f} "
           f"(int8) tokens/s, busy share prefill {d['prefill_busy']} decode {d['decode_busy']}; "
           f"{LM_SSM}: prefill {lm['ssm']['prefill_tok_s']:.1f}, decode "
           f"{lm['ssm']['decode_tok_s']:.1f} tokens/s, busy share prefill "
           f"{lm['ssm']['prefill_busy']} decode {lm['ssm']['decode_busy']}; "
           f"{LM_MOE} layer {lm['moe']['ms']:.3f} ms [{smi}]")
    f = lm_train["full"]
    _phase("lm_train", f"{LM_DENSE} ITP-AdamW training at B={LM_TRAIN[0]} x S={LM_TRAIN[1]}: "
           f"{f['step_ms']:.2f} ms a step, {f['tok_s']:.1f} tokens/s, peak {f['peak_gb']:.3f} "
           f"GB, busy share {f['busy']} [{smi}]")
    a = lm_sharded["fsdp"]
    _phase("lm_sharded", f"{LM_DENSE} on a 1 x 1 mesh at B={LM_TRAIN[0]} x S={LM_TRAIN[1]}: "
           f"{statistics.median(a['walls']) * 1e3:.2f} ms a step tensor-parallel, "
           f"{statistics.median(a['gather_on_use']['walls']) * 1e3:.2f} ms gathered on use, "
           f"{statistics.median(a['unsharded']['walls']) * 1e3:.2f} ms unsharded, peak "
           f"{a['peak_gb']:.3f} / {a['gather_on_use']['peak_gb']:.3f} / "
           f"{a['unsharded']['peak_gb']:.3f} GB, busy share {a['busy']}, "
           f"{lm_sharded['dryrun']['tflops_sharded']:.2f} TFLOP/s by the dry run's count [{smi}]")

    line = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": k["max_abs_err"], "ms": k["ms"], "plain_ms": k["plain_ms"],
         "bound_ms": k["bound_ms"], "bound_by": k["bound_by"], "library_ms": None,
         "device_ms": k["device_ms"], "shape": k["shape"],
         **{key: k[key] for key in ("launches_by_shape", "host_us", "element_pairs", "layers")
            if key in k}}
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
