"""The port's CUDA kernels, and the SNN stack that runs them, on the card
(marked ``gpu``; they skip without a CUDA device).  This file imports torch
only, so it runs on a GPU machine without JAX:
``python -m pytest -m gpu tests/test_torch_gpu.py``.

The kernels are held against their plain PyTorch versions on the same card
bit for bit: the dense kernels' plain versions sum in the kernel's order and
round after every operation, as the kernels do; the conv kernels and their
plain versions both take exact float64 sums and round once.  The counter
kernels' exact window takes a double ``exp`` on each side (the kernel's and
PyTorch's), held within rtol=atol=1e-6 (the reference's window tolerance);
the linear and imstdp windows bit for bit; the counter conv delta at depth
255, whose window values span more binades than a double's spare bits,
within the conv tolerance.  The side kernels (the fused LIF step, the LLSMU
multiplier, the po2 encoder and decoder) compute the same integers or the
same float32 roundings as their plain versions and are held bit for bit."""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.core import lif as TL
from repro_torch.core.engine import EngineConfig
from repro_torch.core.history import pack_bitplanes, unpack_words
from repro_torch.core.stdp import STDPParams
from repro_torch.kernels.itp_counter import kernel as NK
from repro_torch.kernels.itp_counter import ref as NR
from repro_torch.kernels.itp_counter.ops import counter_lut
from repro_torch.kernels.itp_stdp import kernel as K
from repro_torch.kernels.itp_stdp import ref as R
from repro_torch.kernels.itp_stdp.ops import po2_vectors
from repro_torch.kernels.itp_stdp_conv import kernel as CK
from repro_torch.kernels.itp_stdp_conv import ref as CR
from repro_torch.kernels.lif import kernel as LK
from repro_torch.kernels.lif.ops import lif_step_kernel
from repro_torch.kernels.lif.ref import lif_update_ref
from repro_torch.kernels.llsmu import kernel as MK
from repro_torch.kernels.llsmu.ops import llsmu
from repro_torch.kernels.llsmu.ref import llsmu_multiply_ref
from repro_torch.kernels.po2_quant import kernel as PK
from repro_torch.kernels.po2_quant import ref as PR
from repro_torch.kernels.po2_quant.ops import po2_quantize
from repro_torch.models import snn as TS
from repro_torch.serve import Request, ServeConfig, Server
from repro_torch.train import optimizer as OPT
from repro_torch.tree import tree_leaves

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(lanes, n_pre, n_post, depth, seed, device):
    g = torch.Generator().manual_seed(seed)
    words = [torch.randint(0, 256, (lanes, n), generator=g, dtype=torch.uint8)
             for n in (n_pre, n_post)]
    x = dict(w=torch.rand((lanes, n_pre, n_post), generator=g),
             pre_s=(torch.rand((lanes, n_pre), generator=g) < 0.3).float(),
             post_s=(torch.rand((lanes, n_post), generator=g) < 0.3).float(),
             pre_w=words[0], post_w=words[1])
    x = {k: v.to(device) for k, v in x.items()}
    x["pre_b"], x["post_b"] = (unpack_words(x[k], depth).transpose(-1, -2).float().contiguous()
                               for k in ("pre_w", "post_w"))
    return x


# serving's 8 sessions, the paper nets' fc layers at batch 16 (2layer-snn,
# DCSNN, CSNN; the batch is the lane axis), ragged and odd widths
DENSE_SHAPES = ((2, 200, 72), (8, 784, 100), (1, 33, 5), (16, 784, 100), (16, 600, 128),
                (16, 480, 64))


@pytest.mark.parametrize("shape", DENSE_SHAPES)
@pytest.mark.parametrize("depth", (1, 7, 8))
def test_kernels_bit_equal_to_plain_versions(cuda, shape, depth):
    x = _inputs(*shape, depth, seed=depth, device=cuda)
    po2 = po2_vectors(STDPParams(), depth, device=cuda)
    for nearest in (True, False):
        kw = dict(nearest=nearest, eta=0.3, w_min=0.0, w_max=1.0)
        packed = K.itp_stdp_update_packed(x["w"], x["pre_s"], x["post_s"], x["pre_w"],
                                          x["post_w"], *po2, depth=depth, **kw)
        unpacked = K.itp_stdp_update(x["w"], x["pre_s"], x["post_s"], x["pre_b"],
                                     x["post_b"], *po2, **kw)
        plain = R.itp_stdp_update_packed_ref(x["w"], x["pre_s"], x["post_s"], x["pre_w"],
                                             x["post_w"], *po2, depth=depth, **kw)
        torch.cuda.synchronize()
        assert torch.equal(packed, plain)
        assert torch.equal(unpacked, plain)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x = _inputs(1, 16, 8, 7, seed=0, device=cuda)
    po2 = po2_vectors(STDPParams(), 7, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        K.itp_stdp_update_packed(x["w"].double(), x["pre_s"], x["post_s"], x["pre_w"],
                                 x["post_w"], *po2, depth=7)
    with pytest.raises(ValueError, match="is on cpu"):
        K.itp_stdp_update_packed(x["w"], x["pre_s"].cpu(), x["post_s"], x["pre_w"],
                                 x["post_w"], *po2, depth=7)
    with pytest.raises(ValueError, match="shape"):
        K.itp_stdp_update_packed(x["w"], x["pre_s"][:, :-1], x["post_s"], x["pre_w"],
                                 x["post_w"], *po2, depth=7)


def _dense_calls(x, depth, po2, lut, kw):
    """Kernel 1, 2 and 5 (each window) on one set of inputs: name -> (kernel
    call, plain call, exact-window tolerance or None)."""
    args = (x["w"], x["pre_s"], x["post_s"])
    calls = {
        "itp_stdp_update_packed": (
            lambda: K.itp_stdp_update_packed(*args, x["pre_w"], x["post_w"], *po2, depth=depth,
                                             **kw),
            lambda: R.itp_stdp_update_packed_ref(*args, x["pre_w"], x["post_w"], *po2,
                                                 depth=depth, **kw), None),
        "itp_stdp_update": (
            lambda: K.itp_stdp_update(*args, x["pre_b"], x["post_b"], *po2, **kw),
            lambda: R.itp_stdp_update_ref(*args, x["pre_b"], x["post_b"], *po2, **kw), None),
    }
    for window in WINDOWS:
        ckw = dict(_counter_kw(depth, window), **kw)
        del ckw["nearest"]
        calls[f"counter_stdp_update[{window}]"] = (
            lambda ckw=ckw: NK.counter_stdp_update(*args, x["pre_t"], x["post_t"], lut, **ckw),
            lambda ckw=ckw: NR.counter_stdp_update_ref(*args, x["pre_t"], x["post_t"], lut=lut,
                                                       **ckw),
            WINDOW_TOL if window == "exact" else None)
    return calls


def _dense_inputs(lanes, n_pre, n_post, depth, seed, device, *, offset=0):
    """``_inputs`` plus counter words; with ``offset``, ``w`` is a contiguous
    view ``offset`` floats into its storage (not 16-byte aligned)."""
    x = _inputs(lanes, n_pre, n_post, depth, seed, device)
    g = torch.Generator().manual_seed(seed + 1)
    x["pre_t"] = _counters((lanes, n_pre), depth, g).to(device)
    x["post_t"] = _counters((lanes, n_post), depth, g).to(device)
    if offset:
        flat = torch.empty(offset + x["w"].numel(), device=device)
        x["w"] = flat[offset:].view(x["w"].shape).copy_(x["w"])
    return x


# w not 16-byte aligned (a view one float into its storage), n_post not a
# multiple of 4 (the masked 4-byte path), rows longer than one strip's
# columns (2,048: column blocks), one column (many rows a strip), and more
# lanes than a grid's y or z could hold
DENSE_EDGES = (((8, 784, 100), 1), ((3, 257, 101), 0), ((2, 5, 4100), 0), ((1, 3000, 1), 0),
               ((70000, 2, 4), 0), ((2, 130, 70), 1))


@pytest.mark.parametrize("shape,offset", DENSE_EDGES)
def test_dense_kernels_take_unaligned_and_odd_shapes(cuda, shape, offset):
    x = _dense_inputs(*shape, 7, seed=shape[2], device=cuda, offset=offset)
    assert x["w"].data_ptr() % 16 == (4 * offset) % 16
    po2 = po2_vectors(STDPParams(), 7, device=cuda)
    lut = counter_lut(STDPParams(), 7, cuda)
    for name, (kern, plain, tol) in _dense_calls(x, 7, po2, lut,
                                                 dict(nearest=True, eta=0.3)).items():
        out, ref = kern(), plain()
        torch.cuda.synchronize()
        assert out.shape == shape, name
        if tol is None:
            assert torch.equal(out, ref), name
        else:
            torch.testing.assert_close(out, ref, **tol)
        assert not torch.equal(out, x["w"]), name


def test_dense_kernels_on_two_streams_at_once(cuda):
    """Two streams launch kernels 1, 2 and 5 in turns on different inputs;
    every result equals its plain version."""
    xs = [_dense_inputs(16, 784, 100, 7, seed=s, device=cuda) for s in (3, 4)]
    po2 = po2_vectors(STDPParams(), 7, device=cuda)
    lut = counter_lut(STDPParams(), 7, cuda)
    calls = [_dense_calls(x, 7, po2, lut, dict(nearest=True, eta=0.3)) for x in xs]
    streams = [torch.cuda.Stream() for _ in xs]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    outs = [{name: [] for name in calls[0]} for _ in xs]
    for _ in range(10):
        for c, s, out in zip(calls, streams, outs):
            with torch.cuda.stream(s):
                for name, (kern, _, _) in c.items():
                    out[name].append(kern())
    torch.cuda.synchronize()
    for c, out in zip(calls, outs):
        for name, (_, plain, tol) in c.items():
            ref = plain()
            for o in out[name]:
                if tol is None:
                    assert torch.equal(o, ref), name
                else:
                    torch.testing.assert_close(o, ref, **tol)
    assert not torch.equal(outs[0]["itp_stdp_update"][0], outs[1]["itp_stdp_update"][0])


def test_dense_update_is_one_kernel_launch_per_call(cuda):
    """The profiler sees one kernel per wrapper call of kernels 1, 2 and 5
    and no other kernel, memset or copy."""
    from torch.profiler import ProfilerActivity, profile

    x = _dense_inputs(16, 784, 100, 7, seed=5, device=cuda)
    po2 = po2_vectors(STDPParams(), 7, device=cuda)
    lut = counter_lut(STDPParams(), 7, cuda)
    calls = _dense_calls(x, 7, po2, lut, dict(nearest=True, eta=0.3))
    n = 10
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            for kern, _, _ in calls.values():
                kern()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == len(calls) * n
    assert sum("itp_stdp_kernel<true" in k for k in names) == n
    assert sum("itp_stdp_kernel<false" in k for k in names) == n
    assert sum("counter_stdp_kernel" in k for k in names) == 3 * n


def test_fused_serving_on_card_matches_reference(cuda):
    cfg = EngineConfig(n_pre=64, n_post=16, backend="fused")
    scfg = ServeConfig(max_batch=4, t_steps=8, theta_plus=0.05)
    rng = np.random.default_rng(0)
    load = [Request(f"u{i % 3}", (rng.random((8, 64)) < 0.05).astype(np.float32))
            for i in range(7)]
    results = {}
    for backend in ("fused", "reference"):
        server = Server(dataclasses.replace(cfg, backend=backend), scfg, device=cuda)
        K.itp_stdp_update_packed.launches = 0
        tickets = [server.submit(r) for r in load]
        server.drain()
        if backend == "fused":
            assert K.itp_stdp_update_packed.launches == server.batches * scfg.t_steps > 0
        results[backend] = (server, [server.poll(t) for t in tickets])
    (fs, fr), (rs, rr) = results["fused"], results["reference"]
    for a, b in zip(fr, rr):
        np.testing.assert_array_equal(a.post, b.post)
    for sid in fs.store.session_ids:
        a, b = fs.store.peek(sid), rs.store.peek(sid)
        assert all(torch.equal(p, q) for p, q in zip((*a.pre_words, *a.post_words),
                                                     (*b.pre_words, *b.post_words)))
        torch.testing.assert_close(a.w, b.w, rtol=1e-5, atol=1e-6)


# --- im2col conv delta (kernels 3-4) ---------------------------------------

# the reference's own kernel-vs-oracle tolerance; both sides sum exactly in
# float64, so they are also held bit-equal
CONV_TOL = dict(atol=1e-4, rtol=1e-5)


def _conv_inputs(m, kk, cc, depth, seed, device):
    g = torch.Generator().manual_seed(seed)
    x = dict(pre=(torch.rand((m, kk), generator=g) < 0.3).float(),
             post=(torch.rand((m, cc), generator=g) < 0.25).float(),
             pre_b=(torch.rand((depth, m, kk), generator=g) < 0.3).float(),
             post_b=(torch.rand((depth, m, cc), generator=g) < 0.25).float())
    x = {k: v.to(device) for k, v in x.items()}
    x["pre_w"], x["post_w"] = pack_bitplanes(x["pre_b"]), pack_bitplanes(x["post_b"])
    return x


# the paper nets' conv layers at batch 16, plus ragged and single-row shapes;
# M one below, at and one above a block's least row share (8 rows); DCSNN
# conv1 at batch 256, far above the nets' own M; an output tile larger than
# one block's (K x C = 25,600 outputs, 64 x 64 a block)
CONV_SHAPES = ((9216, 25, 12), (1600, 108, 24), (4048, 14, 8), (976, 40, 16), (257, 33, 9),
               (1, 20, 16), (0, 5, 3), (7, 25, 12), (8, 25, 12), (9, 25, 12),
               (147456, 25, 12), (2048, 400, 64))


@pytest.mark.parametrize("shape", CONV_SHAPES)
@pytest.mark.parametrize("depth", (1, 7, 8))
def test_conv_kernels_match_plain_versions(cuda, shape, depth):
    x = _conv_inputs(*shape, depth, seed=depth, device=cuda)
    po2 = po2_vectors(STDPParams(), depth, device=cuda)
    for nearest in (True, False):
        packed = CK.itp_stdp_conv_delta_packed(x["pre"], x["post"], x["pre_w"], x["post_w"],
                                               *po2, depth=depth, nearest=nearest)
        unpacked = CK.itp_stdp_conv_delta(x["pre"], x["post"], x["pre_b"], x["post_b"],
                                          *po2, nearest=nearest)
        again = CK.itp_stdp_conv_delta_packed(x["pre"], x["post"], x["pre_w"], x["post_w"],
                                              *po2, depth=depth, nearest=nearest)
        plain = CR.itp_stdp_conv_delta_ref(x["pre"], x["post"], x["pre_b"], x["post_b"],
                                           *po2, nearest=nearest)
        torch.cuda.synchronize()
        assert packed.shape == (shape[1], shape[2])
        assert torch.equal(packed, unpacked)
        assert torch.equal(packed, again)
        torch.testing.assert_close(packed, plain, **CONV_TOL)
        assert torch.equal(packed, plain)


# shapes the staging of every row's full K and C columns refused: bitplanes
# at depth 16 and 64 on DCSNN conv2, a wide (K + C ~ 1,000) shape at depth 8,
# a depth-chunk remainder on a wide shape, and words at K + C above 5,000
WIDE_DEEP = (((1600, 108, 24), 16), ((1600, 108, 24), 64), ((512, 900, 100), 8),
             ((64, 2100, 40), 33), ((256, 4800, 300), 7))


@pytest.mark.parametrize("shape,depth", WIDE_DEEP)
def test_conv_kernels_take_wide_and_deep_shapes(cuda, shape, depth):
    m, kk, cc = shape
    g = torch.Generator().manual_seed(depth)
    x = dict(pre=(torch.rand((m, kk), generator=g) < 0.3).float(),
             post=(torch.rand((m, cc), generator=g) < 0.25).float(),
             pre_b=(torch.rand((depth, m, kk), generator=g) < 0.3).float(),
             post_b=(torch.rand((depth, m, cc), generator=g) < 0.25).float())
    x = {k: v.to(cuda) for k, v in x.items()}
    po2 = po2_vectors(STDPParams(), depth, device=cuda)
    for nearest in (True, False):
        outs = [CK.itp_stdp_conv_delta(x["pre"], x["post"], x["pre_b"], x["post_b"], *po2,
                                       nearest=nearest)]
        if depth <= 8:
            outs.append(CK.itp_stdp_conv_delta_packed(
                x["pre"], x["post"], pack_bitplanes(x["pre_b"]), pack_bitplanes(x["post_b"]),
                *po2, depth=depth, nearest=nearest))
        plain = CR.itp_stdp_conv_delta_ref(x["pre"], x["post"], x["pre_b"], x["post_b"], *po2,
                                           nearest=nearest)
        torch.cuda.synchronize()
        for out in outs:
            assert out.shape == (kk, cc)
            torch.testing.assert_close(out, plain, **CONV_TOL)
            assert torch.equal(out, plain)


def test_conv_kernel_counts_launches_and_rejects_bad_operands(cuda):
    x = _conv_inputs(64, 25, 12, 7, seed=0, device=cuda)
    po2 = po2_vectors(STDPParams(), 7, device=cuda)
    CK.itp_stdp_conv_delta_packed.launches = 0
    CK.itp_stdp_conv_delta_packed(x["pre"], x["post"], x["pre_w"], x["post_w"], *po2, depth=7)
    assert CK.itp_stdp_conv_delta_packed.launches == 1
    with pytest.raises(TypeError, match="uint8"):
        CK.itp_stdp_conv_delta_packed(x["pre"], x["post"], x["pre_b"][0], x["post_w"],
                                      *po2, depth=7)
    with pytest.raises(ValueError, match="is on cpu"):
        CK.itp_stdp_conv_delta_packed(x["pre"], x["post"].cpu(), x["pre_w"], x["post_w"],
                                      *po2, depth=7)
    with pytest.raises(ValueError, match="shape"):
        CK.itp_stdp_conv_delta(x["pre"], x["post"], x["pre_b"][:, :-1], x["post_b"], *po2)
    assert CK.itp_stdp_conv_delta_packed.launches == 1


def test_conv_kernel_on_two_streams_at_once(cuda):
    """Two streams launch kernel 3 in turns on different inputs; each call
    has its own scratch, so both results equal their plain versions."""
    xs = [_conv_inputs(9216, 25, 12, 7, seed=s, device=cuda) for s in (3, 4)]
    po2 = po2_vectors(STDPParams(), 7, device=cuda)
    streams = [torch.cuda.Stream() for _ in xs]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    outs = [[], []]
    for _ in range(20):
        for x, s, out in zip(xs, streams, outs):
            with torch.cuda.stream(s):
                out.append(CK.itp_stdp_conv_delta_packed(x["pre"], x["post"], x["pre_w"],
                                                         x["post_w"], *po2, depth=7))
    torch.cuda.synchronize()
    for x, out in zip(xs, outs):
        plain = CR.itp_stdp_conv_delta_ref(x["pre"], x["post"], x["pre_b"], x["post_b"], *po2)
        assert all(torch.equal(o, plain) for o in out)
    assert not torch.equal(outs[0][0], outs[1][0])


def test_conv_delta_is_one_kernel_launch_per_call(cuda):
    """The profiler sees one conv-delta kernel per wrapper call (kernels 3,
    4 and 6) and no other kernel, memset or copy."""
    from torch.profiler import ProfilerActivity, profile

    x = _conv_inputs(9216, 25, 12, 7, seed=5, device=cuda)
    po2 = po2_vectors(STDPParams(), 7, device=cuda)
    g = torch.Generator().manual_seed(5)
    words = [_counters(t.shape, 7, g).to(cuda) for t in (x["pre"], x["post"])]
    lut = counter_lut(STDPParams(), 7, cuda)
    calls = 10
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            CK.itp_stdp_conv_delta_packed(x["pre"], x["post"], x["pre_w"], x["post_w"], *po2,
                                          depth=7)
            CK.itp_stdp_conv_delta(x["pre"], x["post"], x["pre_b"], x["post_b"], *po2)
            NK.counter_conv_delta(x["pre"], x["post"], *words, lut, **_counter_kw(7, "exact"))
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 3 * calls
    assert sum("itp_conv_delta_kernel<true," in n for n in names) == calls
    assert sum("itp_conv_delta_kernel<false," in n for n in names) == calls
    assert sum("counter_conv_delta_kernel" in n for n in names) == calls


# --- the SNN stack on the card ---------------------------------------------


def test_hard_wta_tie_keeps_the_first_index_on_card(cuda):
    cfg = TS.SNNConfig(name="wta", input_shape=(6,),
                       layers=(TS.SNNLayerSpec("fc", out_features=4),), hard_wta=True,
                       gain=1.0, lif=TS.LIFParams(tau=2.0, v_th=0.1))
    w = torch.zeros((6, 4))
    w[:, 0], w[:, 1], w[:, 2] = 0.3, 0.5, 0.5
    st = TS.init_snn(cfg, 2, w_init=[w], device=cuda)
    _, counts = TS.run_snn(st, torch.ones((1, 2, 6), dtype=torch.uint8), cfg, train=False)
    assert counts.cpu().tolist() == [[0, 1, 0, 0], [0, 1, 0, 0]]


@pytest.mark.parametrize("net", ("6layer-dcsnn", "5layer-csnn"))
def test_conv_net_on_card_fused_bit_identical_to_reference(cuda, net):
    """Kernel and reference deltas are both exact float64 sums rounded once,
    so the whole trajectory agrees bit for bit; every conv layer launches
    its kernel once per step, and so does the fc layer (its batch sum is the
    same contraction), which launches no dense kernel."""
    cfg = TS.PAPER_NETWORKS[net](backend="fused", quantise=False)
    t_steps = 16
    g = torch.Generator().manual_seed(0)
    raster = (torch.rand((t_steps, 4, int(np.prod(cfg.input_shape))), generator=g) < 0.3)
    raster = raster.to(torch.uint8).to(cuda)
    runs = {}
    for backend, packed in (("fused", True), ("fused", False), ("reference", True)):
        run_cfg = dataclasses.replace(cfg, backend=backend, packed_history=packed)
        st = TS.init_snn(run_cfg, 4, generator=torch.Generator().manual_seed(1), device=cuda)
        CK.itp_stdp_conv_delta_packed.launches = 0
        K.itp_stdp_update_packed.launches = 0
        runs[(backend, packed)] = TS.run_snn(st, raster, run_cfg)
        if (backend, packed) == ("fused", True):
            assert CK.itp_stdp_conv_delta_packed.launches == 3 * t_steps
            assert K.itp_stdp_update_packed.launches == 0
    (sp, cp), (su, cu), (sr, cr) = runs.values()
    assert cp.sum() > 0
    assert torch.equal(cp, cu) and torch.equal(cp, cr)
    for a, b, c in zip(sp.weights, su.weights, sr.weights):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("shape", ((256, 784, 6400), (2048, 600, 128)),
                         ids=("snn6400-b256", "dcsnn-fc-b2048"))
@pytest.mark.parametrize("depth", (7, 12), ids=("words-depth7", "bitplanes-depth12"))
@pytest.mark.parametrize("rule", ("itp", "itp_nocomp"))
def test_plan_fc_delta_sums_the_batch_in_the_conv_kernel(cuda, rule, depth, shape):
    """The history rules' fc delta is one conv-kernel launch with the batch
    as its rows, bit-equal to the per-lane path it replaced (kernel 1 or 2
    over the lanes, summed in float64 and rounded once), with no host sync
    and no dense-kernel launch; at 784 x 6,400 the plan takes the direct
    store (more output tiles than blocks), at the DCSNN's fc it splits the
    batch."""
    from repro_torch import plasticity

    B, n_in, n_out = shape
    cfg = TS.SNNConfig(name="fc", input_shape=(n_in,),
                       layers=(TS.SNNLayerSpec("fc", out_features=n_out),),
                       backend="fused", rule=rule, depth=depth)
    plan = plasticity.make_plan(cfg, cuda)
    r = plan.rule
    g = torch.Generator().manual_seed(B + depth)

    def state(n):
        st = r.init_state(n, depth, device=cuda)
        for _ in range(depth + 2):
            st = r.step(st, (torch.rand(n, generator=g) < 0.2).to(torch.uint8).to(cuda),
                        depth=depth)
        return st

    pre_st, post_st = state(B * n_in), state(B * n_out)
    s_in = (torch.rand((B, n_in), generator=g) < 0.2).float().to(cuda)
    s_out = (torch.rand((B, n_out), generator=g) < 0.2).float().to(cuda)
    pre_read = r.kernel_view(pre_st, packed=plan.packed)
    post_read = r.kernel_view(post_st, packed=plan.packed)
    words = pre_read.dim() == 1
    assert words == (depth <= 8)
    if words:
        pre_read, post_read = pre_read.reshape(B, -1), post_read.reshape(B, -1)
    else:
        pre_read = pre_read.reshape(depth, B, -1).transpose(0, 1)
        post_read = post_read.reshape(depth, B, -1).transpose(0, 1)
    lanes = r.fused_delta(s_in, s_out, pre_read, post_read, plan.stdp, packed=words,
                          depth=depth, pairing=plan.pairing, compensate=plan.compensate,
                          interpret=False, po2=plan.po2, table=plan.table)
    want = lanes.sum(dim=0, dtype=torch.float64).to(torch.float32)
    del lanes
    wrapper = CK.itp_stdp_conv_delta_packed if words else CK.itp_stdp_conv_delta
    plan.fc_delta(pre_st, post_st, s_in, s_out)             # warm: build, caches
    torch.cuda.synchronize()
    wrapper.launches = wrapper.direct_launches = 0
    K.itp_stdp_update_packed.launches = K.itp_stdp_update.launches = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = plan.fc_delta(pre_st, post_st, s_in, s_out)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert wrapper.launches == 1
    assert wrapper.direct_launches == (1 if n_out == 6400 else 0)
    assert K.itp_stdp_update_packed.launches == K.itp_stdp_update.launches == 0
    assert want.abs().max() > 0 and torch.equal(got, want)


def test_deep_history_dcsnn_fused_step_equals_reference(cuda):
    """``itp`` at depth 64 runs unpacked (kernel 4, the fc layer's batch sum
    too): the DCSNN trains a few steps on the fused backend bit-identical to
    the reference."""
    cfg = TS.PAPER_NETWORKS["6layer-dcsnn"](backend="fused", quantise=False, depth=64)
    t_steps = 16
    g = torch.Generator().manual_seed(0)
    raster = (torch.rand((t_steps, 4, int(np.prod(cfg.input_shape))), generator=g) < 0.3)
    raster = raster.to(torch.uint8).to(cuda)
    runs = {}
    for backend in ("fused", "reference"):
        run_cfg = dataclasses.replace(cfg, backend=backend)
        st = TS.init_snn(run_cfg, 4, generator=torch.Generator().manual_seed(1), device=cuda)
        CK.itp_stdp_conv_delta.launches = 0
        K.itp_stdp_update.launches = 0
        runs[backend] = TS.run_snn(st, raster, run_cfg)
        if backend == "fused":
            assert CK.itp_stdp_conv_delta.launches == 3 * t_steps
            assert K.itp_stdp_update.launches == 0
    (sf, cf), (sr, cr) = runs["fused"], runs["reference"]
    assert cf.sum() > 0 and torch.equal(cf, cr)
    for a, b in zip(sf.weights, sr.weights):
        assert torch.equal(a, b)


# --- counter rules: fused update and conv delta (kernels 5-6) --------------

WINDOWS = ("exact", "linear", "imstdp")
WINDOW_TOL = dict(rtol=1e-6, atol=1e-6)


def _counter_kw(depth, window):
    p = STDPParams()
    return dict(depth=depth, window=window, a_plus=p.a_plus, a_minus=p.a_minus,
                tau_plus=p.tau_plus, tau_minus=p.tau_minus)


def _counters(shape, depth, g):
    return torch.randint(0, depth + 1, shape, generator=g).to(torch.uint8)


@pytest.mark.parametrize("shape", ((8, 784, 100), (16, 600, 128), (2, 130, 70), (1, 33, 5),
                                   (16, 480, 64)))
@pytest.mark.parametrize("depth", (1, 7, 8, 255))
@pytest.mark.parametrize("window", WINDOWS)
def test_counter_kernel_matches_plain_version(cuda, shape, depth, window):
    lanes, n_pre, n_post = shape
    g = torch.Generator().manual_seed(depth)
    w = torch.rand(shape, generator=g)
    pre_s = (torch.rand((lanes, n_pre), generator=g) < 0.3).float()
    post_s = (torch.rand((lanes, n_post), generator=g) < 0.3).float()
    pre_t, post_t = _counters((lanes, n_pre), depth, g), _counters((lanes, n_post), depth, g)
    w, pre_s, post_s, pre_t, post_t = (x.to(cuda) for x in (w, pre_s, post_s, pre_t, post_t))
    lut = counter_lut(STDPParams(), depth, cuda)
    kw = dict(_counter_kw(depth, window), eta=0.3, w_min=0.0, w_max=1.0)
    out = NK.counter_stdp_update(w, pre_s, post_s, pre_t, post_t, lut, **kw)
    again = NK.counter_stdp_update(w, pre_s, post_s, pre_t, post_t, lut, **kw)
    plain = NR.counter_stdp_update_ref(w, pre_s, post_s, pre_t, post_t, lut=lut, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    if depth in (7, 8):
        assert not torch.equal(out, w)
    if window == "exact":
        torch.testing.assert_close(out, plain, **WINDOW_TOL)
    else:
        assert torch.equal(out, plain)


@pytest.mark.parametrize("shape", CONV_SHAPES)
@pytest.mark.parametrize("depth", (7, 255))
@pytest.mark.parametrize("window", WINDOWS)
def test_counter_conv_kernel_matches_plain_version(cuda, shape, depth, window):
    m, kk, cc = shape
    g = torch.Generator().manual_seed(depth)
    pre = (torch.rand((m, kk), generator=g) < 0.3).float().to(cuda)
    post = (torch.rand((m, cc), generator=g) < 0.25).float().to(cuda)
    pre_t, post_t = _counters((m, kk), depth, g).to(cuda), _counters((m, cc), depth, g).to(cuda)
    lut = counter_lut(STDPParams(), depth, cuda)
    kw = _counter_kw(depth, window)
    out = NK.counter_conv_delta(pre, post, pre_t, post_t, lut, **kw)
    again = NK.counter_conv_delta(pre, post, pre_t, post_t, lut, **kw)
    plain = NR.counter_conv_delta_ref(pre, post, pre_t, post_t, lut=lut, **kw)
    torch.cuda.synchronize()
    assert out.shape == (kk, cc)
    assert torch.equal(out, again)
    torch.testing.assert_close(out, plain, **CONV_TOL)
    if depth == 7 and window != "exact":    # few binades: both sums exact
        assert torch.equal(out, plain)


@pytest.mark.parametrize("depth,window", ((7, "exact"), (7, "linear"), (7, "imstdp"),
                                          (255, "exact")))
def test_counter_conv_kernel_takes_wide_shapes(cuda, depth, window):
    """K + C above 5,000 counter words, which the staging of full rows refused."""
    m, kk, cc = 256, 4800, 300
    g = torch.Generator().manual_seed(depth)
    pre = (torch.rand((m, kk), generator=g) < 0.3).float().to(cuda)
    post = (torch.rand((m, cc), generator=g) < 0.25).float().to(cuda)
    pre_t, post_t = _counters((m, kk), depth, g).to(cuda), _counters((m, cc), depth, g).to(cuda)
    lut = counter_lut(STDPParams(), depth, cuda)
    kw = _counter_kw(depth, window)
    out = NK.counter_conv_delta(pre, post, pre_t, post_t, lut, **kw)
    plain = NR.counter_conv_delta_ref(pre, post, pre_t, post_t, lut=lut, **kw)
    torch.cuda.synchronize()
    assert out.shape == (kk, cc)
    torch.testing.assert_close(out, plain, **CONV_TOL)
    if depth == 7 and window != "exact":
        assert torch.equal(out, plain)


def test_counter_kernels_count_launches_and_reject_bad_operands(cuda):
    g = torch.Generator().manual_seed(0)
    w = torch.rand((2, 16, 8), generator=g).to(cuda)
    s_pre, s_post = torch.ones((2, 16), device=cuda), torch.zeros((2, 8), device=cuda)
    t_pre, t_post = _counters((2, 16), 7, g).to(cuda), _counters((2, 8), 7, g).to(cuda)
    lut = counter_lut(STDPParams(), 7, cuda)
    kw = _counter_kw(7, "imstdp")
    NK.counter_stdp_update.launches = 0
    NK.counter_conv_delta.launches = 0
    NK.counter_stdp_update(w, s_pre, s_post, t_pre, t_post, lut, **kw)
    NK.counter_conv_delta(s_pre, s_post, t_pre, t_post, lut, **kw)
    assert (NK.counter_stdp_update.launches, NK.counter_conv_delta.launches) == (1, 1)
    with pytest.raises(TypeError, match="uint8"):
        NK.counter_stdp_update(w, s_pre, s_post, t_pre.float(), t_post, lut, **kw)
    with pytest.raises(ValueError, match="is on cpu"):
        NK.counter_conv_delta(s_pre, s_post.cpu(), t_pre, t_post, lut, **kw)
    with pytest.raises(ValueError, match="shape"):
        NK.counter_stdp_update(w, s_pre, s_post, t_pre, t_post, lut[:, :3], **kw)
    with pytest.raises(ValueError, match="depth"):
        NK.counter_conv_delta(s_pre, s_post, t_pre, t_post,
                              counter_lut(STDPParams(), 300, cuda), **dict(kw, depth=300))
    assert (NK.counter_stdp_update.launches, NK.counter_conv_delta.launches) == (1, 1)


@pytest.mark.parametrize("shape", ((256, 784, 6400), (16, 784, 100), (16, 600, 128)),
                         ids=("snn6400-b256", "2layer-snn-fc-b16", "dcsnn-fc-b16"))
@pytest.mark.parametrize("depth", (7, 255))
@pytest.mark.parametrize("window", WINDOWS)
def test_counter_fc_delta_sums_kernel5_lanes(cuda, shape, depth, window):
    """The counter fc kernel against the per-lane path it replaced: kernel 5
    on a zero ``w`` (eta 1, no clip) over the B lanes, summed in float64 and
    rounded once.  Bit-equal at depth 7 (both sums exact); at depth 255 equal
    run to run and within the conv tolerance.  One launch a call, no host
    sync, and nothing allocated but the ``(n_pre, n_post)`` output, which the
    caching allocator rounds up by at most 2 MiB (at the benchmark's B = 256
    under 1 % of the per-lane array's bytes)."""
    lanes, n_pre, n_post = shape
    g = torch.Generator().manual_seed(lanes + depth)
    pre_s = (torch.rand((lanes, n_pre), generator=g) < 0.2).float().to(cuda)
    post_s = (torch.rand((lanes, n_post), generator=g) < 0.2).float().to(cuda)
    pre_t = _counters((lanes, n_pre), depth, g).to(cuda)
    post_t = _counters((lanes, n_post), depth, g).to(cuda)
    lut = counter_lut(STDPParams(), depth, cuda)
    kw = _counter_kw(depth, window)
    lanes_dw = NK.counter_stdp_update(
        torch.zeros(shape, device=cuda), pre_s, post_s, pre_t, post_t, lut, **kw, eta=1.0,
        w_min=float("-inf"), w_max=float("inf"))
    want = lanes_dw.sum(dim=0, dtype=torch.float64).to(torch.float32)
    del lanes_dw
    args = (pre_s, post_s, pre_t, post_t, lut)
    NK.counter_fc_delta(*args, **kw)                       # warm: build, load
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda)
    before = torch.cuda.memory_allocated(cuda)
    NK.counter_fc_delta.launches = NK.counter_stdp_update.launches = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = NK.counter_fc_delta(*args, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated(cuda) - before
    again = NK.counter_fc_delta(*args, **kw)
    assert NK.counter_fc_delta.launches == 2 and NK.counter_stdp_update.launches == 0
    assert got.shape == (n_pre, n_post) and got.dtype == torch.float32
    assert grown <= got.numel() * 4 + (2 << 20)   # the output in the allocator's blocks
    if lanes == 256:
        assert grown < 0.01 * lanes * n_pre * n_post * 4
    assert want.abs().max() > 0 and torch.equal(got, again)
    if depth == 7:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, **CONV_TOL)


def test_counter_fc_delta_is_one_kernel_launch_per_call(cuda):
    """The profiler sees one counter fc kernel per wrapper call and no other
    kernel, memset or copy; a batch of none gives zeros."""
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator().manual_seed(9)
    pre_s = (torch.rand((16, 784), generator=g) < 0.3).float().to(cuda)
    post_s = (torch.rand((16, 100), generator=g) < 0.3).float().to(cuda)
    words = [_counters(t.shape, 7, g).to(cuda) for t in (pre_s, post_s)]
    lut = counter_lut(STDPParams(), 7, cuda)
    calls = 10
    for window in WINDOWS:
        NK.counter_fc_delta(pre_s, post_s, *words, lut, **_counter_kw(7, window))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            for window in WINDOWS:
                NK.counter_fc_delta(pre_s, post_s, *words, lut, **_counter_kw(7, window))
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 3 * calls
    assert sum("counter_fc_delta_kernel" in n for n in names) == 3 * calls
    empty = NK.counter_fc_delta(pre_s[:0], post_s[:0], words[0][:0], words[1][:0], lut,
                                **_counter_kw(7, "exact"))
    assert empty.shape == (784, 100) and not empty.any()


@pytest.mark.parametrize("net,rule", (("6layer-dcsnn", "exact"), ("5layer-csnn", "linear"),
                                      ("2layer-snn", "imstdp")))
def test_counter_net_on_card_fused_matches_reference(cuda, net, rule):
    """Each conv layer launches kernel 6 and the fc layer the counter fc
    kernel once per step, and no layer kernel 5; fused and reference runs
    agree on every spike, and on the weights within the reference's net
    tolerance."""
    cfg = TS.PAPER_NETWORKS[net](rule, backend="fused", quantise=False)
    t_steps = 12
    g = torch.Generator().manual_seed(0)
    raster = (torch.rand((t_steps, 4, int(np.prod(cfg.input_shape))), generator=g) < 0.3)
    raster = raster.to(torch.uint8).to(cuda)
    runs = {}
    for backend in ("fused", "reference"):
        run_cfg = dataclasses.replace(cfg, backend=backend)
        st = TS.init_snn(run_cfg, 4, generator=torch.Generator().manual_seed(1), device=cuda)
        NK.counter_conv_delta.launches = 0
        NK.counter_stdp_update.launches = NK.counter_fc_delta.launches = 0
        runs[backend] = TS.run_snn(st, raster, run_cfg)
        if backend == "fused":
            conv = sum(spec.kind.startswith("conv") for spec in cfg.layers)
            assert NK.counter_conv_delta.launches == conv * t_steps
            assert NK.counter_fc_delta.launches == t_steps
            assert NK.counter_stdp_update.launches == 0
    (sf, cf), (sr, cr) = runs["fused"], runs["reference"]
    assert cf.sum() > 0 and torch.equal(cf, cr)
    for a, b in zip(sf.weights, sr.weights):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the side kernels: fused LIF (7), LLSMU (8), po2 encode (9) and decode (10)
# ---------------------------------------------------------------------------

# one element, ragged tails of a four-element vector (3, 5, 127, 6,913), the
# DCSNN conv1 population and a size that walks the grid more than once
SIDE_SHAPES = ((1,), (3,), (4,), (5,), (127,), (6913,), (16, 6912), (2**20 + 3,))
LIF_PARAMS = (dict(), dict(tau=2.0, v_th=0.7), dict(tau=20.0, v_th=1.0, e_rest=-0.5))


@pytest.mark.parametrize("shape", SIDE_SHAPES)
@pytest.mark.parametrize("params", range(len(LIF_PARAMS)))
def test_lif_kernel_bit_equal_to_plain_version(cuda, shape, params):
    p = TL.LIFParams(**LIF_PARAMS[params])
    g = torch.Generator().manual_seed(len(shape) * 100 + params)
    v = (torch.rand(shape, generator=g) * 1.7 - 0.5).to(cuda)
    i_in = (torch.rand(shape, generator=g) * 0.8).to(cuda)
    kw = dict(alpha=p.alpha, e_rest=p.e_rest, v_th=p.v_th)
    v2, s = LK.lif_update(v, i_in, **kw)
    pv, ps = lif_update_ref(v, i_in, **kw)
    torch.cuda.synchronize()
    assert torch.equal(v2, pv) and torch.equal(s, ps)
    if len(shape) <= 2:
        st, spk = lif_step_kernel(TL.LIFState(v=v), i_in, p)
        ref_st, ref_spk = TL.lif_step(TL.LIFState(v=v), i_in, p)
        assert torch.equal(st.v, ref_st.v) and torch.equal(spk, ref_spk)


# the default Q12 mantissas first, then the ends of the accepted range
LLSMU_FRAC_BITS = (12, 0, 1, 28, 29)


def _operands(shape, top, g):
    n = int(np.prod(shape))
    bits = torch.randint(0, top + 1, (2, n), generator=g)
    vals = torch.randint(0, 2**31 - 1, (2, n), generator=g, dtype=torch.int64) % (1 << bits)
    edges = torch.tensor([0, 1, 2, 3, 15, 16, 17, 255, 256, 2**20 - 1, 2**20, 2**30 - 1, 2**30])
    k = min(n, edges.numel())
    vals[0, :k] = edges[:k] % (1 << top)
    vals[1, :k] = edges.flip(0)[:k] % (1 << top)
    return (vals.to(torch.int32).reshape(2, *shape))


@pytest.mark.parametrize("shape", SIDE_SHAPES)
@pytest.mark.parametrize("n_bits", (3, 4, 5, 8))
def test_llsmu_kernel_bit_equal_to_plain_version(cuda, shape, n_bits):
    """Operands up to 2^30, beyond 2N bits too, where wrapping int32
    arithmetic and shifts past the width decide the result; at the default
    Q12 mantissas and at the ends of the accepted frac_bits, 0 and 29, where
    the kernel's barrel shifts reach their least and greatest amounts."""
    g = torch.Generator().manual_seed(n_bits * 10 + len(shape))
    for top in (2 * n_bits, 30):
        a, b = _operands(shape, top, g).to(cuda)
        for frac_bits in LLSMU_FRAC_BITS:
            kw = dict(n_bits=n_bits, frac_bits=frac_bits)
            out = MK.llsmu_multiply(a, b, **kw)
            plain = llsmu_multiply_ref(a, b, **kw)
            torch.cuda.synchronize()
            assert out.dtype == torch.int32 and torch.equal(out, plain), (top, frac_bits)
        assert torch.equal(out.cpu(), llsmu_multiply_ref(a.cpu(), b.cpu(), **kw))


@pytest.mark.parametrize("shape", SIDE_SHAPES)
@pytest.mark.parametrize("n_bits", (3, 4, 5, 8))
def test_llsmu_scalar_b_equals_materialised_operands(cuda, shape, n_bits):
    """The scalar-b variant (one b for every element) against the plain
    version and the element-pair variant on b broadcast in memory, for b of
    every width up to 2^30, 0 included, at every frac_bits of
    LLSMU_FRAC_BITS."""
    g = torch.Generator().manual_seed(n_bits * 10 + len(shape) + 5)
    for top in (2 * n_bits, 30):
        a, bs = _operands(shape, top, g)
        for bv in (0, 1, int(bs.reshape(-1)[-1]), (1 << top) - 1):
            for one in (torch.tensor(bv, dtype=torch.int32), torch.tensor([bv], dtype=torch.int32)):
                a_d, one_d = a.to(cuda), one.to(cuda)
                full = one_d.reshape(()).expand(shape).contiguous()
                for frac_bits in LLSMU_FRAC_BITS:
                    kw = dict(n_bits=n_bits, frac_bits=frac_bits)
                    out = MK.llsmu_multiply(a_d, one_d, **kw)
                    pair = MK.llsmu_multiply(a_d, full, **kw)
                    plain = llsmu_multiply_ref(a_d, full, **kw)
                    torch.cuda.synchronize()
                    assert out.shape == a.shape and out.dtype == torch.int32
                    assert torch.equal(out, plain) and torch.equal(pair, plain), (
                        top, bv, frac_bits)


@pytest.mark.parametrize("n", [math.prod(shape) for shape in SIDE_SHAPES])
def test_side_kernels_on_unaligned_views(cuda, n):
    """Contiguous views one element into their storage (not 16-byte
    aligned): kernels 7 and 8 (both variants) take every element one a
    thread, kernels 9 and 10 as always; each bit-equal to its plain version."""
    g = torch.Generator().manual_seed(n)

    def view(x):
        out = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)[1:].view(x.shape)
        out.copy_(x)
        assert out.is_contiguous() and out.data_ptr() % 16 != 0
        return out

    v = view((torch.rand(n, generator=g) * 1.7 - 0.5).to(cuda))
    i_in = view((torch.rand(n, generator=g) * 0.8).to(cuda))
    kw = dict(alpha=0.9, e_rest=0.0, v_th=1.0)
    v2, s = LK.lif_update(v, i_in, **kw)
    pv, ps = lif_update_ref(v, i_in, **kw)
    a, b = (view(x.to(cuda)) for x in _operands((n,), 30, g))
    one = view(b[:1])
    out, out_one = MK.llsmu_multiply(a, b), MK.llsmu_multiply(a, one)
    x = view(_po2_values((n,), g).to(cuda))
    codes = view(PK.po2_encode(x))
    back = PK.po2_decode(codes)
    torch.cuda.synchronize()
    assert torch.equal(v2, pv) and torch.equal(s, ps)
    assert torch.equal(out, llsmu_multiply_ref(a, b))
    assert torch.equal(out_one, llsmu_multiply_ref(a, one.expand(n)))
    assert torch.equal(codes, PR.po2_encode_ref(x))
    assert torch.equal(back.view(torch.int32), PR.po2_decode_ref(codes).view(torch.int32))


def test_side_kernels_on_two_streams_at_once(cuda):
    """Two streams launch kernels 7 and 8 (both variants) in turns on
    different inputs at the path's 16 × 6,912; every result equals its plain
    version."""
    shape = (16, 6912)
    kw = dict(alpha=0.9, e_rest=0.0, v_th=1.0)
    calls = []
    for seed in (1, 2):
        g = torch.Generator().manual_seed(seed)
        v = (torch.rand(shape, generator=g) * 1.7 - 0.5).to(cuda)
        i_in = (torch.rand(shape, generator=g) * 0.8).to(cuda)
        a, b = _operands(shape, 12, g).to(cuda)
        one = b[:1, :1].clone()
        calls.append({
            "lif": (lambda v=v, i=i_in: LK.lif_update(v, i, **kw),
                    lambda v=v, i=i_in: lif_update_ref(v, i, **kw)),
            "llsmu": (lambda a=a, b=b: (MK.llsmu_multiply(a, b),),
                      lambda a=a, b=b: (llsmu_multiply_ref(a, b),)),
            "llsmu_scalar_b": (lambda a=a, o=one: (MK.llsmu_multiply(a, o),),
                               lambda a=a, o=one: (llsmu_multiply_ref(a, o.expand(shape)),)),
        })
    streams = [torch.cuda.Stream() for _ in calls]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    outs = [{name: [] for name in calls[0]} for _ in calls]
    for _ in range(10):
        for c, st, out in zip(calls, streams, outs):
            with torch.cuda.stream(st):
                for name, (kern, _) in c.items():
                    out[name].append(kern())
    torch.cuda.synchronize()
    for c, out in zip(calls, outs):
        for name, (_, plain) in c.items():
            ref = plain()
            for o in out[name]:
                assert all(torch.equal(x, y) for x, y in zip(o, ref)), name
    assert not torch.equal(outs[0]["llsmu"][0][0], outs[1]["llsmu"][0][0])


def test_side_kernels_are_one_launch_per_call(cuda):
    """The profiler sees one kernel per wrapper call of kernels 7-10 (both
    variants of 8) and no other kernel, memset or copy.  Once a process has
    run many kernels, a trace can drop its first kernel records (two, on the
    card), so each trace opens with `opened` fill kernels, which no wrapper
    launches and which are not counted; fewer than n of them, so a fill
    that a wrapper launched on each of its n calls would still show.  A
    trace can drop a record but never add one, so up to three are taken
    until one holds every launch."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.rand((16, 6912), device=cuda)
    c = torch.randint(0, 1 << 12, (16, 6912), device=cuda, dtype=torch.int32)
    one = c[:1, :1].clone()
    opener = torch.empty(1, device=cuda)
    calls = (lambda: LK.lif_update(x, x, alpha=0.9), lambda: MK.llsmu_multiply(c, c),
             lambda: MK.llsmu_multiply(c, one), lambda: PK.po2_encode(x),
             lambda: PK.po2_decode(c))
    n, opened = 10, 8
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(opened):
                opener.fill_(1.5)
            for _ in range(n):
                for call in calls:
                    call()
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        names = [k for k in kernels if "FillFunctor" not in k]
        if len(names) >= len(calls) * n:
            break
    assert len(kernels) - len(names) <= opened      # the opening fills alone
    assert len(names) == len(calls) * n
    assert sum("lif_update_kernel" in k for k in names) == n
    assert sum("llsmu_multiply_kernel<false" in k for k in names) == n
    assert sum("llsmu_multiply_kernel<true" in k for k in names) == n
    assert sum("po2_encode_kernel" in k for k in names) == n
    assert sum("po2_decode_kernel" in k for k in names) == n


def test_llsmu_signed_and_fixed_point_lif_on_card(cuda):
    """The signed wrapper and 30 fixed-point LIF steps at 16 × 6,912: the
    kernel equals the reference oracle, state and spikes at every step."""
    g = torch.Generator().manual_seed(3)
    a = torch.randint(-255, 256, (4, 1000), generator=g, dtype=torch.int32).to(cuda)
    b = torch.randint(-255, 256, (4, 1000), generator=g, dtype=torch.int32).to(cuda)
    assert torch.equal(llsmu(a, b), llsmu(a, b, use_kernel=False))
    for scalar in (-155, 0, 155, torch.tensor([-77], device=cuda)):
        assert torch.equal(llsmu(a, scalar), llsmu(a, scalar, use_kernel=False))
    p = TL.LIFParams()
    st = TL.lif_fixed_init((16, 6912), p, device=cuda)
    plain = st
    MK.llsmu_multiply.launches = 0
    for _ in range(30):
        i_in = (torch.rand((16, 6912), generator=g) * 0.8).to(cuda)
        st, spk = TL.lif_step_llsmu(st, i_in, p)
        plain, plain_spk = TL.lif_step_llsmu(plain, i_in, p, use_kernel=False)
        assert torch.equal(st.v_q, plain.v_q) and torch.equal(spk, plain_spk)
    assert MK.llsmu_multiply.launches == 30


SIDE_EDGES = (0.0, -0.0, math.nan, -math.nan, math.inf, -math.inf, 1e-45, 1e-40, -1e-40,
              5e-39, 1.1754944e-38, -1.1754944e-38, 1e-38, 2.0 ** -64, 2.0 ** -63, 2.0 ** 62,
              2.0 ** 63, 2.0 ** 64, 3.4028235e38, -3.4028235e38, 1.0, -1.0, 1.5, 1.4)


def _po2_values(shape, g):
    n = int(np.prod(shape))
    a = torch.randn(n, generator=g) * torch.exp(torch.rand(n, generator=g) * 40 - 20)
    centres = (torch.tensor(2.0).sqrt() * torch.exp2(torch.arange(-70.0, 70.0))).view(torch.int32)
    ties = (centres[:, None] + torch.arange(-6, 7, dtype=torch.int32)).reshape(-1)
    ties = ties.view(torch.float32)
    x = torch.cat([torch.tensor(SIDE_EDGES), ties, -ties, a])[:n]
    return x.reshape(shape)


@pytest.mark.parametrize("shape", SIDE_SHAPES)
def test_po2_kernels_bit_equal_to_plain_versions(cuda, shape):
    x = _po2_values(shape, torch.Generator().manual_seed(len(shape))).to(cuda)
    codes = PK.po2_encode(x)
    plain = PR.po2_encode_ref(x)
    torch.cuda.synchronize()
    assert codes.dtype == torch.int32 and torch.equal(codes, plain)
    assert torch.equal(codes.cpu(), PR.po2_encode_ref(x.cpu()))
    back = PK.po2_decode(codes)
    assert torch.equal(back.view(torch.int32), PR.po2_decode_ref(codes).view(torch.int32))
    assert torch.equal(po2_quantize(x, use_kernel=True), po2_quantize(x, use_kernel=False))


def test_po2_edges_and_every_code_on_card(cuda):
    for value in SIDE_EDGES:
        x = torch.tensor([value], device=cuda)
        assert int(PK.po2_encode(x)) == int(PR.po2_encode_ref(x.cpu())), value
    codes = torch.arange(-512, 512, dtype=torch.int32, device=cuda)
    out = PK.po2_decode(codes)
    assert torch.equal(out.view(torch.int32), PR.po2_decode_ref(codes.cpu()).view(torch.int32)
                       .to(cuda))


def test_side_kernels_count_launches_and_reject_bad_operands(cuda):
    x = torch.rand((4, 33), device=cuda)
    c = torch.randint(0, 256, (4, 33), device=cuda, dtype=torch.int32)
    kernels = (LK.lif_update, MK.llsmu_multiply, PK.po2_encode, PK.po2_decode)
    for k in kernels:
        k.launches = 0
    LK.lif_update(x, x, alpha=0.5)
    MK.llsmu_multiply(c, c)
    MK.llsmu_multiply(c, c[:1, :1])
    PK.po2_encode(x)
    PK.po2_decode(c)
    assert [k.launches for k in kernels] == [1, 2, 1, 1]
    with pytest.raises(TypeError, match="float32"):
        LK.lif_update(x.double(), x.double(), alpha=0.5)
    with pytest.raises(ValueError, match="is on cpu"):
        LK.lif_update(x, x.cpu(), alpha=0.5)
    with pytest.raises(ValueError, match="shape"):
        MK.llsmu_multiply(c, c[:, :-1])
    with pytest.raises(TypeError, match="int32"):
        MK.llsmu_multiply(c.long(), c.long())
    with pytest.raises(ValueError, match="n_bits"):
        MK.llsmu_multiply(c, c, n_bits=11)
    with pytest.raises(TypeError, match="int32"):
        MK.llsmu_multiply(c, c[:1, :1].long())
    with pytest.raises(ValueError, match="is on cpu"):
        MK.llsmu_multiply(c, c[:1, :1].cpu())
    with pytest.raises(ValueError, match="contiguous"):
        PK.po2_encode(x.t())
    with pytest.raises(TypeError, match="int32"):
        PK.po2_decode(x)
    assert [k.launches for k in kernels] == [1, 2, 1, 1]


def test_itp_adamw_on_card_kernels_equal_plain_quantiser(cuda):
    """3 ITP-AdamW steps: the po2 kernels launch once per leaf per step, and
    parameters and moments equal the run on the plain quantiser bitwise."""
    g = torch.Generator(device=cuda).manual_seed(0)
    shapes = {"embed": {"tok": (512, 64)}, "blocks": {"attn": {"wq": (2, 64, 96)},
                                                       "norm1": {"scale": (2, 64)}}}
    params = {"embed": {"tok": torch.randn(shapes["embed"]["tok"], generator=g, device=cuda)},
              "blocks": {"attn": {"wq": torch.randn((2, 64, 96), generator=g, device=cuda)},
                         "norm1": {"scale": torch.ones((2, 64), device=cuda)}}}
    cfg = OPT.OptimizerConfig(po2_update=True, warmup_steps=2)
    runs = {}
    for use_kernel in (True, False):
        p, st = params, OPT.init_opt_state(params)
        PK.po2_encode.launches = PK.po2_decode.launches = 0
        for step in range(3):
            gg = torch.Generator(device=cuda).manual_seed(10 + step)
            grads = {"embed": {"tok": torch.randn((512, 64), generator=gg, device=cuda)},
                     "blocks": {"attn": {"wq": torch.randn((2, 64, 96), generator=gg,
                                                           device=cuda)},
                                "norm1": {"scale": torch.randn((2, 64), generator=gg,
                                                               device=cuda)}}}
            p, st, _ = OPT.adamw_update(cfg, p, grads, st, use_kernel=use_kernel)
        leaves = len(tree_leaves(params))
        want = 3 * leaves if use_kernel else 0
        assert PK.po2_encode.launches == PK.po2_decode.launches == want
        runs[use_kernel] = tree_leaves((p, st.mu, st.nu))
    assert all(torch.equal(a, b) for a, b in zip(runs[True], runs[False]))


# ---------------------------------------------------------------------------
# Rank1Rule's magnitude planes (kernels 2 and 4) and the sparse backend
# ---------------------------------------------------------------------------

def _magnitudes(shape, seed, device):
    """Non-binary float32 magnitudes of mstdp's form, reward·(elig/128)·po2
    read: a po2 sum scaled by a random eligibility word, zeros included."""
    g = torch.Generator().manual_seed(seed)
    po2 = po2_vectors(STDPParams(), 7)[1]
    bits = (torch.rand((7, *shape), generator=g) < 0.3).float()
    read = (po2.reshape(7, *([1] * len(shape))) * bits).sum(0)
    elig = torch.randint(0, 128, shape, generator=g).float() / 128.0
    return (elig * read).to(device)


@pytest.mark.parametrize("shape", DENSE_SHAPES)
def test_dense_kernel_on_a_depth1_magnitude_plane(cuda, shape):
    """Kernel 2 reads a one-row plane of magnitudes with po2 = [1.0] and no
    nearest mask: the product, bit-equal to the plain version, for the update
    and for the raw delta (zero w, unbounded clip)."""
    lanes, n_pre, n_post = shape
    x = _inputs(lanes, n_pre, n_post, 1, seed=n_pre, device=cuda)
    ltp = _magnitudes((lanes, 1, n_pre), 1, cuda)
    ltd = _magnitudes((lanes, 1, n_post), 2, cuda)
    one = torch.ones((1,), device=cuda)
    assert bool(((ltp > 0) & (ltp != 1.0)).any())
    for w, kw in ((x["w"], dict(eta=0.3, w_min=0.0, w_max=1.0)),
                  (torch.zeros_like(x["w"]), dict(eta=1.0, w_min=-math.inf, w_max=math.inf))):
        got = K.itp_stdp_update(w, x["pre_s"], x["post_s"], ltp, ltd, one, one,
                                nearest=False, **kw)
        plain = R.itp_stdp_update_ref(w, x["pre_s"], x["post_s"], ltp, ltd, one, one,
                                      nearest=False, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, plain)
    want = (x["post_s"][..., None, :] * (1 - x["pre_s"])[..., :, None] * ltp[:, 0, :, None]
            - x["pre_s"][..., :, None] * (1 - x["post_s"])[..., None, :] * ltd[:, 0, None, :])
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape", CONV_SHAPES[:6])
def test_conv_kernel_on_a_depth1_magnitude_plane(cuda, shape):
    """Kernel 4 stages a one-plane float32 operand (the one-pass body) and
    reads it as a product under ``nearest=False``."""
    m, kk, cc = shape
    x = _conv_inputs(m, kk, cc, 1, seed=m, device=cuda)
    ltp, ltd = _magnitudes((1, m, kk), 3, cuda), _magnitudes((1, m, cc), 4, cuda)
    one = torch.ones((1,), device=cuda)
    got = CK.itp_stdp_conv_delta(x["pre"], x["post"], ltp, ltd, one, one, nearest=False)
    again = CK.itp_stdp_conv_delta(x["pre"], x["post"], ltp, ltd, one, one, nearest=False)
    plain = CR.itp_stdp_conv_delta_ref(x["pre"], x["post"], ltp, ltd, one, one,
                                       nearest=False)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    torch.testing.assert_close(got, plain, **CONV_TOL)
    if m:
        assert float(got.abs().max()) > 0.0


def _sparse_case(seed, device, lanes=(3,), n_pre=300, n_post=70):
    g = torch.Generator().manual_seed(seed)
    x = dict(w=torch.rand((*lanes, n_pre, n_post), generator=g) * 0.6 + 0.2,
             pre=(torch.rand((*lanes, n_pre), generator=g) < 0.05).float(),
             post=(torch.rand((*lanes, n_post), generator=g) < 0.1).float(),
             ltp=torch.rand((*lanes, n_pre), generator=g),
             ltd=torch.rand((*lanes, n_post), generator=g))
    x["pre"][0] = 0.0                   # a lane with no pre event ...
    x["post"][-1] = 0.0                 # ... and one with no post event
    return {k: v.to(device) for k, v in x.items()}


def _sparse_calls(x, cap):
    from repro_torch.kernels.itp_sparse import ops as SO

    return {
        "update": lambda: SO.sparse_weight_update(x["w"], x["pre"], x["post"], x["ltp"],
                                                  x["ltd"], eta=0.3, max_events=cap),
        "delta": lambda: SO.sparse_synapse_delta(x["pre"], x["post"], x["ltp"], x["ltd"],
                                                 max_events=cap),
    }


@pytest.mark.parametrize("cap", (None, 1, 4, 1000))
def test_sparse_ops_on_card_equal_the_cpu(cuda, cap):
    """Sentinel padding, overflow past the cap and empty lists never reach an
    index op on the card (a device assert would end the context); the card
    and the CPU give the same bits.  The conv delta runs kernel 4 on the
    gathered rows."""
    from repro_torch.kernels.itp_sparse import ops as SO

    x = _sparse_case(7, cuda)
    xc = {k: v.cpu() for k, v in x.items()}
    for name, call in _sparse_calls(x, cap).items():
        got = call()
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), _sparse_calls(xc, cap)[name]()), name
    c = _conv_inputs(1600, 108, 24, 7, seed=9, device=cuda)
    c["pre"][c["pre"].sum(1) > 20] = 0.0             # some rows silent on both sides
    c["post"][:800] = 0.0
    po2 = po2_vectors(STDPParams(), 7, device=cuda)
    CK.itp_stdp_conv_delta.launches = 0
    got = SO.sparse_conv_delta(c["pre"], c["post"], c["pre_b"], c["post_b"], *po2,
                               max_events=cap)
    torch.cuda.synchronize()
    assert CK.itp_stdp_conv_delta.launches == 1
    cpu = SO.sparse_conv_delta(*(c[k].cpu() for k in ("pre", "post", "pre_b", "post_b")),
                               *(p.cpu() for p in po2), max_events=cap)
    assert torch.equal(got.cpu(), cpu)


def test_sparse_update_makes_no_host_sync(cuda):
    """The sparse engine update, fc delta and conv delta run with the sync
    debug mode set to raise: nothing waits for the card."""
    from repro_torch import plasticity
    from repro_torch.kernels.dispatch import im2col_2d

    x = _sparse_case(8, cuda, lanes=(8,), n_pre=784, n_post=100)
    g = torch.Generator().manual_seed(3)
    runs = []
    for rule in ("itp", "mstdp"):
        cfg = EngineConfig(n_pre=784, n_post=100, rule=rule, backend="sparse", max_events=40)
        plan = plasticity.make_plan(cfg, cuda)
        # engine states with a lane axis, and an SNN fc layer's flat ones
        states = [plan.rule.init_state(n, 7, batch=b, device=cuda)
                  for n, b in ((784, (8,)), (100, (8,)), (8 * 784, ()), (8 * 100, ()))]
        for _ in range(3):
            spikes = [(torch.rand((8, n), generator=g) < 0.1).to(cuda) for n in (784, 100)]
            states = [plan.rule.step(st, s, depth=7) for st, s in
                      zip(states, (*spikes, spikes[0].reshape(-1), spikes[1].reshape(-1)))]
        runs.append((plan, *states))
    # the DCSNN's conv1 after one step, and its conv delta's operands
    net = TS.fmnist_dcsnn(backend="sparse")
    st = TS.init_snn(net, 4, generator=torch.Generator().manual_seed(0), device=cuda)
    raster = (torch.rand((2, 4, 28, 28, 1), generator=g) < 0.2).float().to(cuda)
    st, _ = TS.snn_step(st, raster[0], net)
    layer, spec = st.layers[0], net.layers[0]
    patches = im2col_2d(raster[1], spec.kernel, spec.stride)
    s_out = (torch.rand(patches.shape[:3] + (spec.out_features,), generator=g) < 0.1)
    conv = (plasticity.make_plan(net, cuda),
            (layer.pre_hist, layer.post_hist, patches.reshape(4, -1, patches.shape[-1]),
             s_out.float().to(cuda)),
            dict(in_shape=(28, 28, 1), kind="conv2d", kernel=spec.kernel, stride=spec.stride))
    for plan, pre_st, post_st, *_ in runs:                 # warm: build, caches
        plan.update(x["w"], x["pre"], x["post"], pre_st, post_st)
    conv[0].conv_delta(*conv[1], **conv[2])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for plan, pre_st, post_st, pre_fc, post_fc in runs:
            plan.update(x["w"], x["pre"], x["post"], pre_st, post_st)
            plan.fc_delta(pre_fc, post_fc, x["pre"], x["post"])
        conv[0].conv_delta(*conv[1], **conv[2])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_sparse_ops_on_two_streams_at_once(cuda):
    """Two streams run the sparse ops in turns on different inputs; every
    result equals the one-stream result bit for bit."""
    xs = [_sparse_case(s, cuda, lanes=(8,), n_pre=784, n_post=100) for s in (10, 11)]
    calls = [_sparse_calls(x, 16) for x in xs]
    want = [{name: call() for name, call in c.items()} for c in calls]
    streams = [torch.cuda.Stream() for _ in xs]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    outs = [[] for _ in xs]
    for _ in range(10):
        for c, s, out in zip(calls, streams, outs):
            with torch.cuda.stream(s):
                out.append({name: call() for name, call in c.items()})
    torch.cuda.synchronize()
    for w, out in zip(want, outs):
        for o in out:
            assert all(torch.equal(o[name], w[name]) for name in w)
    assert not torch.equal(want[0]["update"], want[1]["update"])


def test_sparse_engine_on_card_bit_equal_to_fused(cuda):
    """At the 2layer-snn fc width the sparse itp engine follows the fused one
    bit for bit (w stays inside the clip window), at a realistic density."""
    from repro_torch.core import engine as TE

    g = torch.Generator().manual_seed(12)
    w0 = torch.rand((784, 100), generator=g) * 0.6 + 0.2
    raster = (torch.rand((32, 784), generator=g) < 0.02).float().to(cuda)
    runs = {}
    for backend in ("fused", "sparse"):
        cfg = EngineConfig(n_pre=784, n_post=100, backend=backend)
        st = TE.init_engine(cfg, w_init=w0, device=cuda)
        runs[backend] = TE.run_engine(st, raster, cfg)
    (fs, fp), (ss, sp) = runs["fused"], runs["sparse"]
    assert fp.any() and torch.equal(fp, sp) and torch.equal(fs.w, ss.w)


@pytest.mark.parametrize("net", ("engine", "6layer-dcsnn", "2layer-snn"))
def test_mstdp_on_card_fused_matches_reference(cuda, net):
    """mstdp's fused cells launch kernel 2 (engine) and kernel 4 (conv, and
    the fc layers' batch sum) on depth-1 magnitude planes, never the packed
    kernels 1 and 3; fused and
    reference runs on the card agree on every spike and, within the parity
    tolerance, on the weights."""
    from repro_torch.core import engine as TE

    t_steps = 12
    runs = {}
    for backend in ("fused", "reference"):
        for k in (K.itp_stdp_update, K.itp_stdp_update_packed, CK.itp_stdp_conv_delta,
                  CK.itp_stdp_conv_delta_packed):
            k.launches = 0
        if net == "engine":
            cfg = EngineConfig(n_pre=784, n_post=100, rule="mstdp", backend=backend)
            w0 = torch.Generator().manual_seed(1)
            st = TE.init_engine(cfg, generator=w0, device=cuda)
            raster = (torch.rand((t_steps, 784), generator=torch.Generator().manual_seed(2))
                      < 0.1).float().to(cuda)
            final, post = TE.run_engine(st, raster, cfg)
            runs[backend] = ((final.w,), post)
            dense, conv = 1, 0
        else:
            cfg = TS.PAPER_NETWORKS[net]("mstdp", backend=backend, quantise=False)
            st = TS.init_snn(cfg, 4, generator=torch.Generator().manual_seed(1), device=cuda)
            raster = (torch.rand((t_steps, 4, int(np.prod(cfg.input_shape))),
                                 generator=torch.Generator().manual_seed(2)) < 0.3)
            final, counts = TS.run_snn(st, raster.float().to(cuda), cfg)
            runs[backend] = (final.weights, counts)
            # every learnable layer, the fc layer's batch sum included
            dense = 0
            conv = sum(spec.kind.startswith(("conv", "fc")) for spec in cfg.layers)
        if backend == "fused":
            assert K.itp_stdp_update.launches == dense * t_steps
            assert CK.itp_stdp_conv_delta.launches == conv * t_steps
            assert K.itp_stdp_update_packed.launches == CK.itp_stdp_conv_delta_packed.launches == 0
    (wf, of), (wr, orf) = runs["fused"], runs["reference"]
    assert of.sum() > 0 and torch.equal(of, orf)
    for a, b in zip(wf, wr):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 if net != "engine" else 1e-6)


# ---------------------------------------------------------------------------
# checkpoints, the restart runner, the engine launcher, the sharded
# engine on the card
# ---------------------------------------------------------------------------

def test_checkpoint_moves_between_card_and_cpu(cuda, tmp_path):
    """Elastic restore: a checkpoint written from the card restores on the CPU
    (and onto the target's device by default), and the other way round."""
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.core.history import init_history

    g = torch.Generator().manual_seed(3)
    tree = {"w": torch.rand((784, 100), generator=g), "t": 5,
            "hist": init_history(100, 7)._replace(
                planes=torch.randint(0, 2, (7, 100), generator=g, dtype=torch.uint8))}
    on_card = {"w": tree["w"].to(cuda), "t": tree["t"],
               "hist": tree["hist"]._replace(planes=tree["hist"].planes.to(cuda),
                                             head=tree["hist"].head.to(cuda))}
    save_checkpoint(str(tmp_path / "card"), 1, on_card)
    back = restore_checkpoint(str(tmp_path / "card"), 1, tree)           # CPU target
    assert back["w"].device.type == "cpu" and torch.equal(back["w"], tree["w"])
    assert torch.equal(back["hist"].planes, tree["hist"].planes) and back["t"] == 5
    save_checkpoint(str(tmp_path / "cpu"), 2, tree)
    up = restore_checkpoint(str(tmp_path / "cpu"), 2, tree, device=cuda)
    assert up["w"].device.type == "cuda" and torch.equal(up["w"].cpu(), tree["w"])
    assert up["hist"].head.device.type == "cuda"
    up2 = restore_checkpoint(str(tmp_path / "cpu"), 2, on_card)
    assert up2["hist"].planes.device.type == "cuda"


@pytest.mark.parametrize("rule", ("itp", "exact", "mstdp"))
def test_persist_round_trip_on_card(cuda, tmp_path, rule):
    """The slice's serving load on fused: 16 requests, checkpoint, restore into
    a new Server on the card, the other 16: equal to an uninterrupted server
    bit for bit."""
    from repro_torch.launch.serve import synthetic_load

    cfg = EngineConfig(n_pre=784, n_post=100, rule=rule, backend="fused")
    scfg = ServeConfig(max_batch=8, t_steps=16, theta_plus=0.05)
    load = synthetic_load(torch.Generator().manual_seed(1), sessions=8, requests=32,
                          t_steps=16, n_pre=784, rate=0.3)
    whole = Server(cfg, scfg, device=cuda)
    tw = [whole.submit(r) for r in load]
    whole.drain()
    first = Server(cfg, scfg, device=cuda)
    for r in load[:16]:
        first.submit(r)
    first.drain()
    first.checkpoint(str(tmp_path))
    second = Server(cfg, scfg, device=cuda)
    second.restore(str(tmp_path))
    ts = [second.submit(r) for r in load[16:]]
    second.drain()
    for a, b in zip(tw[16:], ts):
        assert np.array_equal(whole.poll(a).post, second.poll(b).post)
    assert second.store.session_ids == whole.store.session_ids
    for sid in whole.store.session_ids:
        x, y = whole.store.peek(sid), second.store.peek(sid)
        assert y.w.device.type == "cuda" and x.t == y.t
        for p, q in zip((x.w, *x.pre_words, *x.post_words, x.v, x.theta),
                        (y.w, *y.pre_words, *y.post_words, y.v, y.theta)):
            assert torch.equal(p, q)


def test_runner_restart_on_card_is_bit_equal(cuda, tmp_path):
    """TrainingRunner over an engine population on fused: a failure at step 12
    restores step 10 and replays; the result equals an uninterrupted run, and
    kernel 1 launches once per step run (20 + 2 replayed)."""
    from repro_torch.core import engine as TE
    from repro_torch.distributed import FailureInjector, RunnerConfig, TrainingRunner

    cfg = EngineConfig(n_pre=256, n_post=256, backend="fused")

    def batch_fn(step):
        g = torch.Generator().manual_seed(1000 + step)
        return (torch.rand((4, 256), generator=g) < 0.3).float().to(cuda)

    def step_fn(state, x):
        state, post = TE.engine_step(state, x, cfg)
        return state, {"rate": post.float().mean()}

    runs = []
    for n, injector in (("clean", None), ("faulty", FailureInjector({12}))):
        state = TE.init_engine_population(cfg, 4, generator=torch.Generator().manual_seed(0),
                                          device=cuda)
        K.itp_stdp_update_packed.launches = 0
        runner = TrainingRunner(RunnerConfig(ckpt_dir=str(tmp_path / n), ckpt_every=5),
                                step_fn, batch_fn)
        runs.append((runner.run(state, 20, injector), K.itp_stdp_update_packed.launches,
                     runner.restarts))
    (a, na, ra), (b, nb, rb) = runs
    assert (na, ra, nb, rb) == (20, 0, 22, 1)
    assert torch.equal(a.w, b.w) and torch.equal(a.neurons.v, b.neurons.v)
    assert torch.equal(a.pre_hist.planes, b.pre_hist.planes)


def test_engine_launcher_on_card_fused_equals_reference(cuda):
    import argparse

    from repro_torch.launch.train import engine_training

    out = {}
    for rule, backend in (("itp", "fused"), ("itp", "reference"), ("exact", "fused"),
                          ("exact", "reference")):
        args = argparse.Namespace(rule=rule, backend=backend, engine_pre=256, engine_post=256,
                                  replicas=8, steps=20, engine_rate=0.3, device="cuda")
        out[rule, backend] = engine_training(args)
    for rule in ("itp", "exact"):
        (sf, stf, pf), (sr, str_, pr) = out[rule, "fused"], out[rule, "reference"]
        assert sf["device"].startswith("cuda") and torch.equal(pf, pr)
        if rule == "itp":
            assert torch.equal(stf.w, str_.w)
        else:
            torch.testing.assert_close(stf.w, str_.w, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("rule,backend", (("itp", "fused"), ("exact", "fused"),
                                          ("linear", "fused"), ("itp", "sparse")))
def test_sharded_engine_on_nccl_equals_run_engine(cuda, tmp_path, rule, backend):
    """A 1 × 1 NCCL grid in this process: the sharded engine at 784 × 100 over
    32 steps follows the unsharded run_engine bit for bit, one kernel launch
    a step on fused."""
    import torch.distributed as dist

    from repro_torch.core import engine as TE
    from repro_torch.core.engine_sharded import make_sharded_engine_step, shard_engine_state
    from repro_torch.distributed.sharding import init_process_group, make_grid

    cfg = EngineConfig(n_pre=784, n_post=100, rule=rule, backend=backend)
    g = torch.Generator().manual_seed(4)
    w0 = torch.rand((784, 100), generator=g) * 0.04
    raster = (torch.rand((32, 784), generator=g) < 0.02).float().to(cuda)
    ref_st, ref_post = TE.run_engine(TE.init_engine(cfg, w0, device=cuda), raster, cfg)
    init_process_group(cuda, rank=0, world_size=1,
                       store=dist.FileStore(str(tmp_path / "store"), 1))
    try:
        grid = make_grid(1, 1, device=cuda)
        st = shard_engine_state(TE.init_engine(cfg, w0, device=cuda), grid)
        step = make_sharded_engine_step(cfg, grid)
        kernel = {"itp": K.itp_stdp_update_packed, "exact": NK.counter_stdp_update,
                  "linear": NK.counter_stdp_update}[rule]
        kernel.launches = 0
        posts = []
        for x in raster:
            st, post = step(st, x)
            posts.append(post)
        torch.cuda.synchronize()
        assert kernel.launches == (32 if backend == "fused" else 0)
    finally:
        dist.destroy_process_group()
    assert 0 < ref_post.float().mean() < 1
    assert torch.equal(torch.stack(posts), ref_post) and torch.equal(st.w, ref_st.w)


# ---------------------------------------------------------------------------
# the kernels as registered operators (kernels/_ops.py) and traced graphs
# ---------------------------------------------------------------------------

def _op_cases(device):
    """name → (wrapper, plain version, args, kwargs, tolerance or None for
    bit-equal) at small ragged shapes, the dense updates with two lanes."""
    g = torch.Generator().manual_seed(21)

    def spikes(*shape):
        return (torch.rand(shape, generator=g) < 0.4).float().to(device)

    def words(*shape, high=128):
        return torch.randint(0, high, shape, generator=g, dtype=torch.uint8).to(device)

    ltp, ltd = po2_vectors(STDPParams(), 7, device=device)
    lut = counter_lut(STDPParams(), 7, device)
    w = torch.rand((2, 40, 13), generator=g).to(device)
    pre, post = spikes(2, 40), spikes(2, 13)
    patches, out = spikes(300, 27), spikes(300, 6)
    win = dict(depth=7, a_plus=1.0, a_minus=1.125, tau_plus=4.0, tau_minus=4.0)
    clip = dict(eta=0.0625, w_min=0.0, w_max=1.0)
    ints = [torch.randint(0, 1 << 12, (3, 77), generator=g, dtype=torch.int32).to(device)
            for _ in range(2)]
    v = (torch.randn((3, 77), generator=g) * 0.4 + 0.5).to(device)
    i_in = (torch.randn((3, 77), generator=g) * 0.3 + 0.2).to(device)
    x = (torch.randn((5, 61), generator=g) * 1e-2).to(device)
    codes = torch.randint(0, 256, (5, 61), generator=g, dtype=torch.int32).to(device)
    return {
        "itp_stdp_update_packed": (K.itp_stdp_update_packed, R.itp_stdp_update_packed_ref,
                                   (w, pre, post, words(2, 40), words(2, 13), ltp, ltd),
                                   dict(depth=7, nearest=True, **clip), None),
        "itp_stdp_update": (K.itp_stdp_update, R.itp_stdp_update_ref,
                            (w, pre, post, spikes(2, 7, 40), spikes(2, 7, 13), ltp, ltd),
                            dict(nearest=True, **clip), None),
        "itp_stdp_conv_delta_packed": (
            CK.itp_stdp_conv_delta_packed, CR.itp_stdp_conv_delta_packed_ref,
            (patches, out, words(300, 27), words(300, 6), ltp, ltd),
            dict(depth=7, nearest=True), CONV_TOL),
        "itp_stdp_conv_delta": (CK.itp_stdp_conv_delta, CR.itp_stdp_conv_delta_ref,
                                (patches, out, spikes(7, 300, 27), spikes(7, 300, 6), ltp,
                                 ltd), dict(nearest=True), CONV_TOL),
        "counter_stdp_update": (
            NK.counter_stdp_update,
            lambda *a, **kw: NR.counter_stdp_update_ref(*a[:5], lut=a[5], **kw),
            (w, pre, post, words(2, 40, high=8), words(2, 13, high=8), lut),
            dict(win, window="exact", **clip), WINDOW_TOL),
        "counter_conv_delta": (
            NK.counter_conv_delta,
            lambda *a, **kw: NR.counter_conv_delta_ref(*a[:4], lut=a[4], **kw),
            (patches, out, words(300, 27, high=8), words(300, 6, high=8), lut),
            dict(win, window="exact"), CONV_TOL),
        "counter_fc_delta": (
            NK.counter_fc_delta,
            lambda *a, **kw: NR.counter_fc_delta_ref(*a[:4], lut=a[4], **kw),
            (pre, post, words(2, 40, high=8), words(2, 13, high=8), lut),
            dict(win, window="exact"), CONV_TOL),
        "lif_update": (LK.lif_update, lif_update_ref, (v, i_in),
                       dict(alpha=0.9, e_rest=0.0, v_th=1.0), None),
        "llsmu_multiply": (MK.llsmu_multiply, llsmu_multiply_ref, tuple(ints),
                           dict(n_bits=4, frac_bits=12, c=0.08333), None),
        "po2_encode": (PK.po2_encode, PR.po2_encode_ref, (x,), {}, None),
        "po2_decode": (PK.po2_decode, PR.po2_decode_ref, (codes,), {}, None),
    }


OP_NAMES = ("itp_stdp_update_packed", "itp_stdp_update", "itp_stdp_conv_delta_packed",
            "itp_stdp_conv_delta", "counter_stdp_update", "counter_conv_delta",
            "counter_fc_delta", "lif_update", "llsmu_multiply", "po2_encode", "po2_decode")


@pytest.mark.parametrize("name", OP_NAMES)
def test_registered_op_on_card_equals_plain_and_counts_one_launch(cuda, name):
    wrapper, plain, args, kwargs, tol = _op_cases(cuda)[name]
    op = getattr(torch.ops.repro_torch, name)
    want = plain(*args, **kwargs)
    wrapper.launches = 0
    got = op(*args, **kwargs)
    assert wrapper.launches == 1
    got_w = wrapper(*args, **kwargs)
    assert wrapper.launches == 2
    for a, b, c in zip(*(t if isinstance(t, tuple) else (t,) for t in (got, got_w, want))):
        assert a.device.type == "cuda" and a.dtype == c.dtype and a.shape == c.shape
        assert torch.equal(a, b)
        if tol is None:
            assert torch.equal(a, c)
        else:
            torch.testing.assert_close(a, c, **tol)


@pytest.mark.parametrize("rule,kind", (("itp", "engine"), ("exact", "engine"),
                                       ("itp", "fc"), ("itp", "conv2d"),
                                       ("mstdp", "conv1d")))
def test_traced_fused_cell_runs_on_card_bit_equal_to_eager(cuda, rule, kind):
    """A fused cell's step traced on fake CUDA tensors (the graph audit's
    trace), then run on the card for 8 steps: each step bit-equal to the eager
    step, with the eager step's kernel launches."""
    from torch.utils._pytree import tree_leaves as leaves

    from repro_torch.analysis.graph_audit import cell_program, kernel_ops, trace

    state, spikes, step = cell_program(rule, "fused", kind, device=cuda)
    gm = trace(step, state, spikes)
    (qualified, n), = kernel_ops(gm).items()
    wrapper = {"repro_torch::itp_stdp_update_packed": K.itp_stdp_update_packed,
               "repro_torch::itp_stdp_update": K.itp_stdp_update,
               "repro_torch::itp_stdp_conv_delta_packed": CK.itp_stdp_conv_delta_packed,
               "repro_torch::itp_stdp_conv_delta": CK.itp_stdp_conv_delta,
               "repro_torch::counter_stdp_update": NK.counter_stdp_update,
               "repro_torch::counter_conv_delta": NK.counter_conv_delta}[qualified]
    g = torch.Generator().manual_seed(8)
    eager, graph = state, state
    for _ in range(8):
        x = (torch.rand(spikes.shape, generator=g) < 0.3).float().to(cuda)
        wrapper.launches = 0
        eager, out_e = step(eager, x)
        launched = wrapper.launches
        graph, out_g = gm(graph, x)
        assert launched == wrapper.launches - launched == n == 1
        for a, b in zip(leaves((eager, out_e)), leaves((graph, out_g))):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# LM training (ROADMAP item 18c)
# ---------------------------------------------------------------------------

LM_ARCHS = ("llama-3.2-vision-11b", "qwen1.5-32b", "yi-9b", "qwen3-0.6b", "qwen2-1.5b",
            "hymba-1.5b", "qwen2-moe-a2.7b", "phi3.5-moe-42b-a6.6b", "mamba2-1.3b",
            "musicgen-medium")
LM_PERTURBED = {"scale", "bias", "bq", "bk", "bv", "q_norm", "k_norm", "gate_attn", "conv_b",
                "d_skip", "dt_bias", "norm_scale", "up_bias", "down_bias"}


def _lm_case(arch, seed=0, dtype="float32"):
    """(cfg, params on the CPU, batch on the CPU) of a smoke config: every
    bias, norm scale, gate and SSM vector drawn away from its init."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import LMBatchSpec, lm_batches
    from repro_torch.models.transformer import init_model

    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    gen = torch.Generator().manual_seed(seed)

    def perturb(node):
        return {k: perturb(v) if isinstance(v, dict) else
                v + 0.3 * torch.randn(v.shape, generator=gen) if k in LM_PERTURBED else v
                for k, v in node.items()}

    params = perturb(init_model(gen, cfg, device="cpu"))
    batch = next(lm_batches(gen, LMBatchSpec(batch=2, seq=16, vocab=cfg.vocab_size)))
    if cfg.family == "vlm":
        batch["vis_embed"] = torch.randn((2, 8, cfg.vis_dim), generator=gen) * 0.5
    return cfg, params, batch


def _to(tree, device):
    from repro_torch.tree import tree_map

    if isinstance(tree, OPT.OptState):
        return OPT.OptState(*(_to(x, device) for x in tree))
    return tree_map(lambda a: a.to(device), tree)


def _lm_step(cfg, po2_update=False, remat="none", use_kernel=True):
    from repro_torch.train.train_step import TrainConfig, make_train_step

    # the launcher's optimizer at --steps 100, as tests/test_torch_lm_train.py
    return make_train_step(cfg, OPT.OptimizerConfig(lr=3e-4, warmup_steps=5, total_steps=100,
                                                    po2_update=po2_update),
                           TrainConfig(remat=remat), use_kernel=use_kernel)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_train_step_on_card_equals_cpu(cuda, arch):
    """One float32 AdamW step on the card ≡ the port on the CPU within the LM
    clause (the SSM and hybrid families within 2e-3): metrics, params and
    moments."""
    cfg, params, batch = _lm_case(arch)
    step = _lm_step(cfg)
    state = OPT.init_opt_state(params)
    got = step(_to(params, cuda), _to(state, cuda), _to(batch, cuda))
    want = step(params, state, batch)
    tol = (dict(rtol=2e-3, atol=2e-3) if cfg.family in ("ssm", "hybrid")
           else dict(rtol=1e-4, atol=1e-5))
    for name in want[2]:
        np.testing.assert_allclose(float(got[2][name]), float(want[2][name]),
                                   rtol=1e-4, atol=1e-5)
    for a, b in zip(tree_leaves(got[:2]), tree_leaves(want[:2])):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), **tol)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_train_step_on_card_repeats_bitwise(cuda, arch):
    """The ITP-AdamW step twice from one state on the card: bit-equal (the
    step's deterministic algorithms), and back to the process's setting."""
    cfg, params, batch = _lm_case(arch, seed=1)
    step = _lm_step(cfg, po2_update=True)
    p, s, b = _to(params, cuda), _to(OPT.init_opt_state(params), cuda), _to(batch, cuda)
    first, second = step(p, s, b), step(p, s, b)
    assert not torch.are_deterministic_algorithms_enabled()
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(first), tree_leaves(second)))


@pytest.mark.parametrize("arch", ("qwen3-0.6b", "qwen2-moe-a2.7b", "mamba2-1.3b"))
def test_itp_adamw_step_on_card_kernels_equal_plain_quantiser(cuda, arch):
    """ITP-AdamW on real gradients: the step with kernels 9-10 ≡ the step on
    the plain quantiser, bitwise; one encode and one decode launch per leaf."""
    cfg, params, batch = _lm_case(arch, seed=2, dtype="bfloat16")
    p, s, b = _to(params, cuda), _to(OPT.init_opt_state(params), cuda), _to(batch, cuda)
    PK.po2_encode.launches = PK.po2_decode.launches = 0
    kern = _lm_step(cfg, po2_update=True)(p, s, b)
    assert PK.po2_encode.launches == PK.po2_decode.launches == len(tree_leaves(params))
    plain = _lm_step(cfg, po2_update=True, use_kernel=False)(p, s, b)
    assert PK.po2_encode.launches == len(tree_leaves(params))
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(kern), tree_leaves(plain)))


@pytest.mark.parametrize("arch", ("qwen3-0.6b", "qwen2-moe-a2.7b", "mamba2-1.3b"))
def test_remat_on_card_is_bit_equal(cuda, arch):
    """``remat`` none / full / dots on the card: the bfloat16 step's outputs
    bit-equal."""
    cfg, params, batch = _lm_case(arch, seed=3, dtype="bfloat16")
    p, s, b = _to(params, cuda), _to(OPT.init_opt_state(params), cuda), _to(batch, cuda)
    runs = [tree_leaves(_lm_step(cfg, remat=remat)(p, s, b)) for remat in ("none", "full", "dots")]
    for other in runs[1:]:
        assert all(torch.equal(x, y) for x, y in zip(runs[0], other))


def test_lm_launcher_restart_on_card_is_bitwise(cuda, tmp_path):
    """The launcher's LM mode on the card: a failure at step 5 restores the
    step-4 checkpoint and ends bit-equal to an uninterrupted run."""
    from repro_torch.launch import train as launch_train

    argv = ["--smoke", "--arch", "qwen2-moe-a2.7b", "--steps", "7", "--batch", "2", "--seq",
            "32", "--ckpt-every", "2", "--po2-update", "--log-every", "10"]
    ap = launch_train.build_parser()
    s1, a = launch_train.lm_training(ap.parse_args(argv + ["--ckpt-dir", str(tmp_path / "a")]))
    s2, b = launch_train.lm_training(ap.parse_args(argv + ["--ckpt-dir", str(tmp_path / "b"),
                                                           "--inject-failure-at", "5"]))
    assert s1["device"].startswith("cuda") and (s1["restarts"], s2["restarts"]) == (0, 1)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


# ---------------------------------------------------------------------------
# sharded LM training (ROADMAP item 18d) on a one-rank NCCL mesh
# ---------------------------------------------------------------------------

def _lm_smoke_run(cuda, mesh, train_cfg, steps=2, arch="qwen3-0.6b"):
    """Two ITP-AdamW steps of a float32 smoke config from seed 5, on
    ``mesh`` (None: unsharded); the state gathered whole and the metrics,
    and the po2 launches of the run."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import LMBatchSpec, lm_batches
    from repro_torch.distributed.sharding import gather_tree
    from repro_torch.train import OptimizerConfig, init_training, make_train_step

    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    ocfg = OptimizerConfig(lr=3e-4, total_steps=100, warmup_steps=5, po2_update=True)
    params, opt = init_training(torch.Generator(cuda).manual_seed(5), cfg, ocfg, mesh=mesh,
                                device=cuda)
    step = make_train_step(cfg, ocfg, train_cfg, mesh)
    spec = LMBatchSpec(batch=4, seq=32, vocab=cfg.vocab_size)
    PK.po2_encode.launches = PK.po2_decode.launches = 0
    metrics = []
    for k in range(steps):
        batch = next(lm_batches(torch.Generator(cuda).manual_seed(50 + k), spec, n_steps=1))
        if cfg.family == "vlm":
            batch["vis_embed"] = 0.5 * torch.randn(
                (spec.batch, 8, cfg.vis_dim), device=cuda,
                generator=torch.Generator(cuda).manual_seed(70 + k))
        params, opt, m = step(params, opt, batch)
        metrics.append({name: float(v) for name, v in m.items()})
    torch.cuda.synchronize()
    launches = (PK.po2_encode.launches, PK.po2_decode.launches)
    state = tree_leaves((gather_tree(params), gather_tree(opt.mu), gather_tree(opt.nu)))
    return state, metrics, launches, len(tree_leaves(params))


@pytest.mark.parametrize("pod", [False, True], ids=["data_model", "pod_data_model"])
def test_lm_sharded_step_on_nccl_equals_the_unsharded_step(cuda, tmp_path, monkeypatch, pod):
    """A 1 × 1 (or 1 × 1 × 1) NCCL mesh in this process: the sharded step is
    the unsharded step bit for bit, kernels 9-10 launching once per leaf per
    step in ITP-AdamW (and once more each in the pod mean, where the
    unsharded step is fed the plain po2 round trip of its gradients)."""
    import torch.distributed as dist

    from repro_torch.distributed.sharding import init_process_group
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.train import TrainConfig
    from repro_torch.train import train_step as TTS

    init_process_group(cuda, rank=0, world_size=1,
                       store=dist.FileStore(str(tmp_path / "store"), 1))
    try:
        mesh = make_debug_mesh(1, 1, pod=1 if pod else None, device=cuda)
        got, got_m, launches, n = _lm_smoke_run(cuda, mesh, TrainConfig(remat="full"))
    finally:
        dist.destroy_process_group()
    assert launches == ((4 if pod else 2) * n,) * 2
    if pod:
        real = TTS.loss_and_grads

        def roundtrip(*a, **kw):
            loss, metrics, grads = real(*a, **kw)
            return loss, metrics, _tree_roundtrip(grads)
        monkeypatch.setattr(TTS, "loss_and_grads", roundtrip)
    want, want_m, _, _ = _lm_smoke_run(cuda, None, TrainConfig(remat="full"))
    monkeypatch.undo()
    assert got_m == want_m
    assert len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_tp_step_on_a_one_rank_nccl_mesh_equals_the_unsharded_step(cuda, tmp_path, arch):
    """Every smoke config's fsdp step on a 1 × 1 NCCL mesh runs inside the
    tensor-parallel context (ROADMAP item 19a), every one-rank collective
    skipped: the unsharded step bit for bit."""
    import torch.distributed as dist

    from repro_torch.distributed.sharding import init_process_group
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.train import TrainConfig

    init_process_group(cuda, rank=0, world_size=1,
                       store=dist.FileStore(str(tmp_path / "store"), 1))
    try:
        mesh = make_debug_mesh(1, 1, device=cuda)
        got, got_m, _, _ = _lm_smoke_run(cuda, mesh, TrainConfig(remat="full"), arch=arch)
    finally:
        dist.destroy_process_group()
    want, want_m, _, _ = _lm_smoke_run(cuda, None, TrainConfig(remat="full"), arch=arch)
    assert got_m == want_m
    assert len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_plans_on_a_one_rank_nccl_mesh_equal_the_unsharded_paths(cuda, tmp_path, arch):
    """``launch.specs``' prefill and decode plans (ROADMAP item 19b) on a 1 × 1
    NCCL mesh, tensor-parallel on DTensor weights and a DTensor cache, every
    one-rank collective skipped: ``forward(last_logits_only=True)`` and
    ``decode_step`` bit for bit (logits and every cache leaf, three steps,
    the last past the end of the cache)."""
    import torch.distributed as dist

    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.distributed.sharding import (distribute_like, distribute_tree,
                                                  init_process_group, map_with_path,
                                                  param_spec_tree)
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.specs import plan_cell
    from repro_torch.models import transformer as TT

    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    gen = torch.Generator(cuda).manual_seed(6)
    params = TT.init_model(gen, cfg, device=cuda)
    B, S, T = 2, 16, 16
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=cuda)
    vis = (0.5 * torch.randn((B, 8, cfg.vis_dim), generator=gen, device=cuda)
           if cfg.family == "vlm" else None)
    cache = TT.init_decode_cache(cfg, B, T, torch.float32, device=cuda)
    if vis is not None:
        with torch.no_grad():
            ck, cv = TT.precompute_cross_kv(params, cfg, vis)
        cache = cache._replace(cross_k=ck, cross_v=cv)
    def leaves(tree):
        return [x for x in tree_leaves(tree) if x is not None]

    for x in leaves(cache):
        x.copy_(0.5 * torch.randn(x.shape, generator=gen, device=cuda))
    twin = map_with_path(lambda _, x: x.clone(), cache)

    def placed(tree, shardings, mesh):
        by_path = {}
        map_with_path(by_path.__setitem__, shardings)
        return map_with_path(lambda path, x: distribute_like(x, mesh, by_path[path].placements),
                             tree)

    init_process_group(cuda, rank=0, world_size=1,
                       store=dist.FileStore(str(tmp_path / "store"), 1))
    try:
        mesh = make_debug_mesh(1, 1, device=cuda)
        dparams = distribute_tree(params, param_spec_tree(cfg, params, mesh), mesh)
        plan = plan_cell(cfg, ShapeSpec("p", S, B, "prefill"), mesh)
        batch = {"tokens": toks} if vis is None else {"tokens": toks, "vis_embed": vis}
        prefill = plan.fn(dparams, placed(batch, plan.in_shardings[1], mesh))
        dplan = plan_cell(cfg, ShapeSpec("d", T, B, "decode"), mesh)
        dcache = placed(cache, dplan.in_shardings[1], mesh)
        decoded = []
        for pos in (T - 2, T - 1, T):
            tok = placed({"t": toks[:, pos - T + 2:pos - T + 3]}, {"t": dplan.in_shardings[2]},
                         mesh)["t"]
            lg, dcache = dplan.fn(dparams, dcache, tok, pos)
            decoded.append(lg)
        got_cache = [x.to_local() for x in leaves(dcache)]
    finally:
        dist.destroy_process_group()
    assert plan.parallelism == dplan.parallelism == "tensor-parallel"
    kw = {} if vis is None else {"vis_embed": vis}
    with torch.no_grad():
        want, _ = TT.forward(params, cfg, tokens=toks, last_logits_only=True, **kw)
        assert torch.equal(prefill, want)
        for pos, got in zip((T - 2, T - 1, T), decoded):
            want, twin = TT.decode_step(params, cfg, twin, pos,
                                        tokens=toks[:, pos - T + 2:pos - T + 3])
            assert torch.equal(got, want), pos
    want_cache = leaves(twin)
    assert len(got_cache) == len(want_cache)
    assert all(torch.equal(a, b) for a, b in zip(got_cache, want_cache))


def _tree_roundtrip(tree):
    if isinstance(tree, dict):
        return {k: _tree_roundtrip(v) for k, v in tree.items()}
    return PR.po2_roundtrip_ref(tree)
