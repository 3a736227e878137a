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


@pytest.mark.parametrize("shape", ((2, 200, 72), (8, 784, 100), (1, 33, 5)))
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
    assert sum("itp_conv_delta_kernel<true>" in n for n in names) == calls
    assert sum("itp_conv_delta_kernel<false>" in n for n in names) == calls
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
    its kernel once per step, the fc layer the dense kernel once per step."""
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
            assert CK.itp_stdp_conv_delta_packed.launches == 2 * t_steps
            assert K.itp_stdp_update_packed.launches == t_steps
    (sp, cp), (su, cu), (sr, cr) = runs.values()
    assert cp.sum() > 0
    assert torch.equal(cp, cu) and torch.equal(cp, cr)
    for a, b, c in zip(sp.weights, su.weights, sr.weights):
        assert torch.equal(a, b) and torch.equal(a, c)


# --- counter rules: fused update and conv delta (kernels 5-6) --------------

WINDOWS = ("exact", "linear", "imstdp")
WINDOW_TOL = dict(rtol=1e-6, atol=1e-6)


def _counter_kw(depth, window):
    p = STDPParams()
    return dict(depth=depth, window=window, a_plus=p.a_plus, a_minus=p.a_minus,
                tau_plus=p.tau_plus, tau_minus=p.tau_minus)


def _counters(shape, depth, g):
    return torch.randint(0, depth + 1, shape, generator=g).to(torch.uint8)


@pytest.mark.parametrize("shape", ((8, 784, 100), (16, 600, 128), (2, 130, 70), (1, 33, 5)))
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


@pytest.mark.parametrize("net,rule", (("6layer-dcsnn", "exact"), ("5layer-csnn", "linear"),
                                      ("2layer-snn", "imstdp")))
def test_counter_net_on_card_fused_matches_reference(cuda, net, rule):
    """Each layer launches its counter kernel once per step; fused and
    reference runs agree on every spike, and on the weights within the
    reference's net tolerance."""
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
        NK.counter_stdp_update.launches = 0
        runs[backend] = TS.run_snn(st, raster, run_cfg)
        if backend == "fused":
            conv = sum(spec.kind.startswith("conv") for spec in cfg.layers)
            assert NK.counter_conv_delta.launches == conv * t_steps
            assert NK.counter_stdp_update.launches == t_steps
    (sf, cf), (sr, cr) = runs["fused"], runs["reference"]
    assert cf.sum() > 0 and torch.equal(cf, cr)
    for a, b in zip(sf.weights, sr.weights):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the side kernels: fused LIF (7), LLSMU (8), po2 encode (9) and decode (10)
# ---------------------------------------------------------------------------

SIDE_SHAPES = ((1,), (127,), (6913,), (16, 6912))
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
    arithmetic and shifts past the width decide the result."""
    g = torch.Generator().manual_seed(n_bits * 10 + len(shape))
    for top in (2 * n_bits, 30):
        a, b = _operands(shape, top, g).to(cuda)
        out = MK.llsmu_multiply(a, b, n_bits=n_bits)
        plain = llsmu_multiply_ref(a, b, n_bits=n_bits)
        torch.cuda.synchronize()
        assert out.dtype == torch.int32 and torch.equal(out, plain)
        assert torch.equal(out.cpu(), llsmu_multiply_ref(a.cpu(), b.cpu(), n_bits=n_bits))


def test_llsmu_signed_and_fixed_point_lif_on_card(cuda):
    """The signed wrapper and 30 fixed-point LIF steps at 16 × 6,912: the
    kernel equals the reference oracle, state and spikes at every step."""
    g = torch.Generator().manual_seed(3)
    a = torch.randint(-255, 256, (4, 1000), generator=g, dtype=torch.int32).to(cuda)
    b = torch.randint(-255, 256, (4, 1000), generator=g, dtype=torch.int32).to(cuda)
    assert torch.equal(llsmu(a, b), llsmu(a, b, use_kernel=False))
    p = TL.LIFParams()
    st = TL.lif_fixed_init((16, 6912), p, device=cuda)
    plain = st
    for _ in range(30):
        i_in = (torch.rand((16, 6912), generator=g) * 0.8).to(cuda)
        st, spk = TL.lif_step_llsmu(st, i_in, p)
        plain, plain_spk = TL.lif_step_llsmu(plain, i_in, p, use_kernel=False)
        assert torch.equal(st.v_q, plain.v_q) and torch.equal(spk, plain_spk)


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
    PK.po2_encode(x)
    PK.po2_decode(c)
    assert [k.launches for k in kernels] == [1, 1, 1, 1]
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
    with pytest.raises(ValueError, match="contiguous"):
        PK.po2_encode(x.t())
    with pytest.raises(TypeError, match="int32"):
        PK.po2_decode(x)
    assert [k.launches for k in kernels] == [1, 1, 1, 1]


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
