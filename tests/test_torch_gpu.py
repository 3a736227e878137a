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
within the conv tolerance."""
import dataclasses

import numpy as np
import pytest
import torch

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
from repro_torch.models import snn as TS
from repro_torch.serve import Request, ServeConfig, Server

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


# the paper nets' conv layers at batch 16, plus ragged and single-row shapes
@pytest.mark.parametrize("shape", ((9216, 25, 12), (1600, 108, 24), (4048, 14, 8),
                                   (976, 40, 16), (257, 33, 9), (1, 20, 16), (0, 5, 3)))
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


@pytest.mark.parametrize("shape", ((9216, 25, 12), (1600, 108, 24), (4048, 14, 8),
                                   (976, 40, 16), (257, 33, 9), (1, 20, 16), (0, 5, 3)))
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
