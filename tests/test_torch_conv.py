"""repro_torch.kernels.itp_stdp_conv against repro.kernels.itp_stdp_conv: the
im2col layouts (float patches and uint8 words, 2-D and 1-D) exactly; the raw
(K, C) conv delta against the JAX ops with the Pallas kernels in interpret
mode, at ragged M, K and C, depth 1..8 and both pairings, within atol=1e-4,
rtol=1e-5 (float32 accumulation order over the M rows, the reference's own
kernel-vs-oracle tolerance); packed ≡ unpacked in the port; one patch row
equal to the dense kernel-1 delta; the plan's conv and fc deltas against
the reference's on every backend; and the plan's fc delta against the
per-lane path summed over the batch, with the rule hook each rule reaches
(the counter rules' fc kernel wrapper's plain version and fake kernel too)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import repro.plasticity  # noqa: F401  (import order: breaks a cycle in repro.kernels)
from repro.core import history as JH
from repro.core.stdp import STDPParams as JSTDPParams
from repro.kernels.itp_stdp_conv import ops as JO
from repro.models import snn as JS
from repro.plasticity import apply as JA
from repro_torch.core import history as TH
from repro_torch.core.stdp import STDPParams
from repro_torch.kernels import dispatch
from repro_torch.kernels.itp_counter import kernel as NK
from repro_torch.kernels.itp_stdp.ops import synapse_delta
from repro_torch.kernels.itp_stdp_conv import kernel as TK
from repro_torch.kernels.itp_stdp_conv import ops as TO
from repro_torch.models import snn as TS
from repro_torch.plasticity import apply as TA
from repro_torch.plasticity import rules as TR

CONV_TOL = dict(atol=1e-4, rtol=1e-5)


def _layer(seed, m, kk, cc, depth):
    rng = np.random.default_rng(seed)
    return ((rng.random((m, kk)) < 0.3).astype(np.float32),
            (rng.random((m, cc)) < 0.25).astype(np.float32),
            (rng.random((depth, m, kk)) < 0.3).astype(np.float32),
            (rng.random((depth, m, cc)) < 0.25).astype(np.float32))


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("k,stride", [(3, 1), (5, 1), (3, 2), (5, 2)])
def test_im2col_2d_matches_reference(k, stride):
    rng = np.random.default_rng(k * 10 + stride)
    x = (rng.random((2, 11, 9, 3)) < 0.4).astype(np.float32)
    words = rng.integers(0, 256, (2, 11, 9, 3)).astype(np.uint8)
    np.testing.assert_array_equal(TO.im2col_2d(torch.from_numpy(x), k, stride).numpy(),
                                  np.asarray(JO.im2col_2d(jnp.asarray(x), k, stride)))
    out = TO.im2col_words_2d(torch.from_numpy(words), k, stride)
    assert out.dtype == torch.uint8
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(JO.im2col_words_2d(jnp.asarray(words), k, stride)))


@pytest.mark.parametrize("k,stride", [(7, 2), (5, 2), (5, 1), (1, 1)])
def test_im2col_1d_matches_reference(k, stride):
    rng = np.random.default_rng(k * 10 + stride)
    x = (rng.random((3, 37, 2)) < 0.4).astype(np.float32)
    words = rng.integers(0, 256, (3, 37, 2)).astype(np.uint8)
    np.testing.assert_array_equal(TO.im2col_1d(torch.from_numpy(x), k, stride).numpy(),
                                  np.asarray(JO.im2col_1d(jnp.asarray(x), k, stride)))
    out = TO.im2col_words_1d(torch.from_numpy(words), k, stride)
    assert out.dtype == torch.uint8
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(JO.im2col_words_1d(jnp.asarray(words), k, stride)))


def test_dispatch_reexports_the_im2col_helpers():
    for name in ("im2col_2d", "im2col_1d", "im2col_words_2d", "im2col_words_1d"):
        assert getattr(dispatch, name) is getattr(TO, name)
    with pytest.raises(AttributeError):
        dispatch.not_a_helper  # noqa: B018


# ragged M / K / C on purpose (nothing is padded in the port)
@pytest.mark.parametrize("m,kk,cc", [(24, 25, 12), (130, 14, 8), (300, 108, 24)])
@pytest.mark.parametrize("depth", [1, 3, 7, 8])
@pytest.mark.parametrize("pairing", ["nearest", "all"])
def test_conv_delta_matches_reference_kernel(m, kk, cc, depth, pairing):
    pre, post, pre_b, post_b = _layer(m + depth, m, kk, cc, depth)
    jd = JO.conv_synapse_delta(jnp.asarray(pre), jnp.asarray(post), jnp.asarray(pre_b),
                               jnp.asarray(post_b), JSTDPParams(), pairing=pairing,
                               use_kernel=True, interpret=True)
    tp = dict(pairing=pairing)
    unpacked = TO.conv_synapse_delta(*_t(pre, post, pre_b, post_b), STDPParams(), **tp)
    words = [TH.pack_bitplanes(torch.from_numpy(b)) for b in (pre_b, post_b)]
    packed = TO.conv_synapse_delta_packed(*_t(pre, post), *words, STDPParams(),
                                          depth=depth, **tp)
    oracle = TO.conv_synapse_delta(*_t(pre, post, pre_b, post_b), STDPParams(),
                                   use_kernel=False, **tp)
    np.testing.assert_allclose(unpacked.numpy(), np.asarray(jd), **CONV_TOL)
    assert torch.equal(packed, unpacked)
    np.testing.assert_allclose(oracle.numpy(), unpacked.numpy(), **CONV_TOL)


def test_packed_words_match_reference_packed_kernel():
    pre, post, pre_b, post_b = _layer(5, 77, 40, 16, 7)
    words = [TH.pack_bitplanes(torch.from_numpy(b)) for b in (pre_b, post_b)]
    jd = JO.conv_synapse_delta_packed(jnp.asarray(pre), jnp.asarray(post),
                                      *[jnp.asarray(w.numpy()) for w in words],
                                      JSTDPParams(), depth=7, use_kernel=True,
                                      interpret=True)
    td = TO.conv_synapse_delta_packed(*_t(pre, post), *words, STDPParams(), depth=7)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **CONV_TOL)


def test_single_row_matches_dense_kernel():
    """One patch row (B = P = 1) is the dense engine Δw."""
    pre, post, pre_b, post_b = _layer(3, 1, 20, 16, 7)
    conv = TO.conv_synapse_delta(*_t(pre, post, pre_b, post_b), STDPParams())
    dense = synapse_delta(*_t(pre[0], post[0], pre_b[:, 0], post_b[:, 0]), STDPParams())
    np.testing.assert_allclose(conv.numpy(), dense.numpy(), atol=1e-5, rtol=1e-5)


def test_empty_rows_give_a_zero_delta():
    pre, post, pre_b, post_b = _layer(0, 0, 5, 3, 7)
    out = TO.conv_synapse_delta(*_t(pre, post, pre_b, post_b), STDPParams())
    assert out.shape == (5, 3) and not out.any()


def test_wrapper_runs_plain_version_on_cpu_and_raises_elsewhere():
    pre, post, pre_b, post_b = _layer(1, 9, 6, 4, 7)
    words = [TH.pack_bitplanes(torch.from_numpy(b)) for b in (pre_b, post_b)]
    po2 = TO.po2_vectors(STDPParams(), 7)
    before = TK.itp_stdp_conv_delta_packed.launches
    TK.itp_stdp_conv_delta_packed(*_t(pre, post), *words, *po2, depth=7)
    assert TK.itp_stdp_conv_delta_packed.launches == before    # no kernel launched
    meta = [torch.empty(x.shape, dtype=x.dtype, device="meta")
            for x in (*_t(pre, post), *words)]
    with pytest.raises(ValueError, match="CUDA device or the CPU"):
        TK.itp_stdp_conv_delta_packed(*meta, *[p.to("meta") for p in po2], depth=7)
    with pytest.raises(ValueError, match="depth"):
        TK.itp_stdp_conv_delta_packed(*_t(pre, post), *words, *po2, depth=9)


# --- the plan's SNN layer deltas -------------------------------------------

def _histories(seed, n, depth=7, steps=9, rate=0.3):
    """One numpy raster pushed through both packages' history rings."""
    rng = np.random.default_rng(seed)
    jh, th = JH.init_history(n, depth), TH.init_history(n, depth)
    for _ in range(steps):
        s = (rng.random(n) < rate).astype(np.uint8)
        jh, th = JH.push(jh, jnp.asarray(s)), TH.push(th, torch.from_numpy(s))
    return jh, th


CELLS = [("reference", "reference", {}), ("fused", "fused_interpret", {}),
         ("fused_interpret", "fused_interpret", {}),
         ("fused", "fused_interpret", {"packed_history": False}),
         ("fused", "fused_interpret", {"pairing": "all"}),
         ("fused", "fused_interpret", {"rule": "itp_nocomp"})]


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: f"{c[0]}-{c[2]}")
@pytest.mark.parametrize("kind", ["conv2d", "conv1d"])
def test_plan_conv_delta_matches_reference(cell, kind):
    port_backend, jax_backend, extra = cell
    B, k, stride, C = 2, 3, (1 if kind == "conv2d" else 2), 5
    in_shape = (7, 6, 2) if kind == "conv2d" else (21, 3)
    rng = np.random.default_rng(11)
    s_in = (rng.random((B, *in_shape)) < 0.3).astype(np.float32)
    im2col = TO.im2col_2d if kind == "conv2d" else TO.im2col_1d
    p = im2col(torch.from_numpy(s_in), k, stride)
    patches = p.reshape(B, -1, p.shape[-1])
    s_out = (rng.random((B, *p.shape[1:-1], C)) < 0.25).astype(np.float32)
    jpre, tpre = _histories(1, B * int(np.prod(in_shape)))
    jpost, tpost = _histories(2, s_out.size)
    layers = (JS.SNNLayerSpec(kind, out_features=C, kernel=k, stride=stride),)
    jcfg = JS.SNNConfig(name="t", input_shape=in_shape, layers=layers,
                        backend=jax_backend, **extra)
    tcfg = TS.SNNConfig(name="t", input_shape=in_shape, layers=layers,
                        backend=port_backend, **extra)
    kw = dict(in_shape=in_shape, kind=kind, kernel=k, stride=stride)
    jd = JA.make_plan(jcfg).conv_delta(jpre, jpost, jnp.asarray(patches.numpy()),
                                       jnp.asarray(s_out), **kw)
    td = TA.make_plan(tcfg, "cpu").conv_delta(tpre, tpost, patches,
                                              torch.from_numpy(s_out), **kw)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **CONV_TOL)


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: f"{c[0]}-{c[2]}")
def test_plan_fc_delta_matches_reference(cell):
    port_backend, jax_backend, extra = cell
    B, n_in, n_out = 3, 40, 12
    rng = np.random.default_rng(4)
    s_in = (rng.random((B, n_in)) < 0.3).astype(np.float32)
    s_out = (rng.random((B, n_out)) < 0.3).astype(np.float32)
    jpre, tpre = _histories(5, B * n_in)
    jpost, tpost = _histories(6, B * n_out)
    layers = (JS.SNNLayerSpec("fc", out_features=n_out),)
    jcfg = JS.SNNConfig(name="t", input_shape=(n_in,), layers=layers,
                        backend=jax_backend, **extra)
    tcfg = TS.SNNConfig(name="t", input_shape=(n_in,), layers=layers,
                        backend=port_backend, **extra)
    jd = JA.make_plan(jcfg).fc_delta(jpre, jpost, jnp.asarray(s_in), jnp.asarray(s_out))
    td = TA.make_plan(tcfg, "cpu").fc_delta(tpre, tpost, torch.from_numpy(s_in),
                                            torch.from_numpy(s_out))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-6)


# (rule, backend, config fields, the rule hook the plan's fc delta reaches,
# bit for bit with the per-lane path): the history rules and mstdp contract
# the batch in the conv kernel (patch_delta), the counter rules' per-pair
# windows sum it in the counter fc kernel (fc_counter_synapse_delta)
FC_ROUTES = [
    ("itp", "fused", {}, "patch_delta", True),
    ("itp", "fused_interpret", {}, "patch_delta", True),
    ("itp_nocomp", "fused", {}, "patch_delta", True),
    ("itp_nocomp", "fused_interpret", {}, "patch_delta", True),
    ("itp", "fused", {"packed_history": False}, "patch_delta", True),
    ("itp", "fused", {"depth": 12}, "patch_delta", True),
    ("itp_nocomp", "fused_interpret", {"depth": 12, "pairing": "all"}, "patch_delta", True),
    ("mstdp", "fused", {}, "patch_delta", False),
    ("mstdp", "fused_interpret", {}, "patch_delta", False),
    ("exact", "fused", {}, "fc_counter_synapse_delta", True),
    ("exact", "fused_interpret", {}, "fc_counter_synapse_delta", True),
    ("linear", "fused", {}, "fc_counter_synapse_delta", True),
    ("linear", "fused_interpret", {}, "fc_counter_synapse_delta", True),
    ("imstdp", "fused", {}, "fc_counter_synapse_delta", True),
    ("imstdp", "fused_interpret", {}, "fc_counter_synapse_delta", True),
    ("exact", "fused", {"depth": 255}, "fc_counter_synapse_delta", False),
]


@pytest.mark.parametrize("route", FC_ROUTES,
                         ids=lambda r: f"{r[0]}-{r[1]}-{'-'.join(map(str, r[2].values()))}")
def test_plan_fc_delta_sums_the_per_lane_deltas(route, monkeypatch):
    """The plan's fc delta against the per-lane path it replaced:
    ``fused_delta`` over the batch lanes, summed in float64 and rounded once.
    Every per-sample term of a history rule is an exact po2 sum, so the
    contraction gives the same bits, as does a counter rule's window at depth
    7; mstdp's magnitudes, and the exact window's at depth 255, may span more
    binades (within the reference test's tolerance).  A spy on the rule's
    hooks shows which datapath ran; a counter rule's fc kernel wrapper gives
    the same delta on the CPU (its plain version), its fake kernel the
    ``(n_in, n_out)`` float32 shape, and neither counts a launch."""
    rule_name, backend, extra, hook, bitwise = route
    B, n_in, n_out = 16, 40, 12
    cfg = TS.SNNConfig(name="t", input_shape=(n_in,),
                       layers=(TS.SNNLayerSpec("fc", out_features=n_out),),
                       backend=backend, rule=rule_name, **extra)
    plan = TA.make_plan(cfg, "cpu")
    rule = plan.rule
    rng = np.random.default_rng(7)

    def state(n):
        st = rule.init_state(n, cfg.depth)
        for _ in range(cfg.depth + 2):
            st = rule.step(st, torch.from_numpy((rng.random(n) < 0.3).astype(np.uint8)),
                           depth=cfg.depth)
        return st

    pre_st, post_st = state(B * n_in), state(B * n_out)
    s_in = torch.from_numpy((rng.random((B, n_in)) < 0.3).astype(np.float32))
    s_out = torch.from_numpy((rng.random((B, n_out)) < 0.3).astype(np.float32))

    pre_read = rule.kernel_view(pre_st, packed=plan.packed)
    post_read = rule.kernel_view(post_st, packed=plan.packed)
    words = pre_read.dim() == 1
    if words:
        pre_read, post_read = pre_read.reshape(B, -1), post_read.reshape(B, -1)
    else:
        pre_read = pre_read.reshape(pre_read.shape[0], B, -1).transpose(0, 1)
        post_read = post_read.reshape(post_read.shape[0], B, -1).transpose(0, 1)
    lanes = rule.fused_delta(s_in, s_out, pre_read, post_read, plan.stdp, packed=words,
                             depth=plan.depth, pairing=plan.pairing,
                             compensate=plan.compensate, interpret=plan.interpret,
                             po2=plan.po2, table=plan.table)
    want = lanes.sum(dim=0, dtype=torch.float64).to(torch.float32)
    assert lanes.shape == (B, n_in, n_out) and want.abs().max() > 0

    calls = []
    for name in ("patch_delta", "fused_delta"):
        orig = getattr(type(rule), name)

        def spy(self, *a, _name=name, _orig=orig, **kw):
            calls.append(_name)
            return _orig(self, *a, **kw)

        monkeypatch.setattr(type(rule), name, spy)
    fc_counter = TR.fc_counter_synapse_delta

    def fc_spy(*a, **kw):
        calls.append("fc_counter_synapse_delta")
        return fc_counter(*a, **kw)

    monkeypatch.setattr(TR, "fc_counter_synapse_delta", fc_spy)
    got = plan.fc_delta(pre_st, post_st, s_in, s_out)
    assert calls == [hook]
    assert got.dtype == torch.float32 and got.shape == (n_in, n_out)
    if bitwise:
        assert torch.equal(got, want)
    else:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)
    if hook == "fc_counter_synapse_delta":
        p = plan.stdp
        args = (s_in, s_out, pre_read, post_read, plan.table)
        kw = dict(depth=plan.depth, window=rule.window, a_plus=p.a_plus, a_minus=p.a_minus,
                  tau_plus=p.tau_plus, tau_minus=p.tau_minus)
        NK.counter_fc_delta.launches = 0
        assert torch.equal(NK.counter_fc_delta(*args, **kw), got)
        with FakeTensorMode() as mode:
            fake = NK.counter_fc_delta(*(mode.from_tensor(t) for t in args), **kw)
        assert fake.shape == (n_in, n_out) and fake.dtype == torch.float32
        assert NK.counter_fc_delta.launches == 0    # the CUDA kernel alone counts
