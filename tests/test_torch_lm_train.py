"""LM training at float32 (ROADMAP item 18c): ``repro_torch.train.train_step``
against the JAX package's for each of the ten smoke configs, given the
reference's parameters and tokens through numpy.

The LM training clause: ``lm_loss``, its metrics, every gradient leaf and
the state after one ``make_train_step`` step (params, ``mu``, ``nu``; AdamW
and ITP-AdamW) within ``assert_allclose(rtol=1e-4, atol=1e-5)``, the SSM and
hybrid families within ``rtol=atol=2e-3``.  ITP-AdamW's quantiser is
discontinuous at ±√2·2^k, and ``u ≈ g / |g|`` magnifies the gradients'
last-bit differences where ``|g|`` is near ``eps``: elements whose
reference ``u`` lies in the tie band (``test_torch_po2.in_tie_band``) or
whose two ``u`` (each package's own) round to different codes are counted
(``-s`` prints them) and held only to the sum of the two quantised steps,
``lr·(2^e + 2^e')``.  The reference runs jitted: one compile a config gives
its loss, gradients and both optimizers' steps."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES
from repro.train import optimizer as JO
from repro.train import train_step as JTS
from repro_torch.train import optimizer as TO
from repro_torch.train import train_step as TTS
from repro_torch.tree import tree_leaves
from test_torch_lm_model import F32, SSM, _inputs, _model
from test_torch_po2 import _reference_u, correctly_rounded_codes, in_tie_band

B, S = 2, 16
# the launcher's optimizer at --steps 100: step 1's lr is lr / warmup
OPT = dict(lr=3e-4, total_steps=100, warmup_steps=5)
METRICS = ("loss", "ce", "z_loss", "moe_aux", "tokens")


def _tol(cfg):
    return SSM if cfg.family in ("ssm", "hybrid") else F32


def _batches(cfg, toks, jkw, tkw):
    labels = np.concatenate([toks[:, 1:], np.full((toks.shape[0], 1), -1, np.int32)], axis=1)
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels), **jkw},
            {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels), **tkw})


def port_grads(tp, cfg, batch, remat="none"):
    """``(loss, metrics, gradient leaves)`` of the port's ``lm_loss``."""
    loss, metrics, grads = TTS.loss_and_grads(tp, cfg, batch,
                                              train_cfg=TTS.TrainConfig(remat=remat))
    return loss, metrics, tree_leaves(grads)


@pytest.fixture(scope="module", params=ARCH_NAMES)
def case(request):
    """One config's reference results: its loss, metrics and gradients, and
    the state after one step of AdamW and one of ITP-AdamW."""
    cfg, jp, tp = _model(request.param)
    toks, jkw, tkw = _inputs(cfg, B, S, 1)
    jb, tb = _batches(cfg, toks, jkw, tkw)
    tc = JTS.TrainConfig(remat="none")
    steps = {po2: JTS.make_train_step(cfg, JO.OptimizerConfig(**OPT, po2_update=po2), tc)
             for po2 in (False, True)}

    def run(p, s, b):
        (loss, metrics), grads = jax.value_and_grad(
            lambda q: JTS.lm_loss(q, cfg, b, train_cfg=tc), has_aux=True)(p)
        return loss, metrics, grads, {po2: f(p, s, b) for po2, f in steps.items()}

    js = JO.init_opt_state(jp)
    loss, metrics, grads, stepped = jax.jit(run)(jp, js, jb)
    return dict(arch=request.param, cfg=cfg, jp=jp, tp=tp, jb=jb, tb=tb, js=js, loss=loss,
                metrics=metrics, grads=grads, stepped=stepped)


def test_lm_loss_and_gradients_match_reference_float32(case):
    cfg, tol = case["cfg"], _tol(case["cfg"])
    loss, metrics, grads = port_grads(case["tp"], cfg, case["tb"])
    np.testing.assert_allclose(float(loss), float(case["loss"]), **F32)
    assert set(metrics) == set(METRICS) == set(case["metrics"])
    for name in METRICS:
        np.testing.assert_allclose(float(metrics[name]), float(case["metrics"][name]), **F32)
    assert float(metrics["tokens"]) == B * (S - 1)      # the last column is masked
    if cfg.is_moe:
        assert float(metrics["moe_aux"]) > 0
    ref = jax.tree_util.tree_leaves(case["grads"])
    assert len(grads) == len(ref)
    gap = 0.0
    for g, r in zip(grads, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, **tol)
        if r.size:
            gap = max(gap, float((np.abs(g.numpy() - r) / (tol["atol"] + tol["rtol"] * np.abs(r)))
                                 .max()))
    print(f"[gap] {case['arch']} float32 gradients: {gap:.3g} of the clause")


def _port_u(cfg, params, new_state):
    """The port's update ``u`` before quantisation, from its own moments."""
    step = new_state.step.to(torch.float32)
    bc1, bc2 = 1 - torch.pow(cfg.beta1, step), 1 - torch.pow(cfg.beta2, step)
    return [((m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) + cfg.weight_decay * p).numpy()
            for p, m, v in zip(tree_leaves(params), tree_leaves(new_state.mu),
                               tree_leaves(new_state.nu))]


def _po2_steps(codes: np.ndarray) -> np.ndarray:
    """|the quantised update| of each correctly rounded code: 2^e."""
    return np.exp2((codes & 127).astype(np.float64) - 64)


@pytest.mark.parametrize("po2_update", [False, True], ids=["adamw", "itp_adamw"])
def test_train_step_matches_reference_float32(case, po2_update):
    cfg, tol = case["cfg"], _tol(case["cfg"])
    ocfg = TO.OptimizerConfig(**OPT, po2_update=po2_update)
    tp, ts = case["tp"], TO.init_opt_state(case["tp"])
    step = TTS.make_train_step(cfg, ocfg, TTS.TrainConfig(remat="none"))
    tp2, ts2, tm = step(tp, ts, case["tb"])
    jp2, js2, jm = case["stepped"][po2_update]
    assert int(ts2.step) == int(js2.step) == 1
    for name in (*METRICS, "lr", "grad_norm"):
        np.testing.assert_allclose(float(tm[name]), float(jm[name]), **F32)
    for got, want in zip(tree_leaves((ts2.mu, ts2.nu)),
                         jax.tree_util.tree_leaves((js2.mu, js2.nu))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    u_ref = _reference_u(JO.OptimizerConfig(**OPT, po2_update=po2_update), case["jp"],
                         case["grads"], case["js"], js2)
    u_port = _port_u(ocfg, tp, ts2)
    lr = float(tm["lr"])
    n_band = n_straddle = n_all = 0
    for got, want, ur, up in zip(tree_leaves(tp2), jax.tree_util.tree_leaves(jp2),
                                 u_ref, u_port):
        got, want = got.numpy(), np.asarray(want)
        assert got.dtype == np.float32
        mask = np.zeros(got.shape, bool)
        if po2_update:
            band = in_tie_band(ur)
            codes_ref, codes_port = correctly_rounded_codes(ur), correctly_rounded_codes(up)
            straddle = (codes_ref != codes_port) & ~band
            mask = band | straddle
            # a masked element moved by one of the two quantised updates
            step_gap = lr * (_po2_steps(codes_ref) + _po2_steps(codes_port)) * (1 + 1e-6)
            assert np.all(np.abs(got - want)[mask] <= step_gap[mask]
                          + tol["atol"] + tol["rtol"] * np.abs(want[mask]))
            n_band += int(band.sum())
            n_straddle += int(straddle.sum())
        n_all += got.size
        np.testing.assert_allclose(got[~mask], want[~mask], **tol)
    if po2_update:
        print(f"[po2] {case['arch']}: {n_band} elements in the tie band and {n_straddle} "
              f"whose two updates round to different codes, of {n_all}: counted, not compared")


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen2-moe-a2.7b"])
def test_three_steps_track_the_reference_loss(arch):
    """Three ITP-AdamW steps on three batches: each step's loss (computed on
    the parameters the previous steps made) within the clause."""
    cfg, jp, tp = _model(arch)
    ocfg = dict(OPT, po2_update=True)
    jstep = jax.jit(JTS.make_train_step(cfg, JO.OptimizerConfig(**ocfg),
                                        JTS.TrainConfig(remat="none")))
    tstep = TTS.make_train_step(cfg, TO.OptimizerConfig(**ocfg), TTS.TrainConfig(remat="none"))
    js, ts = JO.init_opt_state(jp), TO.init_opt_state(tp)
    losses = []
    for k in range(3):
        jb, tb = _batches(cfg, *_inputs(cfg, B, S, 10 + k))
        jp, js, jm = jstep(jp, js, jb)
        tp, ts, tm = tstep(tp, ts, tb)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **F32)
        losses.append(float(tm["loss"]))
    assert int(ts.step) == 3 and all(np.isfinite(losses))


def test_mesh_is_refused_citing_item_18d(tmp_path):
    """A mesh (ROADMAP item 18d, refused before it was ported): on a 1 × 1
    gloo mesh in this process the sharded step is the unsharded step, bit
    for bit; a mesh without the reference's axis names is refused."""
    import torch.distributed as dist

    from repro_torch.distributed.sharding import init_process_group
    from repro_torch.launch.mesh import make_debug_mesh
    cfg, _, _ = _model("qwen3-0.6b")
    ocfg = TO.OptimizerConfig(**OPT, po2_update=True)
    _, tb = _batches(cfg, *_inputs(cfg, B, S, 4))
    params, state = TTS.init_training(torch.Generator().manual_seed(0), cfg, ocfg, device="cpu")
    want = TTS.make_train_step(cfg, ocfg)(params, state, tb)
    init_process_group("cpu", rank=0, world_size=1,
                       store=dist.FileStore(str(tmp_path / "store"), 1))
    try:
        mesh = make_debug_mesh(1, 1, device="cpu")
        params, state = TTS.init_training(torch.Generator().manual_seed(0), cfg, ocfg,
                                          mesh=mesh, device="cpu")
        got = TTS.make_train_step(cfg, ocfg, mesh=mesh)(params, state, tb)
        for a, b in zip(tree_leaves((got[0], got[1].mu, got[1].nu)),
                        tree_leaves((want[0], want[1].mu, want[1].nu))):
            assert torch.equal(a.full_tensor(), b)
        assert all(torch.equal(got[2][k], want[2][k]) for k in want[2])
        with pytest.raises(ValueError, match="a train mesh has axes"):
            TTS.make_train_step(cfg, ocfg, mesh=dist.device_mesh.init_device_mesh(
                "cpu", (1,), mesh_dim_names=("x",)))
    finally:
        dist.destroy_process_group()


def test_init_training_draws_the_model_and_zero_moments():
    cfg = dataclasses.replace(_model("qwen2-moe-a2.7b")[0])
    params, state = TTS.init_training(torch.Generator().manual_seed(0), cfg,
                                      TO.OptimizerConfig(), device="cpu")
    again, _ = TTS.init_training(torch.Generator().manual_seed(0), cfg, TO.OptimizerConfig(),
                                 device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params), tree_leaves(again)))
    assert int(state.step) == 0 and state.step.dtype == torch.int32
    for p, m, v in zip(tree_leaves(params), tree_leaves(state.mu), tree_leaves(state.nu)):
        assert m.shape == v.shape == p.shape and not m.any() and not v.any()


def test_step_restores_the_deterministic_setting_and_repeats_bitwise():
    cfg, _, tp = _model("qwen2-moe-a2.7b")
    _, tb = _batches(cfg, *_inputs(cfg, B, S, 3))
    step = TTS.make_train_step(cfg, TO.OptimizerConfig(**OPT, po2_update=True))
    before = torch.are_deterministic_algorithms_enabled()
    a = step(tp, TO.init_opt_state(tp), tb)
    b = step(tp, TO.init_opt_state(tp), tb)
    assert torch.are_deterministic_algorithms_enabled() == before
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))
