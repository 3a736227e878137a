"""granite-4.0-h-micro on the port (``configs/granite_4_0_h_micro.py``, an
``InterleavedConfig``): the interleaved Mamba-2 / NoPE attention stack's
forward, loss and gradients against the benchmark's plain float32
reference (``port_bench/reference/granite.py``, which imports nothing of
the port), four wrong programs that the comparison must refuse, the chunked
SSD scan against the step-by-step recurrence, the published config, the
launcher, and the paths the family does not have (decode, the sharded
step).  The JAX package has no such model: the reference is the plain one.

Seeded random weights at the SMOKE size in float32 (4 layers, d 64, chunk 8,
sequences of 40 tokens, five chunks), every leaf perturbed so that the
biases, A, D and the norm scales are not at their init values."""
import dataclasses
import math
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config, get_smoke_config, granite_4_0_h_micro
from repro_torch.launch import train as launch_train
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer
from repro_torch.models.config import InterleavedConfig
from repro_torch.train import train_step
from repro_torch.tree import tree_leaves, tree_unflatten

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from port_bench.reference import granite as ref  # noqa: E402

ARCH = "granite-4.0-h-micro"
B, S = 2, 40
# float32 on both sides, summed in other orders: the port's chunked dual
# form against the reference's quadratic form with float64 decays, its
# blockwise softmax against a plain one.  Measured: logits within 1e-7 of
# values up to 0.4, the loss within 5e-8 relative, each leaf's gradient
# within 5e-6 of its norm (A_log's, the deepest through the decays).
LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4


def ref_cfg(cfg) -> dict:
    """The reference's configuration (Hugging Face keys) of a port config."""
    return {"num_hidden_layers": cfg.n_layers, "layer_types": list(cfg.layer_types),
            "hidden_size": cfg.d_model, "shared_intermediate_size": cfg.d_ff,
            "num_attention_heads": cfg.n_heads, "num_key_value_heads": cfg.n_kv_heads,
            "vocab_size": cfg.vocab_size, "rms_norm_eps": cfg.norm_eps,
            "mamba_expand": cfg.ssm_expand, "mamba_n_heads": cfg.ssm_heads,
            "mamba_d_head": cfg.ssm_head_dim, "mamba_d_state": cfg.ssm_state,
            "mamba_n_groups": cfg.ssm_groups, "mamba_d_conv": cfg.d_conv,
            "embedding_multiplier": cfg.embedding_multiplier,
            "attention_multiplier": cfg.attention_multiplier,
            "residual_multiplier": cfg.residual_multiplier,
            "logits_scaling": cfg.logits_scaling, "attention_bias": False,
            "mamba_proj_bias": False, "mamba_conv_bias": True, "hidden_act": "silu",
            "tie_word_embeddings": True, "position_embedding_type": "nope",
            "num_local_experts": 0}


def _smoke():
    return dataclasses.replace(get_smoke_config(ARCH), dtype="float32")


def _setup(seed: int = 0):
    cfg = _smoke()
    gen = torch.Generator().manual_seed(seed)
    params = transformer.init_model(gen, cfg, device="cpu")
    params = tree_unflatten(params, [p + 0.05 * torch.randn(p.shape, generator=gen)
                                     for p in tree_leaves(params)])
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
    labels = torch.roll(tokens, -1, 1)
    labels[:, -1] = -1
    labels[0, :3] = -1
    return cfg, params, {"tokens": tokens, "labels": labels}


def _ref_logits(params, rcfg, tokens):
    with ref.float32_products(), torch.no_grad():
        return torch.stack([ref.forward(params, rcfg, t) for t in tokens])


def _port_logits(params, cfg, tokens):
    with torch.no_grad():
        return transformer.forward(params, cfg, tokens=tokens, remat="none")[0]


def test_forward_loss_and_gradients_agree_with_the_reference():
    cfg, params, batch = _setup()
    rcfg = ref_cfg(cfg)
    got, want = _port_logits(params, cfg, batch["tokens"]), _ref_logits(params, rcfg,
                                                                        batch["tokens"])
    torch.testing.assert_close(got, want, **LOGIT_TOL)
    tcfg = train_step.TrainConfig(remat="full", z_loss=1e-4)
    loss, _, grads = train_step.loss_and_grads(params, cfg, batch, train_cfg=tcfg)
    want_loss, want_grads = ref.loss_and_grads(params, rcfg, batch, 1e-4)
    assert float(loss) == pytest.approx(want_loss, rel=LOSS_RTOL)
    assert want_loss == pytest.approx(ref.loss(params, rcfg, batch, 1e-4), rel=1e-6)
    got_leaves, want_leaves = tree_leaves(grads), ref.leaves(want_grads)
    assert len(got_leaves) == len(want_leaves) == 26
    for g, w in zip(got_leaves, want_leaves):
        assert g.shape == w.shape and float(w.norm()) > 0
        assert float((g - w).norm()) <= GRAD_RTOL * float(w.norm())


WRONG = {
    "rope": lambda c: dataclasses.replace(c, pos_embedding="rope"),
    "scale_1_over_sqrt_hd": lambda c: dataclasses.replace(c, attention_multiplier=0.0),
    "residual_multiplier_1": lambda c: dataclasses.replace(c, residual_multiplier=1.0),
    "layers_reversed": lambda c: dataclasses.replace(c, layer_types=c.layer_types[::-1]),
}


@pytest.mark.parametrize("wrong", WRONG)
def test_the_comparison_refuses_a_wrong_program(wrong):
    """Each departure moves the logits far past the tolerance (at least 10×
    its largest allowed error)."""
    cfg, params, batch = _setup()
    want = _ref_logits(params, ref_cfg(cfg), batch["tokens"])
    bad = WRONG[wrong](cfg)
    got = _port_logits(params, bad, batch["tokens"])
    allowed = LOGIT_TOL["atol"] + LOGIT_TOL["rtol"] * want.abs()
    assert float(((got - want).abs() / allowed).max()) > 10
    with pytest.raises(AssertionError):
        torch.testing.assert_close(got, want, **LOGIT_TOL)


def _recurrence(x, dt, a, b_in, c_in):
    """h_t = exp(Δ_t A) h_{t-1} + Δ_t B_t x_tᵀ, y_t = C_t h_t, in float64,
    one step at a time.  x (B,L,g,r,P), dt (B,L,g,r), a (g,r), b/c (B,L,g,N)."""
    x, dt, a, b_in, c_in = (t.double() for t in (x, dt, a, b_in, c_in))
    Bn, L, g, r, P = x.shape
    h = torch.zeros(Bn, g, r, b_in.shape[-1], P, dtype=torch.float64)
    ys = []
    for t in range(L):
        h = (h * torch.exp(dt[:, t] * a)[..., None, None]
             + torch.einsum("bgn,bgrp->bgrnp", b_in[:, t], x[:, t] * dt[:, t, ..., None]))
        ys.append(torch.einsum("bgn,bgrnp->bgrp", c_in[:, t], h))
    return torch.stack(ys, 1), h


@pytest.mark.parametrize("groups", [1, 2])
def test_chunked_scan_matches_the_recurrence(groups):
    """Five chunks of 8 (and the carried state) against the step-by-step
    recurrence, and the reference's quadratic form against both."""
    gen = torch.Generator().manual_seed(groups)
    Bn, L, r, P, N, chunk = 2, 40, 3, 4, 5, 8
    x = torch.randn(Bn, L, groups, r, P, generator=gen)
    dt = torch.nn.functional.softplus(torch.randn(Bn, L, groups, r, generator=gen))
    a = -torch.exp(torch.rand(groups, r, generator=gen) * 2)
    b_in, c_in = (torch.randn(Bn, L, groups, N, generator=gen) for _ in range(2))
    y, state = ssm_mod.ssd_scan(x, dt, a, b_in, c_in, chunk)
    want_y, want_state = _recurrence(x, dt, a, b_in, c_in)
    torch.testing.assert_close(y.double(), want_y, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(state.double(), want_state, rtol=1e-5, atol=1e-5)
    # the reference's form: heads (g, r) flattened, each reading its group's C·Bᵀ
    for bi in range(Bn):
        cum = torch.cumsum((dt[bi] * a).double(), 0).reshape(L, -1).T
        cb = torch.einsum("tgn,sgn->gts", c_in[bi], b_in[bi])
        group = torch.arange(groups * r) // r
        xdt = (x[bi] * dt[bi, ..., None]).reshape(L, groups * r, P).transpose(0, 1)
        q = ref._quadratic_heads(cum, cb, group, xdt, False).transpose(0, 1)
        torch.testing.assert_close(q.double(), want_y[bi].reshape(L, groups * r, P),
                                   rtol=1e-5, atol=1e-5)


def test_config_holds_the_published_widths_and_pattern():
    cfg = get_config(ARCH)
    assert cfg is granite_4_0_h_micro.CONFIG and isinstance(cfg, InterleavedConfig)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
            cfg.d_ff, cfg.vocab_size) == (40, 2048, 32, 8, 64, 8192, 100352)
    assert (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups, cfg.d_conv,
            cfg.ssd_chunk, cfg.d_inner) == (64, 64, 128, 1, 4, 256, 4096)
    assert [i for i, k in enumerate(cfg.layer_types) if k == "attention"] == [5, 15, 25, 35]
    assert cfg.layer_types.count("mamba") == 36
    assert (cfg.embedding_multiplier, cfg.attention_multiplier, cfg.residual_multiplier,
            cfg.logits_scaling) == (12.0, 0.015625, 0.22, 8.0)
    assert cfg.pos_embedding == "none" and cfg.norm_eps == 1e-5 and cfg.tie_embeddings
    assert abs(cfg.param_count() - 3e9) / 3e9 < 0.10, cfg.param_count()
    assert cfg.has_attention and cfg.has_ssm and not cfg.supports_long_context
    smoke = get_smoke_config(ARCH)
    assert set(smoke.layer_types) == {"mamba", "attention"} and smoke.n_layers >= 4


@pytest.mark.parametrize("which", ["config", "smoke"])
def test_param_count_is_every_leaf_of_the_tree(which):
    cfg = get_config(ARCH) if which == "config" else get_smoke_config(ARCH)
    meta = transformer.init_model(None, cfg, device="meta")
    assert sum(math.prod(x.shape) for x in tree_leaves(meta)) == cfg.param_count()
    assert set(meta) == {"embed", "final_norm", "mamba_blocks", "attn_blocks"}
    assert meta["mamba_blocks"]["norm1"]["scale"].shape[0] == cfg.layer_types.count("mamba")
    assert meta["attn_blocks"]["attn"]["wq"].shape[0] == cfg.layer_types.count("attention")


def test_an_interleaved_config_is_checked():
    with pytest.raises(ValueError, match="layer_types"):
        dataclasses.replace(_smoke(), layer_types=("mamba",) * 3)
    with pytest.raises(ValueError, match="layer_types"):
        dataclasses.replace(_smoke(), layer_types=("mamba", "mamba", "moe", "mamba"))


def test_launcher_trains_granite_smoke(tmp_path, capsys):
    out = launch_train.main(["--arch", ARCH, "--smoke", "--steps", "1", "--device", "cpu",
                             "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path)])
    assert out["arch"] == ARCH and out["steps"] == 1
    assert math.isfinite(out["final_loss"]) and out["final_loss"] > 0
    assert capsys.readouterr().out.splitlines()[-1].startswith("done: 1 steps in")


def test_decode_and_the_sharded_step_are_refused():
    cfg = _smoke()
    with pytest.raises(NotImplementedError, match="no decode cache"):
        transformer.init_decode_cache(cfg, 1, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="no decode cache"):
        transformer.decode_step({}, cfg, transformer.DecodeCache(), 0,
                                tokens=torch.zeros(1, 1, dtype=torch.long))
    with pytest.raises(NotImplementedError, match="interleaved"):
        train_step.make_train_step(cfg, train_step.OptimizerConfig(), mesh=object())


def test_remat_policies_give_equal_gradients():
    cfg, params, batch = _setup(1)
    out = {}
    for remat in ("none", "full", "dots"):
        tcfg = train_step.TrainConfig(remat=remat)
        loss, _, grads = train_step.loss_and_grads(params, cfg, batch, train_cfg=tcfg)
        out[remat] = [loss, *tree_leaves(grads)]
    for remat in ("full", "dots"):
        assert all(torch.equal(a, b) for a, b in zip(out["none"], out[remat])), remat
