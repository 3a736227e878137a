"""The SSM mixer split over 'model' in the sharded train step (ROADMAP item
19b, part 1) on a 1 × 4 gloo world, against the JAX package.

As in tests/test_torch_lm_tp.py (whose 1 × 2 world trains mamba2-1.3b and
hymba-1.5b with the mixer split two ways), the step is held to the
reference's unsharded ``make_train_step`` on the whole batch, two steps,
within the SSM clause (``rtol=atol=2e-3``).  The cases on four ranks:

  * mamba2-1.3b: 8 heads, 2 a rank; ``xbc``'s 160 columns cut 40 a rank, so
    rank 3's shard crosses from ``x`` (columns 0-127) into ``B`` and ``C``;
  * hymba-1.5b: the mixer beside attention, 144 ``xbc`` columns;
  * mamba2 with ``ssm_head_dim=64``: 2 heads, which 4 ranks do not divide,
    while its 128 and 160 columns do (hymba-1.5b's 50 heads on 16): the
    columns run split and every rank runs both heads;
  * mamba2 with 2 groups: each rank runs its head of every group;
  * mamba2 under ``remat="full"``: the recompute issues the mixer's
    collectives again, in the same order on every rank.

Each rank multiplies the spec's widths of every mixer leaf, the leaves
replicated over 'model' (``wdt``, ``a_log``, ``d_skip``, ``dt_bias``, the
norms) end bit-equal on every rank, and the first case run twice ends
bit-equal.  The world is spawned once and each reference step computed
once."""
import numpy as np
import pytest

import test_torch_lm_tp as TP
import test_torch_lm_tp_workers as W
from repro_torch.models.ssm import ssm_dims
from test_torch_sharded import _spawn

MODEL = 4
CASES = (("mamba2-1.3b", "none"), ("hymba-1.5b", "none"), ("mamba2-1.3b:head64", "none"),
         ("mamba2-1.3b:groups2", "none"), ("mamba2-1.3b", "full"))
MIXER = ("wz", "wxbc", "wdt", "conv_w", "conv_b", "a_log", "d_skip", "dt_bias", "norm_scale",
         "out_proj")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    store = str(tmp_path_factory.mktemp("tp_ssm_1x4") / "store")
    out = {}
    for rank, case, remat, *rest in _spawn(W.cases_worker, MODEL, store, MODEL, CASES,
                                           expect=MODEL * len(CASES)):
        out[case, remat, rank] = dict(zip(("metrics", "widths", "local", "state", "twice"),
                                          rest))
    return out


@pytest.fixture(scope="module")
def reference_runs():
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = TP._reference_steps(case)
        return cache[case]
    return get


def _ids(case):
    return f"1x{MODEL}-{case[0]}-{case[1]}"


@pytest.mark.parametrize("case,remat", CASES, ids=map(_ids, CASES))
def test_ssm_tp_step_matches_the_reference_unsharded_step(world, reference_runs, case, remat):
    ref_metrics, ref_state = reference_runs(case)
    per_rank = [world[case, remat, r]["metrics"] for r in range(MODEL)]
    assert all(m == per_rank[0] for m in per_rank), "the ranks' metrics differ"
    for got, want in zip(per_rank[0], ref_metrics):
        for name in TP.METRICS:
            np.testing.assert_allclose(got[name], want[name], **TP.SSM, err_msg=name)
    state = world[case, remat, 0]["state"]
    for name in ("params", "mu", "nu"):
        assert len(state[name]) == len(ref_state[name])
        for got, want in zip(state[name], ref_state[name]):
            np.testing.assert_allclose(got, np.asarray(want), **TP.SSM, err_msg=name)


@pytest.mark.parametrize("case,remat", CASES, ids=map(_ids, CASES))
def test_each_rank_multiplies_the_mixers_spec_widths(world, case, remat):
    cfg = W.config(case)
    specs = TP._specs(cfg, MODEL)
    want = {path: tuple(n if e != "model" else n // MODEL for n, e in zip(shape, spec))
            for path, (shape, spec) in specs.items()}
    for r in range(MODEL):
        assert world[case, remat, r]["widths"] == want
    di, heads, g, conv_dim = ssm_dims(cfg)
    mixer = {path.split("/")[-1]: (want[path], shape) for path, (shape, _) in specs.items()
             if "/ssm/" in f"/{path}"}
    assert set(mixer) == set(MIXER)
    # every projection of the mixer and its per-channel leaves are cut
    for name in ("wz", "wxbc", "conv_w", "conv_b", "norm_scale", "out_proj"):
        assert mixer[name][0] != mixer[name][1], name
    for name in ("wdt", "a_log", "d_skip", "dt_bias"):
        assert mixer[name][0] == mixer[name][1], name
    if case == "mamba2-1.3b":
        cut = conv_dim // MODEL
        assert (MODEL - 1) * cut < di < conv_dim      # the last shard crosses into B/C
    if case == "mamba2-1.3b:head64":
        assert heads % MODEL and di % MODEL == 0 == conv_dim % MODEL


@pytest.mark.parametrize("case,remat", CASES, ids=map(_ids, CASES))
def test_ssm_replicated_leaves_are_bit_equal_across_model_ranks(world, case, remat):
    specs = TP._specs(W.config(case), MODEL)
    replicated = [path for path, (_, spec) in specs.items() if "model" not in spec]
    assert any(path.endswith("ssm/a_log") for path in replicated)
    for name in ("params", "mu", "nu"):
        for path in replicated:
            arrays = [world[case, remat, r]["local"][name][path] for r in range(MODEL)]
            assert all(np.array_equal(a, arrays[0]) for a in arrays), (name, path)


def test_two_ssm_tp_runs_are_bit_equal(world):
    case, remat = CASES[0]
    assert [world[case, remat, r]["twice"] for r in range(MODEL)] == [True] * MODEL
