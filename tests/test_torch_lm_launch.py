"""The launcher's LM mode (ROADMAP item 18c) on the CPU, the LM train
state's checkpoints between the two packages, and the port's LM example.

The LM mode runs a dense and a MoE smoke arch with AdamW and ITP-AdamW; a
failure injected mid-run restarts once from the last checkpoint and ends
bit-equal to an uninterrupted run (each step's batch is keyed by its step).
A reference ``TrainingRunner`` checkpoint of the float32 smoke qwen3 restores
in the port and continues one step within the LM training clause of the
reference's own continuation, and the other way round."""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as j_restore
from repro.distributed.fault_tolerance import RunnerConfig as JRunnerConfig
from repro.distributed.fault_tolerance import TrainingRunner as JTrainingRunner
from repro.train import optimizer as JO
from repro.train import train_step as JTS
from repro_torch.checkpoint import latest_checkpoint, restore_checkpoint
from repro_torch.distributed.fault_tolerance import RunnerConfig, TrainingRunner
from repro_torch.launch import train as launch_train
from repro_torch.train import optimizer as TO
from repro_torch.train import train_step as TTS
from repro_torch.tree import tree_leaves
from test_torch_lm_model import F32, _model

ROOT = Path(__file__).resolve().parents[1]
SMOKE = ["--smoke", "--device", "cpu", "--batch", "2", "--seq", "16", "--log-every", "2"]


def _lm_args(tmp, *extra):
    return launch_train.build_parser().parse_args(SMOKE + ["--ckpt-dir", str(tmp), *extra])


@pytest.mark.parametrize("po2", [False, True], ids=["adamw", "itp_adamw"])
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen2-moe-a2.7b"])
def test_lm_mode_runs(tmp_path, capsys, arch, po2):
    argv = SMOKE + ["--arch", arch, "--steps", "6", "--ckpt-dir", str(tmp_path)]
    out = launch_train.main(argv + (["--po2-update"] if po2 else []))
    assert out["arch"] == arch and out["device"] == "cpu" and out["steps"] == 6
    assert out["po2_update"] == po2 and out["restarts"] == 0 and out["stragglers"] == 0
    assert np.isfinite(out["final_loss"]) and out["final_loss"] > 0
    assert out["tokens_per_s"] > 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[1] for ln in lines if ln.startswith("step ")] == ["0", "2", "4"]
    assert "loss" in lines[0] and "gnorm" in lines[0] and "it/s" in lines[0]
    assert lines[-1].startswith("done: 6 steps in") and "restarts=0; stragglers=0" in lines[-1]
    assert latest_checkpoint(str(tmp_path)) == 6


@pytest.mark.parametrize("arch,po2", [("qwen3-0.6b", True), ("qwen2-moe-a2.7b", False)])
def test_lm_mode_restart_is_bitwise(tmp_path, arch, po2):
    """A failure at step 5 (checkpoints every 2) restores step 4 and replays:
    the final params and optimizer state equal an uninterrupted run's."""
    flags = ["--arch", arch, "--steps", "7", "--ckpt-every", "2"] + (["--po2-update"] * po2)
    s1, plain = launch_train.lm_training(_lm_args(tmp_path / "a", *flags))
    s2, failed = launch_train.lm_training(_lm_args(tmp_path / "b", *flags,
                                                   "--inject-failure-at", "5"))
    assert (s1["restarts"], s2["restarts"]) == (0, 1)
    assert s1["final_loss"] == s2["final_loss"]
    assert int(failed["opt"].step) == 7
    a, b = tree_leaves(plain), tree_leaves(failed)
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def test_lm_mode_refuses_a_data_mesh(tmp_path, capsys):
    """A data mesh (ROADMAP item 18d): on one rank it ends bit-equal to no
    mesh; a batch its batch axes do not divide is refused before any rank
    starts."""
    plain_summary, plain = launch_train.lm_training(_lm_args(tmp_path / "a", "--steps", "3"))
    summary, state = launch_train.mesh_lm_training(_lm_args(tmp_path / "b", "--steps", "3",
                                                            "--data", "1", "--model", "1"))
    assert "mesh: data=1 × model=1" in capsys.readouterr().out
    assert summary["final_loss"] == plain_summary["final_loss"]
    a, b = tree_leaves(plain), tree_leaves(state)
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError, match="does not split"):
        launch_train.main(SMOKE + ["--data", "3", "--ckpt-dir", str(tmp_path / "c")])


# ---------------------------------------------------------------------------
# checkpoints between the packages
# ---------------------------------------------------------------------------

def _tokens(cfg, step):
    rng = np.random.default_rng(200 + step)
    toks = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((2, 1), -1, np.int32)], axis=1)
    return toks, labels


def _runs(arch="qwen3-0.6b"):
    """The float32 smoke config, both packages' initial states and steps."""
    cfg, jp, tp = _model(arch)
    kw = dict(lr=1e-3, total_steps=10, warmup_steps=1)
    jstep = jax.jit(JTS.make_train_step(cfg, JO.OptimizerConfig(**kw),
                                        JTS.TrainConfig(remat="none")))
    tstep = TTS.make_train_step(cfg, TO.OptimizerConfig(**kw), TTS.TrainConfig(remat="none"))

    def jwrapped(state, batch):
        p, o, m = jstep(state["params"], state["opt"], batch)
        return {"params": p, "opt": o}, m

    def twrapped(state, batch):
        p, o, m = tstep(state["params"], state["opt"], batch)
        return {"params": p, "opt": o}, m

    def jbatch(step):
        toks, labels = _tokens(cfg, step)
        return {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}

    def tbatch(step):
        toks, labels = _tokens(cfg, step)
        return {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}

    jstate = {"params": jp, "opt": JO.init_opt_state(jp)}
    tstate = {"params": tp, "opt": TO.init_opt_state(tp)}
    return (jwrapped, jbatch, jstate), (twrapped, tbatch, tstate)


def _assert_states_close(port_state, ref_state):
    got, want = tree_leaves(port_state), jax.tree_util.tree_leaves(ref_state)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32)


def test_reference_lm_checkpoint_continues_in_the_port(tmp_path):
    (jwrapped, jbatch, jstate), (twrapped, tbatch, tstate) = _runs()
    runner = JTrainingRunner(JRunnerConfig(ckpt_dir=str(tmp_path), ckpt_every=1),
                             jwrapped, jbatch)
    jstate = runner.run(jstate, 2)
    assert latest_checkpoint(str(tmp_path)) == 2
    restored = restore_checkpoint(str(tmp_path), 2, tstate)
    assert isinstance(restored["opt"], TO.OptState) and int(restored["opt"].step) == 2
    _assert_states_close(restored, jstate)
    port_next, _ = twrapped(restored, tbatch(2))
    ref_next, _ = jwrapped(jstate, jbatch(2))
    assert int(port_next["opt"].step) == 3
    _assert_states_close(port_next, ref_next)


def test_port_lm_checkpoint_continues_in_the_reference(tmp_path):
    (jwrapped, jbatch, jstate), (twrapped, tbatch, tstate) = _runs()
    runner = TrainingRunner(RunnerConfig(ckpt_dir=str(tmp_path), ckpt_every=1),
                            twrapped, tbatch)
    tstate = runner.run(tstate, 2)
    restored = j_restore(str(tmp_path), 2, jstate)
    assert int(restored["opt"].step) == 2
    _assert_states_close(tstate, restored)
    ref_next, _ = jwrapped(restored, jbatch(2))
    port_next, _ = twrapped(tstate, tbatch(2))
    _assert_states_close(port_next, ref_next)


# ---------------------------------------------------------------------------
# the example
# ---------------------------------------------------------------------------

def test_train_lm_torch_example_smoke(tmp_path, capfd):
    spec = importlib.util.spec_from_file_location("train_lm_torch",
                                                  ROOT / "examples" / "train_lm_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    rc = example.main(["--steps", "4", "--po2-update", "--device", "cpu",
                       "--ckpt-dir", str(tmp_path)])
    out = capfd.readouterr().out
    assert rc == 0, out
    assert "repro_torch.launch.train" in out and "--po2-update" in out
    assert "step     0" in out and "done: 4 steps in" in out and "restarts=1" in out
