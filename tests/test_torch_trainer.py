"""repro_torch.train.stdp_trainer and the training half of repro_torch.launch
against repro.train.stdp_trainer and repro.launch: the label-assignment
evaluator (ties included); a short train-to-accuracy run and the full protocol
of BENCH_accuracy.json on 2layer-snn, both on the JAX package's own arrays
and both with the same per-epoch accuracies as the JAX package's
train_to_accuracy; the CLI builders; and the launcher.

The two whole-run tests substitute the reference's synaptic product
(``jnp.einsum("bpk,kc->bpc")``) for the port's ``torch.matmul`` through
``repro_torch.models.snn.synaptic_product``.  The two libraries sum the K
inputs in different orders, so the currents differ in their last bits, and a
hard-WTA network turns such a difference into a different winner within tens
of steps (ROADMAP queue 3).  With the product shared, everything else the
port computes (plasticity, neurons, WTA, θ, quantisation, evaluation) follows
the reference bit for bit over the 1,440 training steps of the protocol.  The
protocol's curve is held against the one the JAX package computes here:
BENCH_accuracy.json's curve was recorded under another JAX and is not what
this one computes from the same seed (ROADMAP, reference caveats)."""
import argparse
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import encode_batch as j_encode_batch
from repro.data import spike_stream as j_spike_stream
from repro.launch import cli as JC
from repro.models import snn as JS
from repro.train import stdp_trainer as JT
from repro_torch.launch import cli as TC
from repro_torch.launch import train as TL
from repro_torch.models import snn as TS
from repro_torch.train import stdp_trainer as TT

ROOT = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# Label-assignment evaluator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_assignment_matches_reference_exactly(seed):
    """Integer spike counts with many ties (and silent neurons): the port
    assigns, votes and scores exactly as the reference does."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 3, (40, 12)).astype(np.float32)
    counts[:, 5] = 0.0                                 # a silent neuron
    labels = rng.integers(0, 4, 40)
    ja = JT.assign_labels(jnp.asarray(counts), jnp.asarray(labels), 4)
    ta = TT.assign_labels(torch.from_numpy(counts), torch.from_numpy(labels), 4)
    assert ta.dtype == torch.int32
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    eval_counts = rng.integers(0, 3, (25, 12)).astype(np.float32)
    jp = JT.assignment_predict(jnp.asarray(eval_counts), ja, 4)
    tp = TT.assignment_predict(torch.from_numpy(eval_counts), ta, 4)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    eval_labels = rng.integers(0, 4, 25)
    # the fraction of 25 correct: the reference's compiled mean multiplies by
    # the float32 reciprocal of 25, one rounding away from the port's value
    assert TT.assignment_accuracy(torch.from_numpy(eval_counts), torch.from_numpy(eval_labels),
                                  ta, 4) == pytest.approx(JT.assignment_accuracy(
                                      jnp.asarray(eval_counts), jnp.asarray(eval_labels), ja, 4),
                                      rel=1e-6)


def test_trainer_config_validates_counts():
    with pytest.raises(ValueError, match="batch must be >= 1"):
        TT.TrainerConfig(batch=0)
    assert dataclasses.asdict(TT.TrainerConfig()) == dataclasses.asdict(JT.TrainerConfig())


# ---------------------------------------------------------------------------
# train_to_accuracy on the JAX package's arrays
# ---------------------------------------------------------------------------

def _held_out(key, sampler, n_batches, tcfg):
    """The reference evaluator's batches (``_collect_counts``' key walk)."""
    out = []
    for _ in range(n_batches):
        key, k_data, k_enc = jax.random.split(key, 3)
        x, y = sampler(k_data, tcfg.batch)
        out.append({"spikes": np.array(j_encode_batch(k_enc, x, tcfg.t_steps)),
                    "labels": np.array(y)})
    return out


class ReplaySource:
    """Replays the arrays the reference's ``train_to_accuracy`` draws for one
    (cfg, tcfg): its initial weights, each epoch's training stream, and each
    evaluation's assignment and accuracy folds."""

    def __init__(self, jcfg, tcfg, sampler):
        key = jax.random.PRNGKey(tcfg.seed)
        self.weights = [np.array(w) for w in JS.init_snn(key, jcfg, tcfg.batch).weights]
        self.train, self.folds = [], []
        for epoch in range(tcfg.epochs):
            stream = j_spike_stream(jax.random.fold_in(key, 1000 + epoch), sampler,
                                    batch=tcfg.batch, t_steps=tcfg.t_steps,
                                    n_steps=tcfg.batches_per_epoch)
            self.train.append([{k: np.array(v) for k, v in b.items()} for b in stream])
            k_assign, k_eval = jax.random.split(jax.random.fold_in(key, 2000 + epoch))
            self.folds.append({"assign": _held_out(k_assign, sampler, tcfg.assign_batches, tcfg),
                               "eval": _held_out(k_eval, sampler, tcfg.eval_batches, tcfg)})

    @staticmethod
    def _torch(batches):
        return iter([{k: torch.from_numpy(v) for k, v in b.items()} for b in batches])

    def initial_weights(self):
        return self.weights

    def train_batches(self, epoch):
        return self._torch(self.train[epoch])

    def held_out_batches(self, epoch, fold):
        return self._torch(self.folds[epoch][fold])


_jax_product = jax.jit(lambda x, w: jnp.einsum("bpk,kc->bpc", x, w))


@pytest.fixture
def reference_product(monkeypatch):
    """The port's synaptic product computed by the reference's einsum."""
    def product(patches, w):
        return torch.from_numpy(np.array(_jax_product(patches.numpy(), w.numpy())))

    monkeypatch.setattr(TS, "synaptic_product", product)


def test_short_run_on_reference_arrays_gives_the_same_accuracies(reference_product):
    tcfg_kw = dict(epochs=2, batches_per_epoch=3, batch=8, t_steps=20, assign_batches=2,
                   eval_batches=2, seed=3)
    net_kw = dict(n_hidden=20, theta_plus=0.05, hard_wta=True)
    jcfg = JS.mnist_2layer("itp", backend="fused_interpret", **net_kw)
    jt = JT.TrainerConfig(**tcfg_kw)
    sampler, n_classes = JC.sampler_for("2layer-snn")
    ref = JT.train_to_accuracy(jcfg, sampler, n_classes, jt)
    source = ReplaySource(jcfg, jt, sampler)
    tcfg = TS.mnist_2layer("itp", backend="fused", **net_kw)
    got = TT.train_to_accuracy(tcfg, TC.sampler_for("2layer-snn")[0], n_classes,
                               TT.TrainerConfig(**tcfg_kw), device="cpu", source=source)
    assert got["accuracy_curve"] == ref["accuracy_curve"]
    np.testing.assert_allclose(got["mean_eval_rates"], ref["mean_eval_rates"], rtol=1e-6)
    assert set(got) == set(ref)
    for k in ("net", "rule", "epochs", "batch", "t_steps", "sim_steps", "chance"):
        assert got[k] == ref[k]
    np.testing.assert_array_equal(got["state"].weights[0].numpy(),
                                  np.asarray(ref["state"].weights[0]))
    # θ·decay + θ+·rate: the reference's compiled step fuses it into one FMA
    # (one rounding where the port rounds twice)
    np.testing.assert_allclose(got["state"].layers[0].theta.numpy(),
                               np.asarray(ref["state"].layers[0].theta), rtol=1e-6, atol=0)


def test_bench_accuracy_protocol_on_reference_arrays(reference_product):
    """BENCH_accuracy.json's 2layer-snn protocol (6 epochs × 8 batches × 16 ×
    30 steps, theta_plus 0.05, hard WTA) on the reference's arrays: the port's
    curve is the JAX package's, epoch for epoch."""
    bench = json.loads((ROOT / "BENCH_accuracy.json").read_text())["train_to_accuracy"]
    proto = bench["protocol"]
    tcfg_kw = {k: proto[k] for k in ("epochs", "batches_per_epoch", "batch", "t_steps",
                                     "assign_batches", "eval_batches", "seed")}
    net_kw = dict(theta_plus=proto["theta_plus"], hard_wta=proto["hard_wta"])
    jcfg, jt = JS.mnist_2layer("itp", **net_kw), JT.TrainerConfig(**tcfg_kw)
    sampler, n_classes = JC.sampler_for(bench["net"])
    ref = JT.train_to_accuracy(jcfg, sampler, n_classes, jt)
    got = TT.train_to_accuracy(TS.mnist_2layer("itp", backend="fused", **net_kw),
                               TC.sampler_for(bench["net"])[0], n_classes,
                               TT.TrainerConfig(**tcfg_kw), device="cpu",
                               source=ReplaySource(jcfg, jt, sampler))
    assert len(got["accuracy_curve"]) == proto["epochs"]
    assert got["accuracy_curve"] == ref["accuracy_curve"]
    assert got["final_accuracy"] > 4 * got["chance"]
    np.testing.assert_array_equal(got["state"].weights[0].numpy(),
                                  np.asarray(ref["state"].weights[0]))


def test_default_source_is_seeded():
    tcfg = TT.TrainerConfig(epochs=1, batches_per_epoch=2, batch=4, t_steps=5,
                            assign_batches=1, eval_batches=1, seed=7)
    src = TT.SamplerSource(TC.sampler_for("2layer-snn")[0], tcfg)
    a, b = list(src.train_batches(0)), list(src.train_batches(0))
    assert len(a) == 2 and all(torch.equal(x["spikes"], y["spikes"]) for x, y in zip(a, b))
    assert not torch.equal(a[0]["spikes"], next(src.train_batches(1))["spikes"])
    assert not torch.equal(next(src.held_out_batches(0, "assign"))["spikes"],
                           next(src.held_out_batches(0, "eval"))["spikes"])
    with pytest.raises(ValueError, match="fold"):
        src.held_out_batches(0, "test")


# ---------------------------------------------------------------------------
# CLI builders and the launcher
# ---------------------------------------------------------------------------

FLAGS = [
    [],
    ["--hidden", "30", "--theta-plus", "0.05", "--hard-wta", "--backend", "fused"],
    ["--theta-tau", "50", "--rule", "itp_nocomp", "--seed", "4", "--t-raster", "12"],
]


def _parse(mod, flags, net):
    ap = argparse.ArgumentParser()
    mod.add_net_flag(ap, "--snn", default=None)
    mod.add_update_flags(ap)
    mod.add_train_flags(ap)
    return ap.parse_args(["--snn", net, *flags])


@pytest.mark.parametrize("net", ["2layer-snn", "6layer-dcsnn", "5layer-csnn"])
@pytest.mark.parametrize("flags", FLAGS, ids=["defaults", "hidden-wta", "nocomp"])
def test_cli_builds_the_reference_configs(net, flags):
    jargs, targs = _parse(JC, flags, net), _parse(TC, flags, net)
    jcfg, tcfg = JC.snn_config_from_args(jargs), TC.snn_config_from_args(targs)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(TC.trainer_config_from_args(targs)) == dataclasses.asdict(
        JC.trainer_config_from_args(jargs))


@pytest.mark.parametrize("net", ["2layer-snn", "6layer-dcsnn", "5layer-csnn"])
def test_cli_inhibition_overrides_the_maker_default(net):
    """--inhibition reaches every net (the reference's 2layer-snn maker raises
    a duplicate-keyword TypeError on it; ROADMAP, reference caveats)."""
    cfg = TC.snn_config_from_args(_parse(TC, ["--inhibition", "0.2"], net))
    assert cfg.inhibition == 0.2
    if net != "2layer-snn":
        jcfg = JC.snn_config_from_args(_parse(JC, ["--inhibition", "0.2"], net))
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)


def test_cli_maps_total_steps_like_the_reference():
    ns = argparse.Namespace(snn="5layer-csnn", steps=95, batch=2)
    assert dataclasses.asdict(TC.trainer_config_from_args(ns)) == dataclasses.asdict(
        JC.trainer_config_from_args(ns))
    assert TC.net_from_args(ns) == "5layer-csnn"
    with pytest.raises(ValueError, match="no network"):
        TC.net_from_args(argparse.Namespace())
    assert set(TC.SAMPLERS) == set(JC.SAMPLERS)
    assert {n: TC.sampler_for(n)[1] for n in TC.SAMPLERS} == {
        n: JC.sampler_for(n)[1] for n in JC.SAMPLERS}


def test_launcher_trains_a_net_on_cpu(capsys):
    summary = TL.main(["--snn", "5layer-csnn", "--device", "cpu", "--backend", "fused",
                       "--epochs", "1", "--batches-per-epoch", "1", "--batch", "2",
                       "--t-raster", "6", "--assign-batches", "1", "--eval-batches", "1"])
    assert summary["net"] == "5layer-csnn" and summary["device"] == "cpu"
    assert summary["sops_per_s"] > 0 and np.isfinite(summary["mean_rate"])
    assert "snn training [5layer-csnn / itp / fused / cpu]" in capsys.readouterr().out
    cfg = TS.fault_csnn()
    assert TL.synaptic_updates_per_step(cfg, 2) == 2 * (253 * 14 * 8 + 61 * 40 * 16 + 480 * 64)


def test_launcher_needs_the_snn_mode(tmp_path):
    """Without ``--snn`` or ``--engine`` the launcher runs the LM mode (ROADMAP
    item 18c), on a data-parallel mesh too (item 18d): no net is trained."""
    summary = TL.main(["--device", "cpu", "--smoke", "--data", "1", "--model", "1",
                       "--steps", "2", "--batch", "2", "--seq", "8", "--ckpt-dir",
                       str(tmp_path)])
    assert "net" not in summary and summary["arch"] == "qwen3-0.6b"
    assert summary["mesh"] == "data=1 × model=1" and np.isfinite(summary["final_loss"])
