"""The port stands alone: no file under src/repro_torch/, and not
chip_smoke.py, imports jax or the JAX package; the entry points (serving,
training, the engine launcher, session restore, the sharded engine's
process group, the graph audit, LM training and the launcher's LM mode) run
on CUDA unless the caller passes device="cpu", and raise on a host without
CUDA."""
import argparse
import ast
from pathlib import Path

import pytest
import torch

from repro_torch.analysis.graph_audit import audit_cell, cell_program, run_audit
from repro_torch.configs import get_smoke_config
from repro_torch.core.engine import EngineConfig, init_engine, init_engine_population
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import init_process_group
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.launch.cli import sampler_for
from repro_torch.models.snn import fault_csnn, init_snn
from repro_torch.serve import ServeConfig, Server, SessionStore
from repro_torch.train import OptimizerConfig, init_training
from repro_torch.train.stdp_trainer import TrainerConfig, train_to_accuracy

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_neither_jax_nor_reference(path):
    assert not _imported_roots(path) & FORBIDDEN


def test_scan_sees_the_whole_port():
    assert len(PORT_FILES) >= 20
    assert ROOT / "src" / "repro_torch" / "kernels" / "itp_stdp" / "kernel.py" in PORT_FILES
    assert ROOT / "src" / "repro_torch" / "models" / "snn.py" in PORT_FILES
    assert {"torch"} <= _imported_roots(ROOT / "src" / "repro_torch" / "core" / "engine.py")


def test_entry_points_default_to_cuda():
    cfg = EngineConfig(n_pre=4, n_post=3)
    entry = (lambda: init_engine(cfg), lambda: init_engine_population(cfg, 2),
             lambda: SessionStore(cfg), lambda: Server(cfg, ServeConfig()))
    if torch.cuda.is_available():
        assert init_engine(cfg).w.device.type == "cuda"
        assert SessionStore(cfg).device.type == "cuda"
        return
    for make in entry:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert init_engine(cfg, device="cpu").w.device.type == "cpu"
    assert SessionStore(cfg, device="cpu").device == torch.device("cpu")


def test_training_entry_points_default_to_cuda():
    cfg = fault_csnn(length=64)
    tcfg = TrainerConfig(epochs=1, batches_per_epoch=1, batch=1, t_steps=2,
                         assign_batches=1, eval_batches=1)
    sampler, n_classes = sampler_for("5layer-csnn")
    argv = ["--snn", "5layer-csnn", "--epochs", "1", "--batches-per-epoch", "1",
            "--batch", "1", "--t-raster", "2", "--assign-batches", "1", "--eval-batches", "1"]
    entry = (lambda: init_snn(cfg, 2), lambda: train_to_accuracy(cfg, sampler, n_classes, tcfg),
             lambda: launch_train.main(argv))
    if torch.cuda.is_available():
        assert init_snn(cfg, 2).weights[0].device.type == "cuda"
        return
    for make in entry:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert init_snn(cfg, 2, device="cpu").weights[0].device.type == "cpu"


def test_resolve_device_rejects_other_devices():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_engine_launcher_ckpt_and_grid_entry_points_default_to_cuda(tmp_path):
    """The engine launcher, the serving launcher with --ckpt-dir and the
    sharded engine's process group."""
    engine = argparse.Namespace(rule="itp", backend="fused", engine_pre=8, engine_post=8,
                                replicas=1, steps=2, engine_rate=0.3)
    entry = (lambda: launch_train.run_engine_training(engine),
             lambda: launch_train.main(["--engine", "--replicas", "1", "--engine-pre", "8",
                                        "--engine-post", "8", "--steps", "2"]),
             lambda: launch_serve.main(["--ckpt-dir", str(tmp_path), "--requests", "1"]),
             lambda: init_process_group("cuda", rank=0, world_size=1,
                                        init_method=f"file://{tmp_path}/store"))
    if torch.cuda.is_available():
        assert launch_train.run_engine_training(engine)["device"].startswith("cuda")
        return
    for make in entry:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    engine.device = "cpu"
    assert launch_train.run_engine_training(engine)["device"] == "cpu"


def test_audit_and_lm_training_entry_points_default_to_cuda(tmp_path):
    """The graph audit's three functions, ``init_training`` and the
    launcher's LM mode."""
    cfg = get_smoke_config("qwen3-0.6b")
    lm_argv = ["--smoke", "--steps", "1", "--batch", "1", "--seq", "8",
               "--ckpt-dir", str(tmp_path)]
    entry = (lambda: cell_program("itp", "fused", "engine"),
             lambda: audit_cell("itp", "fused", "engine"),
             lambda: run_audit(kinds=("engine",)),
             lambda: init_training(torch.Generator(), cfg, OptimizerConfig()),
             lambda: launch_train.main(lm_argv))
    if torch.cuda.is_available():
        params, _ = init_training(torch.Generator("cuda"), cfg, OptimizerConfig())
        assert params["embed"]["tok"].device.type == "cuda"
        return
    for make in entry:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    params, state = init_training(torch.Generator(), cfg, OptimizerConfig(), device="cpu")
    assert params["embed"]["tok"].device.type == "cpu" and state.step.device.type == "cpu"
    assert audit_cell("itp", "fused", "engine", device="cpu")["violations"] == []
    assert launch_train.main(lm_argv + ["--device", "cpu"])["device"] == "cpu"
