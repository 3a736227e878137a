"""The LM family's system under test: the port's training step
(``repro_torch/train/train_step.py``) built as ``launch/train.py`` builds it,
``make_train_step(cfg, OptimizerConfig(...), TrainConfig(remat=...))`` with
ITP-AdamW on kernels 9-10 (``use_kernel=True``), over a parameter tree the
benchmark hands it.

Each trainer holds its state and runs the window's call, :meth:`step`, on
one batch.  :meth:`recording` shows what one call did: the loss and the
gradients as ``train_step.loss_and_grads`` returned them, and whether
``train_step.adamw_update`` ran.  Both are wrapped by name while the
recording lasts, so a program that stops calling them reads not correct.

:class:`ReferenceTrainer` is the control: the plain reference
(``reference/lm.py``) in the program's place, its products' operands in
float8, driven and recorded alike.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from port_bench.reference import lm as ref

# the configuration file's keys (Hugging Face names) → the port's ModelConfig
WIDTHS = {"num_hidden_layers": "n_layers", "hidden_size": "d_model",
          "num_attention_heads": "n_heads", "num_key_value_heads": "n_kv_heads",
          "head_dim": "head_dim", "intermediate_size": "d_ff", "vocab_size": "vocab_size",
          "rms_norm_eps": "norm_eps", "rope_theta": "rope_theta",
          "tie_word_embeddings": "tie_embeddings", "attention_bias": "qkv_bias"}


def model_config(cfg: dict):
    """The port's ``ModelConfig`` of the architecture ``cfg["arch"]`` with the
    file's sizes and dtypes: the configuration as it is run."""
    from repro_torch.configs import get_config

    return dataclasses.replace(
        get_config(cfg["arch"]), dtype=cfg["assumed"]["compute_dtype"],
        param_dtype=cfg["assumed"]["param_dtype"],
        **{port: cfg[key] for key, port in WIDTHS.items()})


def _itp_adamw(traffic: dict) -> None:
    if traffic["optimizer"] != "itp-adamw":
        raise ValueError(f"the LM family trains with itp-adamw, not {traffic['optimizer']!r}")


class ProgramTrainer:
    """The port's training step and its state on ``device``."""

    def __init__(self, cfg: dict, traffic: dict, params: dict, device: torch.device):
        from repro_torch.train import train_step
        from repro_torch.train.optimizer import OptimizerConfig, init_opt_state

        _itp_adamw(traffic)
        self.train_step = train_step
        self.step_fn = train_step.make_train_step(
            model_config(cfg),
            OptimizerConfig(**cfg["assumed"]["optimizer"], po2_update=True),
            train_step.TrainConfig(remat=traffic["remat"], z_loss=cfg["assumed"]["z_loss"]),
            use_kernel=True)
        self.params, self.opt = params, init_opt_state(params)

    def step(self, batch: dict) -> None:
        self.params, self.opt, _ = self.step_fn(self.params, self.opt, batch)

    def state(self) -> dict:
        """``{"params", "step", "mu", "nu"}``, the trees as the program holds them."""
        return {"params": self.params, "step": self.opt.step, "mu": self.opt.mu,
                "nu": self.opt.nu}

    @contextlib.contextmanager
    def recording(self):
        ts = self.train_step
        lg, update = ts.loss_and_grads, ts.adamw_update
        seen: dict = {}

        def recorded_loss_and_grads(*args, **kwargs):
            loss, metrics, grads = lg(*args, **kwargs)
            seen.update(loss=loss, grads=grads)
            return loss, metrics, grads

        def recorded_update(*args, **kwargs):
            seen["updated"] = True
            return update(*args, **kwargs)

        ts.loss_and_grads, ts.adamw_update = recorded_loss_and_grads, recorded_update
        try:
            yield seen
        finally:
            ts.loss_and_grads, ts.adamw_update = lg, update


class ReferenceTrainer:
    """The control: the reference's step, its products' operands in float8,
    with the reference's ITP-AdamW."""

    def __init__(self, cfg: dict, traffic: dict, params: dict, device: torch.device):
        _itp_adamw(traffic)
        self.cfg, self.opt_cfg = cfg, cfg["assumed"]["optimizer"]
        self.params, self.opt = params, ref.fresh_state(params, device)
        self.seen: dict | None = None

    def step(self, batch: dict) -> None:
        loss, grads = ref.loss_and_grads(self.params, self.cfg, batch,
                                         self.cfg["assumed"]["z_loss"], low=True)
        if self.seen is not None:
            self.seen.update(loss=torch.tensor(loss), grads=grads, updated=True)
        self.params, self.opt = ref.itp_adamw(self.opt_cfg, self.params, grads, self.opt)

    def state(self) -> dict:
        return {"params": self.params, **self.opt}

    @contextlib.contextmanager
    def recording(self):
        self.seen = {}
        try:
            yield self.seen
        finally:
            self.seen = None
