"""The hybrid family's system under test: the port's training step on an
interleaved Mamba-2/attention stack (``InterleavedConfig``, granite-4.0-h),
built as the LM family builds it (``lm_system.py``: ``make_train_step``
with ITP-AdamW on kernels 9-10, ``use_kernel=True``), recorded alike.

:class:`ReferenceTrainer` is the control: the plain reference
(``reference/granite.py``) in the program's place, its products' operands
in float8.
"""
from __future__ import annotations

import dataclasses

import torch

from port_bench import lm_system
from port_bench.reference import granite as ref
from port_bench.reference import lm as ref_lm

# the configuration file's keys (Hugging Face names) → the port's
# InterleavedConfig fields
WIDTHS = {"num_hidden_layers": "n_layers", "hidden_size": "d_model",
          "num_attention_heads": "n_heads", "num_key_value_heads": "n_kv_heads",
          "shared_intermediate_size": "d_ff", "vocab_size": "vocab_size",
          "rms_norm_eps": "norm_eps", "tie_word_embeddings": "tie_embeddings",
          "mamba_d_state": "ssm_state", "mamba_d_head": "ssm_head_dim",
          "mamba_expand": "ssm_expand", "mamba_n_groups": "ssm_groups",
          "mamba_d_conv": "d_conv", "mamba_chunk_size": "ssd_chunk",
          "embedding_multiplier": "embedding_multiplier",
          "attention_multiplier": "attention_multiplier",
          "residual_multiplier": "residual_multiplier", "logits_scaling": "logits_scaling"}


def model_config(cfg: dict):
    """The port's config of the architecture ``cfg["arch"]`` with the file's
    sizes, layer pattern and dtypes.  Raises ``SystemExit`` where the
    program has no such architecture."""
    from repro_torch.configs import get_config

    ref.dims(cfg)                    # the features both sides compute
    try:
        base = get_config(cfg["arch"])
    except KeyError as e:
        raise SystemExit(f"port_bench: the program has no architecture {cfg['arch']!r} "
                         f"(repro_torch.configs): {e}") from None
    return dataclasses.replace(
        base, dtype=cfg["assumed"]["compute_dtype"], param_dtype=cfg["assumed"]["param_dtype"],
        head_dim=cfg["assumed"]["head_dim"], layer_types=tuple(cfg["layer_types"]),
        **{port: cfg[key] for key, port in WIDTHS.items()})


class ProgramTrainer(lm_system.ProgramTrainer):
    """The port's training step on the interleaved stack and its state."""

    def __init__(self, cfg: dict, traffic: dict, params: dict, device: torch.device):
        from repro_torch.train import train_step
        from repro_torch.train.optimizer import OptimizerConfig, init_opt_state

        lm_system._itp_adamw(traffic)
        self.train_step = train_step
        self.step_fn = train_step.make_train_step(
            model_config(cfg),
            OptimizerConfig(**cfg["assumed"]["optimizer"], po2_update=True),
            train_step.TrainConfig(remat=traffic["remat"], z_loss=cfg["assumed"]["z_loss"]),
            use_kernel=True)
        self.params, self.opt = params, init_opt_state(params)


class ReferenceTrainer(lm_system.ReferenceTrainer):
    """The control: the Granite reference's step, its products' operands in
    float8, with the reference's ITP-AdamW."""

    def step(self, batch: dict) -> None:
        loss, grads = ref.loss_and_grads(self.params, self.cfg, batch,
                                         self.cfg["assumed"]["z_loss"], low=True)
        if self.seen is not None:
            self.seen.update(loss=torch.tensor(loss), grads=grads, updated=True)
        self.params, self.opt = ref_lm.itp_adamw(self.opt_cfg, self.params, grads, self.opt)
