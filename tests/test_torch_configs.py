"""The LM configs and their parameter counts (ROADMAP item 18a): the port's
``repro_torch.configs`` and ``repro_torch.models.config`` against the JAX
package's, field for field, and the reference's count tests mirrored.  The
port registers one architecture more, granite-4.0-h-micro (an
``InterleavedConfig``, held to its published widths and to a plain
reference in ``test_torch_granite.py``); the ten stay the JAX package's.
The configs are shapes only: nothing is downloaded."""
import dataclasses
import importlib.util
from pathlib import Path

import pytest

from repro import configs as J
from repro_torch import configs as T
from repro_torch.configs import (granite_4_0_h_micro, hymba_1_5b, llama32_vision_11b,
                                 mamba2_1_3b, musicgen_medium, phi35_moe_42b, qwen2_1_5b,
                                 qwen2_moe_a2_7b, qwen3_0_6b, qwen15_32b, yi_9b)
from repro_torch.models.config import ModelConfig

ROOT = Path(__file__).resolve().parents[1]


def test_the_registry_names_the_reference_archs():
    assert T.ARCH_NAMES[:10] == J.ARCH_NAMES and len(J.ARCH_NAMES) == 10
    assert T.ARCH_NAMES[10:] == ("granite-4.0-h-micro",)
    assert {k: dataclasses.asdict(v) for k, v in T.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in J.SHAPES.items()}
    with pytest.raises(KeyError, match="unknown arch"):
        T.get_config("gpt-5")
    with pytest.raises(KeyError, match="unknown arch"):
        T.get_smoke_config("gpt-5")


def _read(cfg, prop):
    """A property's value, or the type of what it raises (mamba2 has no
    attention heads, so its head width divides by zero in both packages)."""
    try:
        return getattr(cfg, prop)
    except ArithmeticError as e:
        return type(e)


@pytest.mark.parametrize("arch", J.ARCH_NAMES)
def test_config_equals_the_reference_field_for_field(arch):
    for get in ("get_config", "get_smoke_config"):
        port, ref = getattr(T, get)(arch), getattr(J, get)(arch)
        assert isinstance(port, ModelConfig)
        assert type(port).__module__ == "repro_torch.models.config"
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.param_count() == ref.param_count()
        assert port.active_param_count() == ref.active_param_count()
        for prop in ("resolved_head_dim", "d_inner", "ssm_heads", "has_attention",
                     "has_ssm", "is_moe", "experts_alloc", "supports_long_context"):
            assert _read(port, prop) == _read(ref, prop), prop
    assert T.all_configs()[arch] is T.get_config(arch)


ARCH_MODULES = (llama32_vision_11b, qwen15_32b, yi_9b, qwen3_0_6b, qwen2_1_5b, hymba_1_5b,
                qwen2_moe_a2_7b, phi35_moe_42b, mamba2_1_3b, musicgen_medium,
                granite_4_0_h_micro)


def test_the_registry_loads_each_arch_module():
    for arch, module in zip(T.ARCH_NAMES, ARCH_MODULES, strict=True):
        assert T._MODULES[arch] == module.__name__
        assert T.get_config(arch) is module.CONFIG
        assert T.get_smoke_config(arch) is module.SMOKE


@pytest.mark.parametrize("arch", J.ARCH_NAMES)
def test_each_arch_file_keeps_its_published_source(arch):
    module = T._MODULES[arch].rsplit(".", 1)[1]
    port = (ROOT / "src" / "repro_torch" / "configs" / f"{module}.py").read_text()
    ref = (ROOT / "src" / "repro" / "configs" / f"{module}.py").read_text()
    assert port.split('"""')[1] == ref.split('"""')[1]


@pytest.mark.parametrize("arch,target,tol", [
    ("qwen1.5-32b", 32.5e9, 0.15),
    ("yi-9b", 8.8e9, 0.15),
    ("qwen3-0.6b", 0.6e9, 0.4),
    ("qwen2-1.5b", 1.5e9, 0.3),
    ("mamba2-1.3b", 1.3e9, 0.3),
    ("phi3.5-moe-42b-a6.6b", 42e9, 0.15),
])
def test_param_counts_match_published(arch, target, tol):
    n = T.get_config(arch).param_count()
    assert abs(n - target) / target < tol, f"{arch}: {n / 1e9:.2f}B"


def test_moe_active_params():
    cfg = T.get_config("phi3.5-moe-42b-a6.6b")
    active = cfg.active_param_count()
    assert abs(active - 6.6e9) / 6.6e9 < 0.3, f"{active / 1e9:.2f}B"


def test_shapes_for_respects_long_context():
    for arch in T.ARCH_NAMES:
        cfg = T.get_config(arch)
        names = [s.name for s in T.shapes_for(cfg)]
        if arch in ("mamba2-1.3b", "hymba-1.5b"):
            assert "long_500k" in names
        else:
            assert "long_500k" not in names


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_smoke_qwen3_tree_reads_the_port_config():
    """The side-numerics phase's ITP-AdamW tree: qwen3-0.6b's leaf shapes,
    widths from the port's config.  At all 28 layers it holds param_count()
    plus the 28 × 2 × 128 q/k norm scales the reference's "norms (approx)"
    term leaves out; the phase's 2-layer cut is 187 M parameters."""
    smoke = _chip_smoke()
    cfg = T.get_config("qwen3-0.6b")

    def total(tree):
        if isinstance(tree, dict):
            return sum(total(v) for v in tree.values())
        n = 1
        for d in tree:
            n *= d
        return n

    assert cfg.param_count() == 596_042_752
    assert total(smoke._qwen3_shapes(28)) == 596_049_920 == cfg.param_count() + 28 * 2 * 128
    assert total(smoke._qwen3_shapes(smoke.QWEN3_LAYERS)) == 187_045_376
