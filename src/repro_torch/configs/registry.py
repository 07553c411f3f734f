"""Architecture registry: ``--arch <id>`` resolution + shape applicability."""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig
from repro_torch.configs.shapes import SHAPES, ShapeSpec

# arch id -> module name under repro_torch.configs
_MODULES = {
    "deepseek-moe-16b": "deepseek_moe_16b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "xlstm-125m": "xlstm_125m",
    "qwen3-1.7b": "qwen3_1p7b",
    "qwen1.5-4b": "qwen1p5_4b",
    "gemma2-27b": "gemma2_27b",
    "olmo-1b": "olmo_1b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "internvl2-1b": "internvl2_1b",
}

ARCH_IDS: tuple[str, ...] = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    try:
        mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    except KeyError as e:
        raise ValueError(f"unknown arch {arch!r}; choose from {ARCH_IDS}") from e
    return mod.config()


def shape_skip_reason(cfg: ModelConfig, shape: ShapeSpec | str) -> str | None:
    """None if the (arch, shape) cell runs; otherwise the documented skip.

    Per the brief + DESIGN.md §5: long_500k needs sub-quadratic attention —
    it runs only for the SSM/hybrid archs and is skipped for pure
    full-attention architectures.
    """
    if isinstance(shape, str):
        shape = SHAPES[shape]
    if shape.name == "long_500k" and not cfg.subquadratic:
        return ("skip: long_500k requires sub-quadratic attention; "
                f"{cfg.name} has quadratic global-attention layers")
    return None
