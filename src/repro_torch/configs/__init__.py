"""Config registry: one module per ported architecture."""
import importlib

from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, MoRConfig, ShapeSpec, SHAPES, get_config, input_specs,
    list_archs, param_count, reduce_config, register,
)

_MODULES = [
    "qwen1_5_110b", "granite_20b", "granite_3_2b", "qwen2_7b",
    "deepseek_v2_236b", "mixtral_8x7b", "rwkv6_3b", "phi_3_vision_4_2b",
    "zamba2_7b", "hubert_xlarge", "paper_dnns",
]

_loaded = False


def load_all():
    global _loaded
    if _loaded:
        return
    for m in _MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")
    _loaded = True
