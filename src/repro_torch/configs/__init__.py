"""Config registry: one module per ported architecture."""
import importlib

from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, MoRConfig, get_config, reduce_config, register,
)

_MODULES = ["granite_3_2b", "deepseek_v2_236b", "paper_dnns"]

_loaded = False


def load_all():
    global _loaded
    if _loaded:
        return
    for m in _MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")
    _loaded = True
