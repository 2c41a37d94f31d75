"""Architecture configs (--arch <id>), the port's copies of ``repro.configs``.

Each module defines CONFIG with the same fields and values as its reference
twin (pinned by tests/test_torch_model.py).  ``get_config(name)`` returns a
fresh ModelConfig.
"""
import dataclasses
import importlib

ARCHS = [
    "gemma_7b",
    "chatglm3_6b",
    "deepseek_7b",
    "qwen2_1_5b",
    "internvl2_26b",
    "hymba_1_5b",
    "mamba2_2_7b",
    "granite_moe_3b_a800m",
    "deepseek_v2_lite_16b",
    "whisper_tiny",
]

_ALIASES = {a.replace("_", "-"): a for a in ARCHS}
_ALIASES.update({"qwen2-1.5b": "qwen2_1_5b", "mamba2-2.7b": "mamba2_2_7b",
                 "hymba-1.5b": "hymba_1_5b", "internvl2-26b": "internvl2_26b",
                 "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
                 "granite-moe-3b-a800m": "granite_moe_3b_a800m",
                 "whisper-tiny": "whisper_tiny", "gemma-7b": "gemma_7b",
                 "chatglm3-6b": "chatglm3_6b", "deepseek-7b": "deepseek_7b"})


def get_config(name: str):
    key = _ALIASES.get(name, name)
    mod = importlib.import_module(f"repro_torch.configs.{key}")
    return dataclasses.replace(mod.CONFIG)


def all_configs():
    return {a: get_config(a) for a in ARCHS}
