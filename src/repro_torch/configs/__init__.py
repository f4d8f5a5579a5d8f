"""Published configurations, copied from ``repro.configs``.

The paper's dataset configs (``gooaq``, ``pubmed23``) and the model zoo's
ten architectures.  ``get_config(name)`` returns the full published
config; ``smoke=True`` returns the reduced same-family config the CPU
tests use.  ``SHAPES`` and ``shape_applicable`` are the input shape set
and its skip rules (long_500k needs sub-quadratic attention).  Only the
dense architectures run in the port so far (ROADMAP module 13).
"""

from __future__ import annotations

import importlib
from typing import Dict, Tuple

from repro_torch.models.config import ModelConfig

ARCH_IDS = (
    "whisper_small",
    "yi_34b",
    "gemma3_1b",
    "nemotron_4_340b",
    "granite_3_8b",
    "jamba_v01_52b",
    "llava_next_34b",
    "mamba2_780m",
    "mixtral_8x22b",
    "granite_moe_1b",
)

# (seq_len, global_batch, kind): kind "train" is a train step, "prefill" a
# prefill, "decode" a serve step with a seq_len cache.
SHAPES: Dict[str, Tuple[int, int, str]] = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    key = name.replace("-", "_")
    if key not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; have {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{key}")
    return mod.SMOKE if smoke else mod.CONFIG


def shape_applicable(cfg: ModelConfig, shape: str) -> Tuple[bool, str]:
    """(runs?, reason-if-skipped) per the assignment's rules."""
    if shape == "long_500k":
        has_window = any(s.window > 0 for s in cfg.pattern)
        has_ssm = any(s.mixer == "mamba" for s in cfg.pattern)
        if not (has_window or has_ssm):
            return False, (
                "pure full-attention arch: 512k decode needs sub-quadratic "
                "attention / bounded KV (see DESIGN.md §Arch-applicability)"
            )
    return True, ""
