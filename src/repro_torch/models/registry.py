"""Unified model construction: ``build_model(cfg, device)``."""
from __future__ import annotations

from typing import Union

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.transformer import DecoderLM


def build_model(cfg: ModelConfig, device: DeviceLike = None, **kw
                ) -> Union[DecoderLM, EncDecLM]:
    """The model for ``cfg``: :class:`EncDecLM` for the encdec family
    (``kw``: seed, generator), else the decoder LM (dense, moe, ssm, hybrid
    or vlm; ``kw`` goes to :class:`DecoderLM`: seed, generator,
    expert_device)."""
    if cfg.family == "encdec":
        return EncDecLM(cfg, device, **kw)
    return DecoderLM(cfg, device, **kw)
