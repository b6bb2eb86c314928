"""Unified model construction: ``build_model(cfg, device)``."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike
from repro_torch.models.transformer import DecoderLM


def build_model(cfg: ModelConfig, device: DeviceLike = None, **kw) -> DecoderLM:
    """The decoder LM for ``cfg``: dense, moe, ssm, hybrid or vlm
    (encoder-decoder models are not ported yet).  ``kw`` goes to
    :class:`DecoderLM` (seed, generator, expert_device)."""
    if cfg.family == "encdec":
        raise NotImplementedError("encoder-decoder models are not ported yet")
    return DecoderLM(cfg, device, **kw)
