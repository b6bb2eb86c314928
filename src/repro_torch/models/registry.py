"""Unified model API: ``build_model(cfg, device)`` and ``input_specs(cfg,
shape)`` / ``decode_input_specs(cfg, shape)``.

The input specs are tensors on the ``meta`` device, the counterparts of
the reference's ``ShapeDtypeStruct`` stand-ins: every model input of a
given (arch x shape) cell with its shape and dtype and no storage, so a
full-size cell costs no memory.  Modality frontends are stubs: whisper
gets precomputed frame embeddings, llava precomputed patch embeddings.
"""
from __future__ import annotations

from typing import Any, Dict, Union

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import DeviceLike, torch_dtype
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.transformer import DecoderLM

META = torch.device("meta")


def build_model(cfg: ModelConfig, device: DeviceLike = None, **kw
                ) -> Union[DecoderLM, EncDecLM]:
    """The model for ``cfg``: :class:`EncDecLM` for the encdec family
    (``kw``: seed, generator), else the decoder LM (dense, moe, ssm, hybrid
    or vlm; ``kw`` goes to :class:`DecoderLM`: seed, generator,
    expert_device).  On ``device="meta"`` it holds shapes only: nothing
    is drawn or allocated."""
    if cfg.family == "encdec":
        return EncDecLM(cfg, device, **kw)
    return DecoderLM(cfg, device, **kw)


def _meta(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg: ModelConfig, shape: ShapeConfig
                ) -> Dict[str, torch.Tensor]:
    """Meta tensors for the inputs of a train / prefill forward pass."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    dt = torch_dtype(cfg.dtype)
    if cfg.family == "encdec":
        specs = {"tokens": _meta((B, S), i32),
                 "frames": _meta((B, cfg.encoder_seq, cfg.d_model), dt)}
    elif cfg.family == "vlm":
        # total positions = patches + text; the text shrinks so the cell's
        # seq_len is the end-to-end sequence length
        text = max(1, S - cfg.num_patches)
        specs = {"tokens": _meta((B, text), i32),
                 "patch_embeds": _meta((B, cfg.num_patches, cfg.d_model),
                                       dt)}
    else:
        specs = {"tokens": _meta((B, S), i32)}
    if shape.kind == "train":
        specs["labels"] = _meta(specs["tokens"].shape, i32)
    return specs


def decode_input_specs(cfg: ModelConfig, shape: ShapeConfig
                       ) -> Dict[str, Any]:
    """Inputs of one serve step: the new token, the cache of seq_len (the
    model's ``init_cache`` on the meta device) and the position."""
    B = shape.global_batch
    cache = build_model(cfg, device=META).init_cache(B, shape.seq_len)
    return {"tokens": _meta((B, 1), torch.int32), "cache": cache,
            "pos": _meta((), torch.int32)}
