"""The kernels' refusal to run under autograd.

The port's kernels are loaded through ``ctypes`` (``kernels/_build.py``):
their outputs carry no ``grad_fn``, so a kernel called on an input that
requires grad would silently cut the gradient there.  The reference cannot
differentiate through its Pallas kernels either (no ``custom_vjp`` in its
``kernels/``).  So every wrapper calls ``refuse_autograd`` first, on the CPU
too (in front of the plain version), and the CPU and the card behave
alike: a kernel runs under ``torch.no_grad()`` or on inputs that do not
require grad, and raises otherwise.
"""
from __future__ import annotations

from typing import Optional

import torch


def refuse_autograd(kernel: str, *tensors: Optional[torch.Tensor],
                    note: str = ""):
    """Raise ``RuntimeError`` naming ``kernel`` when grad mode is on and one
    of ``tensors`` requires grad; ``note`` ends the message."""
    if not torch.is_grad_enabled():
        return
    if any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: the kernel has no backward and an input requires "
            f"grad; call it under torch.no_grad() or on inputs that do not "
            f"require grad{note}")
