"""SP-MoE serving in PyTorch with hand-written CUDA kernels for Hopper.

A port of the JAX package ``repro`` (the reference), laid out the same way:
``configs``, ``core``, ``kernels``, ``models``, ``launch``.  Entry points run
on ``torch.device("cuda")`` unless the caller passes ``device="cpu"``; see
``repro_torch.device``.
"""
