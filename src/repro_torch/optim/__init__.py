"""Optimizers and gradient compression of the PyTorch port (mirrors ``repro.optim``)."""
