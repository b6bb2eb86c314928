"""runtime of the PyTorch port (mirrors ``repro.runtime``)."""
