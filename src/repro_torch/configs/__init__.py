"""configs of the PyTorch port (mirrors ``repro.configs``)."""
