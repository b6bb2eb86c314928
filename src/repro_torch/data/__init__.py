"""The synthetic data pipeline of the PyTorch port (mirrors ``repro.data``)."""
