"""cli of the PyTorch port (see ssi_tpu_torch/__init__.py)."""
