"""Measurement scripts of ribca_tpu_torch, run with ``python -m``."""
