"""Measurement tools of the port; each needs a CUDA device."""
