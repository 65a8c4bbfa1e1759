"""Tensor ops of the port (counterpart of ``endosr.ops``)."""
