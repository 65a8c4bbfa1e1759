"""Model wrappers of the port (counterpart of ``endosr.models``)."""
