"""Training losses of the port (counterpart of ``endosr.losses``)."""
