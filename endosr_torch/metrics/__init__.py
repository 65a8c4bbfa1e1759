"""Image metrics of the port (counterpart of ``endosr.metrics``)."""
