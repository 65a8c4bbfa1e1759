"""Image and depth metrics of the port (counterpart of
``endosr.metrics``)."""
