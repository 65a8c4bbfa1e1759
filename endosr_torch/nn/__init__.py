"""Networks of the port (counterpart of ``endosr.nn``)."""
