"""Utilities of the port (counterpart of ``endosr.utils``)."""
