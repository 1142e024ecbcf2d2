"""Core of the port: the DPIA compiler (``core.dpia``)."""
