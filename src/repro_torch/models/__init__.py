"""The port's model zoo: the dense transformer of ``repro.models``."""
