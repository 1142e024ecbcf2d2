"""The port's serving layer: the static-batch engine of ``repro.serve``."""
