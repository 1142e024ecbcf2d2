"""Data pipelines (the port of ``repro.data``)."""
