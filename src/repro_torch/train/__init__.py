"""The train step (the port of ``repro.train``)."""
