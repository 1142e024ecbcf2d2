"""Checkpointing (the port of ``repro.ckpt``)."""
