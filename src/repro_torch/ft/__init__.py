"""Fault tolerance: checksummed artefact stores (``artefacts``) and the
step watchdog with the NaN guard (``resilience``)."""
