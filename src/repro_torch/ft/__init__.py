"""Fault tolerance: checksummed artefact stores (``artefacts``)."""
