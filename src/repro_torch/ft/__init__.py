"""Fault tolerance: checksummed artefact stores (``artefacts``), the step
watchdog, the NaN guard and the train loop (``resilience``)."""
