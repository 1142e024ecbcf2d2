"""repro_torch.analysis: the op-stream counter (``hlo_counter``, the port
of the reference's HLO counter) and the roofline terms read from it
(``hlo``)."""
