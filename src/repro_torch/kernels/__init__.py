"""Hand-written Hopper kernels and their plain PyTorch versions.

``ops`` is the API the models call.  Each kernel module holds the kernel
(Triton source or a ``csrc/*.cu`` C entry point bound by ``_build``), its
wrapper and a launch counter; ``ref`` holds the plain versions.  A wrapper
given a CPU tensor computes the plain version; given a CUDA tensor it
launches its kernel or raises.
"""
