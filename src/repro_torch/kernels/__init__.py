"""Hand-written Hopper (sm_90a) CUDA kernels of the wire, each beside
its plain-torch version: B1 ``encode``, B2 ``bitpack``, B3/B4 ``decode``.
Sources in ``csrc/``; ``build`` compiles them at first use."""
