"""Hand-written Hopper (sm_90a) CUDA kernels, each beside its
plain-torch version: B1 ``encode``, B2 ``bitpack``, B3/B4/B6 ``decode``,
B5 ``histogram``, B7/B8 ``decode_matmul``.  Sources in ``csrc/``;
``build`` compiles them at first use."""
