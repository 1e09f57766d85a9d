"""The users' entry points (port of the reference's ``examples/``), each
run as ``python -m repro_torch.examples.<name>`` with a ``main(argv=None,
*, device=None)`` that prints its lines and returns them as a record:
``quickstart`` (a fixed book from earlier data, single-stage encode and
decode, the three-stage oracle), ``serve_compressed`` (a small model
served, then its wire gathered bit-exact and ring-reduced) and
``train_sft_compressed`` (an SFT loop with the gradient probe and book
rebuilds)."""
