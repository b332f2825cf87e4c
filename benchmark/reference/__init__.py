"""The benchmark's plain reference: what one Monte-Carlo round of a cell
must count, worked out again from the code's data file, the seed, the
SNR and the configuration, with plain PyTorch and numpy.

Each module is a frozen copy of one of the port's plain paths, taken at
commit f97303742a3ef9c90c8903c33bcd676948a22a11 and trimmed to what a
round needs; none imports ``faid_tpu_torch``, ``faid_tpu`` or JAX, and
none reads anything the program made.  ``round.py`` puts them together.
"""
