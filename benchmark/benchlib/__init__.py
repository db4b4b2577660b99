"""The benchmark's own library: manifest lookup, traffic generation, weights
from the seed, work counts, peaks, trace reduction and the cell drivers.

It imports the measured program (`tokenpacker_tpu_torch`) only inside the
drivers and `model.py`; nothing here imports JAX or the JAX package.
"""
