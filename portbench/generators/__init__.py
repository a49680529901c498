"""Generators: one module per kind of data (``<name>.py``, loaded by
the name a configuration gives under ``"generator"``).

A generator module has ``Stream(cfg, traffic, seed)``: everything a
cell hands to the port, made at set-up from the seed alone, with the
same sizes for every seed.  What else a stream offers is between the
generator and the feeds, flows and references written for it; the
harness only passes it along.  A generator refuses a value of the
configuration or traffic that it does not implement.
"""
