"""Plain references, one module per configuration (``<config>.py``,
loaded by path), and the oracles and comparison they share."""
