"""Per-layer metric readers, one module per metric, named after it
(``<metric>.py``, loaded by path)."""
