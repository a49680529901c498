"""Execution engine: plan flattening, host driver, recovery store, and
the XLA acceleration tier."""
