"""Tests of the benchmark harness; they run on the CPU (those that
need a card are marked ``cuda`` and skip without one)."""
