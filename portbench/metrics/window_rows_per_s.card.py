"""``rows_per_s`` reported per layer, in a cell where the host's drift
leaves it too unsteady to bound: rows whose effect reached the sink,
per second from the first row handed over to the last result at the
sink."""

from portbench.metrics.rows_per_s import read  # noqa: F401
