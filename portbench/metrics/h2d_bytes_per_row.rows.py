"""Bytes copied from host to card per input row (the engine's counter
``device_transfer_bytes_h2d`` over the window)."""


def read(ctx):
    if ctx.counters is None or not ctx.rows:
        return None
    return ctx.counters.get("device_transfer_bytes_h2d", 0) / ctx.rows
