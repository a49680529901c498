"""Rows whose effect reached the sink, per second from the first row
handed to the engine to the last result at the sink (host clock; all
the work and all the time of the window)."""


def read(ctx):
    if not ctx.window_s:
        return None
    return ctx.rows / ctx.window_s
