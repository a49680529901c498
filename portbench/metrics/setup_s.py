"""Seconds from the process's start to the start of the measured
window: imports, CUDA start-up, kernel loading (and, in a fresh
checkout, building), making the inputs, and the warm-up."""


def read(ctx):
    return ctx.setup_s
