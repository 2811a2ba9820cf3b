"""Set-up seconds: process start to the window's start (imports, loading
the built kernels, weights on the card, inputs, warming up the cell's own
shapes and, in a training cell, the check steps)."""


def read(record):
    return record["setup_s"]
