"""Share (%) of the profiler session's wall in which no kernel, copy or
set ran on the card (the union of their intervals), serving cells."""


def read(record):
    s = record.get("session")
    if not s or "requests" not in s:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
