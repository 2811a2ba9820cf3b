"""Seconds of audio turned into coefficients a second: all the window's
requests over the window's wall time."""


def read(record):
    if "requests" not in record:
        return None
    return sum(r["audio_s"] for r in record["requests"]) / record["window_s"]
