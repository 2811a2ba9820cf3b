"""The window's model operations (``work.request_flops``) over its wall
time, as a share (%) of the card's peak in the configuration's dtype."""

from port_bench import work


def read(record):
    reqs = record.get("requests")
    if not reqs:
        return None
    flops = sum(work.request_flops(record["config"], r["samples"], r["frames"], r["steps"]) for r in reqs)
    return 100.0 * flops / record["window_s"] / work.PEAK_FLOPS[record["dtype"]]
