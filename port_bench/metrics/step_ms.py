"""ms a denoise step: each request's time less its prepare, summed over
the traced window, over all its steps."""


def read(record):
    reqs = [r for r in record.get("requests", []) if "prepare_s" in r]
    if not reqs:
        return None
    return 1e3 * sum(r["latency_s"] - r["prepare_s"] for r in reqs) / sum(r["steps"] for r in reqs)
