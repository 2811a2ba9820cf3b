"""Mean ms of a request's ``SAIDPipeline.prepare`` (encoder, K/V caches,
timestep table), each timed synchronised, over the traced window."""


def read(record):
    spans = [r["prepare_s"] for r in record.get("requests", []) if "prepare_s" in r]
    return 1e3 * sum(spans) / len(spans) if spans else None
