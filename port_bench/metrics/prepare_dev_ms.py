"""Mean ms of a request's ``said.prepare`` span on the card's stream
(its start and end events), over the profiler session's requests."""

from port_bench import spans


def read(record):
    got = spans.session_spans(record)
    if not got:
        return None
    dev = spans.device_ms(spans.named(got, spans.PREPARE))
    return sum(dev) / len(dev) if dev else None
