"""ms a denoise step on the card's stream: the session's ``said.denoise``
spans' device time (from their start to their end events) summed, over
all their steps; the request's edges (audio, upload, prepare, download)
left out."""

from port_bench import spans


def read(record):
    got = spans.session_spans(record)
    if not got or not spans.steps(got):
        return None
    dev = spans.device_ms(spans.named(got, spans.DENOISE))
    return sum(dev) / spans.steps(got) if dev else None
