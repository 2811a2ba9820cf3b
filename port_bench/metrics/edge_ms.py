"""Host ms a request spends before its prepare: the session's
``said.fit_audio``, ``said.process_audio`` and ``said.upload`` spans
summed, over its requests. One client at batch 1 leaves the card none of
the request's work then, so this is device idle."""

from port_bench import spans


def read(record):
    got = spans.session_spans(record)
    if not got:
        return None
    edges = spans.named(got, spans.FIT_AUDIO, spans.PROCESS_AUDIO, spans.UPLOAD)
    return sum(spans.host_ms(s) for s in edges) / spans.requests(got)
