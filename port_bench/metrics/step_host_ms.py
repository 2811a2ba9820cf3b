"""ms a denoise step on the host: the session's ``said.denoise`` spans'
host time summed, over all their steps; the time the host takes to
enqueue a step. Where it nears ``step_dev_ms`` the host sets the pace."""

from port_bench import spans


def read(record):
    got = spans.session_spans(record)
    if not got or not spans.steps(got):
        return None
    return sum(spans.host_ms(s) for s in spans.named(got, spans.DENOISE)) / spans.steps(got)
