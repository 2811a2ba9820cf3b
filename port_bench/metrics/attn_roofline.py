"""The flash kernel's share (%) of its roofline in the profiler session:
the least time the session's long self-attention calls could take
(``work.attention_bound_s``) over the device time of the attention
kernels. Nothing to read where no call reached the flash kernel."""

from port_bench import trace, work


def read(record):
    s = record.get("session")
    if not s or not s.get("flash_calls"):
        return None
    kernel_s = s["by_family_s"].get(trace.ATTENTION_FAMILY, 0.0)
    if kernel_s <= 0.0:
        return None
    return 100.0 * work.attention_bound_s(s["flash_calls"], record["dtype"]) / kernel_s
