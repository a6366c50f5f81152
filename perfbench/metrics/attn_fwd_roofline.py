"""The flash forward kernel's share of its roofline: the least time the
card could take for one call at the cell's shape (its bytes and causal
products, ``flops.attention_bound_ms``) over the kernel's device time a
call in the trace. Silent where the trace's calls are not the kernel's
counted launches (the path did not run the kernel)."""

from perfbench import flops
from perfbench.trace import attention_kind


def read(run):
    model = run.cell.model
    if run.peaks is None or model["dtype"] != "bfloat16":
        return None
    calls = [k for k in run.trace.kernels if attention_kind(k.name) == "fwd"]
    if not calls or len(calls) != run.launches["fwd"]:
        return None
    bound_ms = flops.attention_bound_ms(run.cell.attention_shape, "bfloat16",
                                        True, run.peaks)[0]
    return 100.0 * bound_ms * len(calls) / (sum(k.dur for k in calls) / 1e3)
