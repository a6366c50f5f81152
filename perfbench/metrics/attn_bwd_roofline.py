"""The backward pair's share of its roofline: dQ's and dK/dV's least
times for one call each at the cell's shape (``flops.bwd_bound_ms``; dQ
computes delta itself), summed, over their device time a call pair in the
trace. Silent where the trace's calls are not the kernels' counted
launches."""

from perfbench import flops
from perfbench.trace import attention_kind


def read(run):
    model = run.cell.model
    if run.peaks is None or model["dtype"] != "bfloat16":
        return None
    calls = {kind: [k for k in run.trace.kernels
                    if attention_kind(k.name) == kind]
             for kind in ("dq", "dkv")}
    n = len(calls["dq"])
    if (not n or len(calls["dkv"]) != n or run.launches["dq"] != n
            or run.launches["dkv"] != n):
        return None
    bound_ms = sum(flops.bwd_bound_ms(run.cell.attention_shape, "bfloat16",
                                      True, kind, run.peaks)[0]
                   for kind in ("dq", "dkv"))
    device_ms = sum(k.dur for ks in calls.values() for k in ks) / 1e3
    return 100.0 * bound_ms * n / device_ms
