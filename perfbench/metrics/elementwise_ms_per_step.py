"""Device ms a step of every kernel that is neither a GEMM, nor a flash
attention kernel, nor the optimizer's, nor a collective (NCCL's): the
model's unfused passes (norms, GELU, casts, residual adds, embedding,
loss) and the accumulation's."""

from perfbench.trace import (attention_kind, is_collective, is_gemm,
                             optimizer_kernels)


def read(run):
    skip = {id(k) for k in optimizer_kernels(run.trace)}
    us = sum(k.dur for k in run.trace.kernels
             if id(k) not in skip and not is_gemm(k.name)
             and attention_kind(k.name) is None
             and not is_collective(k.name))
    return us / 1e3 / run.steps if us else None
