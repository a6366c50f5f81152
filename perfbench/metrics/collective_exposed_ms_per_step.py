"""Device ms a step in which a collective (an NCCL kernel) runs on rank
0's card and no other kernel does: the exchange that compute did not
hide. Silent where no NCCL kernel ran."""

from perfbench.trace import is_collective


def _merged(kernels) -> list:
    out: list = []
    for k in sorted(kernels, key=lambda k: k.ts):
        if out and k.ts <= out[-1][1]:
            out[-1][1] = max(out[-1][1], k.end)
        else:
            out.append([k.ts, k.end])
    return out


def read(run):
    nccl = [k for k in run.trace.kernels if is_collective(k.name)]
    if not nccl:
        return None
    compute = _merged(k for k in run.trace.kernels
                      if not is_collective(k.name))
    us, j = 0.0, 0
    for a, b in _merged(nccl):
        covered = 0.0
        while j < len(compute) and compute[j][1] <= a:
            j += 1
        i = j
        while i < len(compute) and compute[i][0] < b:
            covered += min(b, compute[i][1]) - max(a, compute[i][0])
            i += 1
        us += (b - a) - covered
    return us / 1e3 / run.steps
