"""One worker process of the multi-process ``torch.distributed`` harness:
the port of ``kubeflow_tpu/testing/distributed_worker.py``.

It proves that the env the notebook controller and the per-ordinal
webhook inject into each node (``gpu/topology.py`` ``worker_env``, plus
``LOCAL_RANK`` for a process launched per card) bootstraps a world and
carries a cross-process collective. Run as
``python -m kubeflow_tpu_torch.testing.distributed_worker`` with that env
set; it forms the world through ``sdk.initialize_distributed`` on gloo on
the CPU (as the JAX worker forces the CPU) and prints the JAX worker's
line, ``PSUM_RESULT <value> NPROC <n>``, then ``RANK <r> OF <n>``.

Under ``KFTPU_WORKER_MESH="DxM"`` it also sums over the model axis and
averages over the data axis of a (data, model) mesh of the world, and
prints ``MESH2D_RESULT <v>``, or ``MESH2D_SKIPPED`` where the shape does
not match the world.
"""

from __future__ import annotations

import math
import os
import sys

# Optional 2D-mesh mode (the JAX worker's env name).
WORKER_MESH_ENV = "KFTPU_WORKER_MESH"


def _say(line: str) -> None:
    """One line in one write: a node's processes share its stdout, and
    print's separate newline could land inside another process's line."""
    sys.stdout.write(line + "\n")
    sys.stdout.flush()


def main() -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from kubeflow_tpu_torch import sdk

    torch.set_num_threads(1)
    joined = sdk.initialize_distributed(device="cpu")
    rank = dist.get_rank() if joined else 0
    world = dist.get_world_size() if joined else 1
    # Each process contributes rank + 1, so the sum 1 + 2 + ... + n says
    # that every process took part with a rank of its own.
    x = torch.tensor([float(rank + 1)])
    if joined:
        dist.all_reduce(x)
    _say(f"PSUM_RESULT {float(x[0])} NPROC {world}")
    _say(f"RANK {rank} OF {world}")

    mesh_spec = os.environ.get(WORKER_MESH_ENV)
    if mesh_spec:
        dims = tuple(int(p) for p in mesh_spec.lower().split("x"))
        if len(dims) != 2 or math.prod(dims) != world or not joined:
            # A stray inherited env var must not break the 1D contract run.
            _say(f"MESH2D_SKIPPED {mesh_spec} (have {world} processes)")
        else:
            mesh = DeviceMesh("cpu", torch.arange(world).reshape(dims),
                              mesh_dim_names=("data", "model"))
            v = torch.tensor([float(rank + 1)])
            dist.all_reduce(v, group=mesh.get_group("model"))
            dist.all_reduce(v, group=mesh.get_group("data"))
            _say(f"MESH2D_RESULT {float(v[0]) / dims[0]}")
    if joined:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
