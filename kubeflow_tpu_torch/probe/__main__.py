"""CLI: ``python -m kubeflow_tpu_torch.probe``, the slice burn-in (the
port of ``kubeflow_tpu/probe/__main__.py``).

Prints one JSON document with the reference's keys: ``ici`` (the
all-reduce report), and inside a multi-node slice ``dcn``, and in a
multislice job on node 0 of each slice ``dcn_cross_slice`` and
``dcn_cross_slice_scored``. The all-reduce covers the node's cards:

- under ``torchrun`` (one process per card, ``RANK`` in the env) it runs
  in that world, which ``sdk.initialize_distributed`` forms, and the
  node's first process prints the report;
- alone it starts one process per local card over NCCL
  (``parallel.launch.run_world``), as the reference measures every local
  chip from one process; ``--device cpu`` runs a world of one on gloo.

The DCN legs stay advisory: an error goes into the report.
``--accelerator`` and ``--topology`` default to the node env
(``KFTPU_ACCELERATOR``, ``TPU_TOPOLOGY``).
"""

from __future__ import annotations

import argparse
import json
import os

from kubeflow_tpu_torch.gpu.topology import ACCELERATOR_ENV

# Seconds the spawned per-card processes share.
SPAWN_TIMEOUT = 300.0
# Where the cross-slice ring listens: apart from the slice's ring's ports.
CROSS_SLICE_BASE_PORT = 19500


def _ici(args) -> dict | None:
    """The all-reduce report, or None on a process that does not print."""
    import torch
    import torch.distributed as dist

    from kubeflow_tpu_torch import sdk
    from kubeflow_tpu_torch.device import resolve_device
    from kubeflow_tpu_torch.parallel.launch import run_world
    from kubeflow_tpu_torch.probe.ici import run_ici_probe, world_rank

    dev = resolve_device(args.device)
    if os.environ.get("RANK") and os.environ.get("WORLD_SIZE"):
        joined = sdk.initialize_distributed(device=args.device)
        try:
            report = run_ici_probe(
                mbytes=args.mbytes, iters=args.iters,
                accelerator=args.accelerator, topology=args.topology,
                device=dev).to_dict()
        finally:
            if joined:
                dist.destroy_process_group()
        return report if os.environ.get("LOCAL_RANK", "0") == "0" else None
    if dev.type == "cpu":
        return run_ici_probe(mbytes=args.mbytes, iters=args.iters,
                             accelerator=args.accelerator,
                             topology=args.topology, device="cpu").to_dict()
    return run_world(world_rank, torch.cuda.device_count(), args.mbytes,
                     args.iters, args.accelerator, args.topology, None,
                     backend="nccl", cuda=True, timeout=SPAWN_TIMEOUT)[0]


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="GPU slice burn-in probe")
    parser.add_argument("--mbytes", type=float, default=64.0)
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--accelerator", default=os.environ.get(ACCELERATOR_ENV))
    parser.add_argument("--topology", default=os.environ.get("TPU_TOPOLOGY"))
    parser.add_argument("--skip-dcn", action="store_true")
    parser.add_argument("--device", default=None,
                        help="'cpu' for a world of one on gloo; default: "
                             "the node's CUDA cards")
    args = parser.parse_args(argv)

    ici = _ici(args)
    if ici is None:
        return
    report: dict = {"ici": ici}

    if not args.skip_dcn:
        from kubeflow_tpu_torch.probe.dcn import (
            run_rank,
            slice_env_config,
            worker_env_config,
        )

        config = worker_env_config()
        if config is not None:
            rank, world, peers = config
            try:
                report["dcn"] = run_rank(rank, world, peers, mbytes=args.mbytes)
            except Exception as e:  # burn-in keeps going; DCN result is advisory
                report["dcn"] = {"error": str(e)}

        # Cross-slice ring (multislice): one rank per slice, node 0 only.
        slice_config = slice_env_config()
        if slice_config is not None:
            rank, world, peers = slice_config
            try:
                raw = run_rank(rank, world, peers, mbytes=args.mbytes,
                               base_port=CROSS_SLICE_BASE_PORT)
                report["dcn_cross_slice"] = raw
            except Exception as e:
                report["dcn_cross_slice"] = {"error": str(e)}
            else:
                # A scoring failure must not discard the measurement.
                if args.accelerator and args.topology:
                    try:
                        from kubeflow_tpu_torch.gpu.topology import MultiSlice
                        from kubeflow_tpu_torch.probe.dcn import score_reports

                        ms = MultiSlice.parse(args.accelerator, args.topology,
                                              num_slices=world)
                        report["dcn_cross_slice_scored"] = score_reports(
                            [raw], multi=ms).to_dict()
                    except Exception as e:
                        report["dcn_cross_slice_scored"] = {"error": str(e)}

    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
