"""Entry points of the port, as ``__graft_entry__``'s are the JAX
package's: ``entry`` (the burn-in forward at a small config with its
inputs) and ``dryrun_multichip`` (the sharded train steps of every
parallelism mode over ``n`` processes)."""

from __future__ import annotations

import math
from functools import partial

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from kubeflow_tpu_torch.device import resolve_device
from kubeflow_tpu_torch.gpu.topology import MultiSlice
from kubeflow_tpu_torch.models import burnin, longctx, moe, pipelined
from kubeflow_tpu_torch.models.burnin import BurninConfig, forward, init_params
from kubeflow_tpu_torch.parallel.launch import run_world
from kubeflow_tpu_torch.parallel.mesh import make_mesh, plan_mesh, shard
from kubeflow_tpu_torch.probe.dcn import (free_base_port, run_local_ring,
                                          score_reports)
from kubeflow_tpu_torch.probe.ici import run_ici_probe

# Seconds that the processes of a spawned dryrun share.
DRYRUN_TIMEOUT = 600.0
# The node type the dryrun's probes score against (A3 High).
PROBE_ACCELERATOR = "nvidia-h100-80gb"


def entry(device=None):
    """``(fn, (params, tokens))``: ``fn(params, tokens)`` is the forward
    of ``BurninConfig(seq_len=64, d_model=128, n_layers=2)`` on seeded
    params and a ``[4, 64]`` batch of zeros, giving f32 logits
    ``[4, 64, 256]``. Runs on the current CUDA card unless ``device``
    says otherwise; raises with no card and no ``device``."""
    cfg = BurninConfig(seq_len=64, d_model=128, n_layers=2)
    params = init_params(cfg, seed=0, device=device)
    tokens = torch.zeros((4, cfg.seq_len), dtype=torch.int64,
                         device=params["embed"].device)
    return partial(forward, cfg=cfg), (params, tokens)


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """One sharded train step of each parallelism mode over ``n_devices``
    processes, at the JAX package's dryrun configs (its seeds aside), each
    held to a finite loss: burn-in data x tensor parallel on
    ``plan_mesh(n, max_model=4)``; with n >= 2 the long-context model on
    (data, seq), the pipelined model on (data, stage) (x model at n >= 8),
    the all-reduce probe over the world and the MoE model on (data,
    expert); with n >= 4 and even the multislice burn-in on (2, n / 2) and
    the DCN ring probe for its two slices. Returns each block's loss, and
    the probes' reports (``"ici"``, ``"dcn"``) as dicts.

    Inside an initialized world of ``n_devices`` processes, it runs the
    blocks on this process. Otherwise it starts ``n_devices`` processes:
    with ``device=None`` one CUDA card each over NCCL, which needs as many
    cards (``RuntimeError`` with fewer: it never falls back to the CPU);
    with ``device="cpu"``, gloo processes on the CPU, the counterpart of
    the JAX package's virtual CPU devices. They share one deadline of
    ``DRYRUN_TIMEOUT`` seconds.
    """
    if dist.is_initialized() and dist.get_world_size() == n_devices:
        return _blocks(n_devices, device)
    if device is None:
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards < n_devices:
            raise RuntimeError(
                f"dryrun_multichip({n_devices}) runs one process a CUDA card "
                f"and torch.cuda.device_count() is {cards}; pass "
                f"device='cpu' for gloo processes on the CPU")
        backend, cuda = "nccl", True
    elif str(device) == "cpu":
        backend, cuda = "gloo", False
    else:
        raise ValueError(f"device must be None (CUDA) or 'cpu', got "
                         f"{device!r}")
    return run_world(_dryrun_rank, n_devices, n_devices, device,
                     backend=backend, cuda=cuda,
                     timeout=DRYRUN_TIMEOUT)[0]


def _dryrun_rank(rank: int, n_devices: int, device) -> dict:
    return _blocks(n_devices, device)


def _finite(name: str, loss) -> float:
    value = float(loss)
    if not math.isfinite(value):
        raise RuntimeError(f"non-finite {name} loss {value}")
    return value


def _blocks(n: int, device) -> dict:
    """The dryrun's blocks on this process of a world of ``n``."""
    dev = resolve_device(device)
    kind = dev.type
    losses = {}

    def zeros(batch, seq):
        return torch.zeros((batch, seq), dtype=torch.int64, device=dev)

    def burnin_step(name, mesh, cfg, batch, seed):
        params = burnin.shard_params(
            burnin.init_params(cfg, seed=seed, device=dev), mesh, cfg)
        tokens = shard(zeros(batch, cfg.seq_len), ("data",), mesh)
        _, loss = burnin.make_train_step(cfg, mesh)(params, tokens)
        losses[name] = _finite(name, loss)

    plan = plan_mesh(n, max_model=4)
    burnin_step("burnin", make_mesh(plan, kind),
                BurninConfig(seq_len=32, d_model=64, n_layers=2, d_ff=256,
                             n_heads=4),
                max(plan.data * 2, 2), seed=0)
    if n < 2:
        return losses

    # Sequence parallel: the long-context model on data x seq (the ring's
    # hops and the loss sum).
    seq = max(2, n // 2)
    sp_mesh = DeviceMesh(kind, torch.arange(n).reshape(n // seq, seq),
                         mesh_dim_names=("data", "seq"))
    sp_cfg = longctx.LongContextConfig(seq_len=16 * seq, d_model=32,
                                       n_layers=1, d_ff=64, n_heads=4)
    sp_tokens, sp_params = longctx.shard_inputs(
        zeros(2 * (n // seq), sp_cfg.seq_len),
        longctx.init_params(sp_cfg, seed=1, device=dev), sp_mesh)
    _, loss = longctx.make_train_step(sp_cfg, sp_mesh)(sp_params, sp_tokens)
    losses["longctx"] = _finite("longctx", loss)

    # Pipeline parallel: data x stage (x model at 8 and more: dp x pp x tp).
    n_model = 2 if (n >= 8 and n % 4 == 0) else 1
    n_stages = max(2, n // (2 * n_model))
    if n % (n_stages * n_model):
        n_stages = 2 if n % 2 == 0 else 1
    pp_mesh = pipelined.make_pp_mesh(n_stages, n_model, device_type=kind)
    pp_cfg = pipelined.PipelinedConfig(vocab=64, d_model=32, n_heads=4,
                                       n_layers=2 * n_stages, d_ff=64,
                                       seq_len=12, n_micro=2)
    pp_params = pipelined.shard_params(
        pipelined.init_params(pp_cfg, seed=3, device=dev), pp_mesh, pp_cfg)
    pp_tokens = shard(zeros(2 * pp_mesh.size(0), pp_cfg.seq_len),
                      ("data",), pp_mesh)
    _, loss = pipelined.make_train_step(pp_cfg, pp_mesh)(pp_params,
                                                         pp_tokens)
    losses["pipelined"] = _finite("pipelined", loss)

    # Multislice: two slices on the data axis x model within each.
    if n >= 4 and n % 2 == 0:
        ms_mesh = DeviceMesh(kind, torch.arange(n).reshape(2, n // 2),
                             mesh_dim_names=("data", "model"))
        burnin_step("multislice", ms_mesh,
                    BurninConfig(seq_len=16, d_model=64, n_layers=1,
                                 d_ff=128, n_heads=4), 4, seed=4)

        # The DCN scoring path for the same two slices: the native ring
        # runs one rank a slice (loopback here, node 0 of each slice in a
        # multislice job) on rank 0, scored against the MultiSlice
        # estimate, and rank 0 hands the report to every process. Loopback
        # numbers are no network rate; what is held is that the probe
        # runs, reports and scores.
        report = [None]
        if dist.get_rank() == 0:
            dcn = score_reports(
                run_local_ring(world=2, mbytes=4.0, iters=2,
                               base_port=free_base_port(2)),
                multi=MultiSlice.parse(PROBE_ACCELERATOR, "1x8",
                                       num_slices=2))
            if not (dcn.min_gbps > 0 and dcn.peak_estimate_gbps is not None
                    and dcn.fraction_of_peak is not None):
                raise RuntimeError(f"DCN probe scored nothing: {dcn}")
            report = [dcn.to_dict()]
        dist.broadcast_object_list(report, src=0)
        losses["dcn"] = report[0]

    # The all-reduce probe over this world, scored against two whole
    # nodes: the fraction-of-peak path runs in the gate, not only in unit
    # tests. Over gloo or one shared card its numbers are no NVLink rate.
    ici = run_ici_probe(mbytes=1.0, iters=2, warmup=1,
                        accelerator=PROBE_ACCELERATOR, topology="2x8",
                        device=dev)
    if not (ici.algo_bandwidth_gbps > 0 and ici.fraction_of_peak is not None):
        raise RuntimeError(f"all-reduce probe scored nothing: {ici}")
    losses["ici"] = ici.to_dict()

    # Expert parallel: data x expert (the two all-to-alls); the batch
    # splits over both axes.
    expert = max(2, n // 2)
    ep_mesh = DeviceMesh(kind, torch.arange(n).reshape(n // expert, expert),
                         mesh_dim_names=("data", "expert"))
    ep_cfg = moe.MoEConfig(vocab=64, d_model=32, n_heads=4, n_layers=1,
                           d_ff=64, seq_len=9, n_experts=expert)
    ep_params = moe.shard_params(moe.init_params(ep_cfg, seed=2, device=dev),
                                 ep_mesh, ep_cfg)
    rank = dist.get_rank()
    ep_tokens = zeros(2 * n, ep_cfg.seq_len)[2 * rank:2 * rank + 2]
    _, loss = moe.make_train_step(ep_cfg, ep_mesh)(ep_params, ep_tokens)
    losses["moe"] = _finite("moe", loss)
    return losses
