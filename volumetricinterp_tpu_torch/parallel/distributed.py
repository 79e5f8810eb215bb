"""Multi-process bring-up over torch.distributed (the JAX package's
parallel/distributed.py).

One process per card.  Records shard over the rows of the mesh and points
over the ranks of a row (parallel/mesh.py); every process reads the same
input file and returns the full results, and process 0 writes the output.

Launch, one process per card:

    torchrun --nproc-per-node N -m volumetricinterp_tpu_torch.cli \\
        --distributed config.ini

or one command per process with the package's own variables:

    VITPU_COORDINATOR=host0:29500 VITPU_NUM_PROCESSES=N VITPU_PROCESS_ID=i \\
        volumetricinterp-torch --distributed config.ini

The backend follows the device: nccl for cuda, gloo for cpu, unless the
caller names one (a gloo world whose processes compute on CUDA tensors is
a valid choice, for example several processes on one card).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from .mesh import make_mesh, world


def initialize_distributed(coordinator=None, num_processes=None,
                           process_id=None, device="cuda", backend=None):
    """Initialize the default process group; returns (rank, world size).

    The arguments default to VITPU_COORDINATOR ("host:port"),
    VITPU_NUM_PROCESSES and VITPU_PROCESS_ID; without them, to torchrun's
    MASTER_ADDR / MASTER_PORT, WORLD_SIZE and RANK.  With neither, the run
    is one process and nothing is initialized.  Safe to call twice."""
    if dist.is_initialized():
        return world()
    env = os.environ
    coordinator = coordinator or env.get("VITPU_COORDINATOR")
    if num_processes is None and "VITPU_NUM_PROCESSES" in env:
        num_processes = int(env["VITPU_NUM_PROCESSES"])
    if process_id is None and "VITPU_PROCESS_ID" in env:
        process_id = int(env["VITPU_PROCESS_ID"])
    if coordinator is None and "MASTER_ADDR" in env:
        coordinator = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', 29500)}"
        num_processes = (int(env.get("WORLD_SIZE", 1)) if num_processes is None
                         else num_processes)
        process_id = (int(env.get("RANK", 0)) if process_id is None
                      else process_id)
    if coordinator is None:
        return 0, 1
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator needs the number of processes and "
                         "this process's id (VITPU_NUM_PROCESSES, "
                         "VITPU_PROCESS_ID)")
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=int(num_processes),
                            rank=int(process_id))
    return world()


def local_device(device="cuda"):
    """This process's card: cuda:LOCAL_RANK (torchrun's variable, else the
    rank modulo the visible cards) for a bare "cuda"; any other device as
    given."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    rank, _ = world()
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % max(torch.cuda.device_count(), 1))


def make_global_mesh(mesh_records: int = 0, mesh_points: int = 1):
    """make_mesh over the whole world, with the points axis inside one
    host: the ranks of a host (LOCAL_WORLD_SIZE, torchrun's variable; the
    whole world without it) must be a multiple of mesh_points, so no row
    spans two hosts."""
    mesh = make_mesh(mesh_records, mesh_points)
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", mesh.size))
    if per_host % mesh.points:
        raise ValueError(f"points axis {mesh.points} must divide the "
                         f"{per_host} processes of one host")
    return mesh


def fit_records_distributed(values, errors, A, reg_mats, mesh=None,
                            **kwargs):
    """fit_records_sharded on the global mesh (make_global_mesh(0, 1) when
    none is given): every process passes the full arrays, read from the
    shared file, and gets the full results."""
    from .fit import fit_records_sharded

    return fit_records_sharded(values, errors, A, reg_mats,
                               mesh or make_global_mesh(), **kwargs)
