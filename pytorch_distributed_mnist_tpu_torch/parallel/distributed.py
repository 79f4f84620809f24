"""Process-group bootstrap and topology probes.

Counterpart of ``pytorch_distributed_mnist_tpu/parallel/distributed.py``,
which calls ``jax.distributed.initialize``: here the rendezvous is
``torch.distributed.init_process_group`` over TCP, one process per device,
with NCCL for a rank on the card and gloo for a rank on the CPU.

- Explicit flags (``--coordinator host:port --num-processes N
  --process-id r``) join a world of N.
- With no flags, the environment of a launcher is detected
  (:func:`_multiprocess_env_detected`: ``MASTER_ADDR`` with ``WORLD_SIZE >
  1``, or a Slurm, Open MPI or PMI world of more than one task) and read
  for the address, size and rank.
- Otherwise the run is a single process: no rendezvous, no process group,
  and no collective ever runs.

Every topology read goes through :func:`process_index` and
:func:`process_count`, so shard arithmetic can be tested with
monkeypatched values.

A world of more than one process also gets a second group at the
rendezvous, over gloo whatever the device (:func:`host_group`): the run
supervision's records travel there (``runtime/supervision.py``), so that
under NCCL an exchange of records needs no card and never queues behind
the train step's collectives.
"""

from __future__ import annotations

import os
import time
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from pytorch_distributed_mnist_tpu_torch.utils.device import resolve_device

_init_info: dict = {}
_host_group = None  # the gloo group of the supervision records

# (size, rank) variable pairs of the launchers the environment detection
# reads, in order of precedence: torchrun and the like, Slurm, Open MPI,
# PMI.
_ENV_WORLDS = (("WORLD_SIZE", "RANK"), ("SLURM_NTASKS", "SLURM_PROCID"),
               ("OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK"),
               ("PMI_SIZE", "PMI_RANK"))
DEFAULT_MASTER_PORT = "29500"


def _env_int(name: str) -> int:
    try:
        return int(os.environ.get(name, "0"))
    except ValueError:
        return 0


def _multiprocess_env_detected() -> bool:
    """True when the environment describes a launch of more than one
    process: ``MASTER_ADDR`` with ``WORLD_SIZE > 1`` (torchrun and
    launchers like it), or a Slurm, Open MPI or PMI world of more than one
    task."""
    if os.environ.get("MASTER_ADDR") and _env_int("WORLD_SIZE") > 1:
        return True
    return any(_env_int(size) > 1 for size, _ in _ENV_WORLDS[1:])


def _env_world() -> Tuple[str, int, int]:
    """``(coordinator, size, rank)`` of the detected launch. The
    coordinator is ``MASTER_ADDR:MASTER_PORT`` (port 29500 by default),
    which Slurm and Open MPI do not set: the job script exports it."""
    for size_var, rank_var in _ENV_WORLDS:
        size = _env_int(size_var)
        if size > 1:
            rank = _env_int(rank_var)
            break
    addr = os.environ.get("MASTER_ADDR")
    if not addr:
        raise RuntimeError(
            f"{size_var}={size} describes a multi-process launch but "
            f"MASTER_ADDR is not set: export MASTER_ADDR (and MASTER_PORT) "
            f"to the address of rank 0, or pass --coordinator "
            f"--num-processes --process-id")
    port = os.environ.get("MASTER_PORT", DEFAULT_MASTER_PORT)
    return f"{addr}:{port}", size, rank


def backend_for(device: torch.device) -> str:
    """NCCL for a rank on the card, gloo for a rank on the CPU."""
    return "nccl" if device.type == "cuda" else "gloo"


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device: Optional[torch.device] = None) -> None:
    """Join the world (idempotent: a second call, or a call in a process
    whose group exists already, does nothing).

    Explicit arguments mirror the reference's ``--init-method`` /
    ``--world-size`` / ``--rank``; with none, a launcher's environment is
    read; a single process with neither skips the rendezvous entirely. A
    rank on the card binds to ``device`` first (NCCL needs it), and its
    communicator is created at the rendezvous. ``device`` None is the
    card (``utils/device.py::resolve_device``, which raises when none is
    visible): a world on the CPU (gloo) is asked for by name."""
    device = resolve_device("cuda") if device is None else device
    if dist.is_initialized():
        return
    explicit = coordinator is not None or (num_processes or 0) > 1
    if explicit:
        if coordinator is None or num_processes is None \
                or process_id is None:
            raise ValueError(
                "--coordinator, --num-processes and --process-id go "
                "together: every rank needs the address, the world size "
                "and its own rank")
        mode = "explicit"
    elif _multiprocess_env_detected():
        coordinator, num_processes, process_id = _env_world()
        mode = "auto"
    else:
        _init_info.clear()
        _init_info.update(mode="single", initialized_at=time.time())
        return
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} out of range for "
                         f"{num_processes} processes")
    backend = backend_for(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        device_id=device if device.type == "cuda" else None)
    global _host_group
    # Every rank makes the group here, in the same order, as new_group
    # requires; a world of one exchanges no records.
    _host_group = (dist.new_group(backend="gloo") if num_processes > 1
                   else None)
    _init_info.clear()
    _init_info.update(mode=mode, coordinator=coordinator, backend=backend,
                      device=str(device), initialized_at=time.time())


def teardown() -> None:
    """Destroy the process group this module created, if any (the CLI
    calls it on every exit of ``run``); a group made by someone else is
    left alone."""
    global _host_group
    if dist.is_initialized() and _init_info.get("mode") in ("explicit",
                                                            "auto"):
        dist.destroy_process_group()  # the host group with it
        _host_group = None
    _init_info.clear()


def is_distributed() -> bool:
    """True iff more than one process participates."""
    return process_count() > 1


def process_index() -> int:
    """This process's rank (0 with no process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The number of participating processes (1 with no process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def host_group():
    """The gloo group of this world's supervision records (made at the
    rendezvous of a world of more than one), else None."""
    return _host_group


def runtime_info() -> dict:
    """How this world was bootstrapped, when, and this process's
    coordinates, as plain values for a JSON summary."""
    info = dict(_init_info)
    info["process_index"] = process_index()
    info["process_count"] = process_count()
    return info
