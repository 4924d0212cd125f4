"""Multi-process bootstrap over torch.distributed.

Reference parity: the "NCCL2 mode" bootstrap — gen_nccl_id_op.cc:31 serves
an ncclUniqueId from trainer 0, then every trainer constructs
NCCLContextMap(nccl_id, num_trainers, trainer_id) (nccl_helper.h:92-118);
drivers read PADDLE_* env vars (trainer.py:148-196,
fluid_benchmark.py:111).

In the port one process drives one card (or, for a CPU rank, the host):
`initialize` creates the default process group that ParallelExecutor's dp
axis spans. A CUDA rank (one named by `local_device_ids`) joins over NCCL
on `cuda:<local_device_ids[0]>`; a CPU rank joins over gloo. The
rendezvous is rank 0's `host:port` (`tcp://`) or a shared file
(`file://<path>`). A group of one process is a real group too, so one card
runs its collectives through NCCL.
"""

import os

import torch
import torch.distributed as dist

__all__ = ["init_from_env", "initialize", "is_initialized", "ClusterEnv"]


class ClusterEnv:
    """Parsed PADDLE_* environment (reference trainer.py:148-196), plus
    FLAGS_selected_gpus, the reference launcher's card list for a trainer
    (a CUDA rank when set)."""

    def __init__(self, env=None):
        e = env or os.environ
        self.training_role = e.get("PADDLE_TRAINING_ROLE", "TRAINER")
        self.trainer_id = int(e.get("PADDLE_TRAINER_ID", "0"))
        self.num_trainers = int(e.get("PADDLE_TRAINERS", "1"))
        # collective (nccl2-mode) bootstrap endpoint: rank 0's address
        self.coordinator = e.get(
            "PADDLE_COORDINATOR",
            e.get("PADDLE_CURRENT_ENDPOINT", "127.0.0.1:7777"))
        # pserver mode
        self.pserver_endpoints = [
            p for p in e.get("PSERVERS",
                             e.get("PADDLE_PSERVERS", "")).split(",")
            if p
        ]
        self.current_endpoint = e.get("PADDLE_CURRENT_ENDPOINT", "")
        self.selected_gpus = [int(g) for g in
                              e.get("FLAGS_selected_gpus", "").split(",")
                              if g.strip()] or None

    @property
    def is_pserver(self):
        return self.training_role == "PSERVER"


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               local_device_ids=None):
    """Create the default process group; a second call is a no-op.

    coordinator_address: rank 0's "host:port", or "file://<path>" of a
    rendezvous file every rank can reach. num_processes / process_id: the
    world size and this rank (default 1 and 0). local_device_ids: the
    local CUDA cards of this rank; the first is its card and the group's
    backend is NCCL. None makes a CPU rank over gloo. Any failure (no
    card, NCCL missing, a rendezvous that times out) raises."""
    if dist.is_initialized():
        return
    world = 1 if num_processes is None else int(num_processes)
    rank = 0 if process_id is None else int(process_id)
    if coordinator_address is None:
        raise ValueError("initialize needs a coordinator_address: rank 0's "
                         "host:port or file://<rendezvous file>")
    init_method = (coordinator_address
                   if coordinator_address.startswith(("tcp://", "file://"))
                   else f"tcp://{coordinator_address}")
    if local_device_ids:
        card = int(local_device_ids[0])
        if not torch.cuda.is_available() \
                or card >= torch.cuda.device_count():
            raise RuntimeError(
                f"rank {rank} asks for cuda:{card}, but this process sees "
                f"{torch.cuda.device_count()} CUDA device(s)")
        torch.cuda.set_device(card)
        dist.init_process_group(
            "nccl", init_method=init_method, world_size=world, rank=rank,
            device_id=torch.device("cuda", card))
    else:
        dist.init_process_group("gloo", init_method=init_method,
                                world_size=world, rank=rank)


def init_from_env():
    """Bootstrap from PADDLE_* env vars (and FLAGS_selected_gpus); returns
    the ClusterEnv. A pserver process joins no group."""
    env = ClusterEnv()
    if not env.is_pserver:
        initialize(coordinator_address=env.coordinator,
                   num_processes=env.num_trainers,
                   process_id=env.trainer_id,
                   local_device_ids=env.selected_gpus)
    return env


def is_initialized():
    return dist.is_initialized()

