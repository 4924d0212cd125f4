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
rendezvous is rank 0's `host:port` (`tcp://`), a shared file
(`file://<path>`) or a torch.distributed Store the caller made. A group of
one process is a real group too, so one card runs its collectives through
NCCL.

An elastic resize re-forms the group (`reform`): the old default group is
destroyed and a new one made with the new world's dense ranks under a
rendezvous of the new membership epoch (parallel/elastic.py). The JAX
package re-forms a device subset inside one process; in the port a rank
is a process, so the group itself changes. Each formation bumps
`generation()`: a Mesh made under an older generation is stale, and the
collectives over it refuse to run (parallel/mesh.py, Mesh.check_live).
"""

import os

import torch
import torch.distributed as dist

__all__ = ["init_from_env", "initialize", "is_initialized", "ClusterEnv",
           "reform", "generation", "card"]

# [formations of the default group in this process, this rank's card (the
# local_device_ids[0] of the last formation) or None]
_state = [0, None]


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
               local_device_ids=None, backend=None):
    """Create the default process group; a second call is a no-op.

    coordinator_address: rank 0's "host:port", "file://<path>" of a
    rendezvous file every rank can reach, or a torch.distributed.Store
    (its rendezvous made by the caller). num_processes / process_id: the
    world size and this rank (default 1 and 0). local_device_ids: the
    local CUDA cards of this rank; the first is its card and the group's
    backend is NCCL. None makes a CPU rank over gloo. `backend="gloo"`
    with a card makes a card rank over gloo: ranks that share one card
    (NCCL refuses two ranks on one device), whose P2P values go through
    pinned host buffers (ops/collective_ops.py). Any failure (no card,
    NCCL missing, a rendezvous that times out) raises."""
    if dist.is_initialized():
        return
    world = 1 if num_processes is None else int(num_processes)
    rank = 0 if process_id is None else int(process_id)
    if coordinator_address is None:
        raise ValueError("initialize needs a coordinator_address: rank 0's "
                         "host:port or file://<rendezvous file>")
    if isinstance(coordinator_address, dist.Store):
        rdv = {"store": coordinator_address}
    else:
        rdv = {"init_method": coordinator_address
               if coordinator_address.startswith(("tcp://", "file://"))
               else f"tcp://{coordinator_address}"}
    card = None
    if local_device_ids:
        card = int(local_device_ids[0])
        if not torch.cuda.is_available() \
                or card >= torch.cuda.device_count():
            raise RuntimeError(
                f"rank {rank} asks for cuda:{card}, but this process sees "
                f"{torch.cuda.device_count()} CUDA device(s)")
        torch.cuda.set_device(card)
        if backend not in (None, "nccl"):
            dist.init_process_group(backend, world_size=world, rank=rank,
                                    **rdv)
        else:
            dist.init_process_group(
                "nccl", world_size=world, rank=rank,
                device_id=torch.device("cuda", card), **rdv)
    else:
        dist.init_process_group("gloo", world_size=world, rank=rank, **rdv)
    _state[:] = [_state[0] + 1, card]


def reform(coordinator_address, num_processes, process_id,
           local_device_ids=None, backend=None):
    """Destroy the default group, if there is one, and create a new one
    (`initialize`'s arguments): the elastic resize's group re-form. Every
    Mesh made before is stale after it (`generation`). Any failure
    raises; the process is then left without a group."""
    if dist.is_initialized():
        dist.destroy_process_group()
    initialize(coordinator_address, num_processes, process_id,
               local_device_ids=local_device_ids, backend=backend)


def generation():
    """How many times this process formed a default group (0: never)."""
    return _state[0]


def card():
    """The card this rank's group was formed on (local_device_ids[0]), or
    None for a CPU rank or without a group."""
    return _state[1] if dist.is_initialized() else None


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

