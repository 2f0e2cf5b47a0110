"""Multi-process initialization and the host-side collectives the recipe
needs.

Port of ``pkr_tpu/parallel/distributed.py``.  ``pkr_tpu`` runs one process
per host and ``jax.distributed.initialize`` joins them; PyTorch's idiom is
one process per card, joined by ``torch.distributed.init_process_group``.
The environment contract is ``pkr_tpu``'s, so the same launchers
(``utils/cluster.py``) start either package:

- ``COORDINATOR_ADDRESS`` — ``host:port`` of rank 0's rendezvous,
- ``NUM_PROCESSES`` — the world size (one process per card),
- ``PROCESS_ID`` — this process's rank,
- ``LOCAL_RANK`` — this process's card on its host (``cuda:<LOCAL_RANK>``;
  0 when unset).

Nothing set means one process, and :func:`initialize` does nothing.  A
partial contract fails at once.  The backend is NCCL for the card and gloo
for the CPU; a caller may name one (several ranks sharing one card need
gloo: NCCL refuses two ranks on one device), and nothing falls back from
one to the other.
"""

from __future__ import annotations

import os
import time
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from pkr_tpu_torch.device import DeviceLike, resolve_device

_ENV = ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID")


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device: DeviceLike = None, backend: Optional[str] = None) -> bool:
    """Join this process to the group named by the arguments or, where one
    is None, by the environment contract; True when a group was formed,
    False when nothing is configured (one process).

    ``device`` (None: the card) picks the backend (NCCL for CUDA, gloo for
    the CPU) unless ``backend`` names one; on the card the process takes
    ``cuda:<LOCAL_RANK>`` as its current device first."""
    coordinator_address = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if num_processes is None and os.environ.get("NUM_PROCESSES"):
        num_processes = int(os.environ["NUM_PROCESSES"])
    if process_id is None and os.environ.get("PROCESS_ID"):
        process_id = int(os.environ["PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        return False  # one process: nothing configured by arguments or env
    if coordinator_address is None or num_processes is None or process_id is None:
        have = {k: v for k, v in zip(_ENV, (coordinator_address, num_processes,
                                            process_id)) if v is not None}
        raise RuntimeError(
            f"incomplete process-group contract {have}: COORDINATOR_ADDRESS, "
            "NUM_PROCESSES and PROCESS_ID are set together (utils.cluster "
            "launch_hosts/slurm_script export all three); unset NUM_PROCESSES "
            "for a single-process run")
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes), rank=int(process_id))
    return True


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def host_info() -> Tuple[int, int, int]:
    """(process_index, process_count, local_device_count): one card a
    process, so the last is 1."""
    return process_index(), process_count(), 1


def barrier(name: str = "") -> None:
    """Every process waits here for the others (``pkr_tpu``'s
    ``multihost_utils.sync_global_devices(name)``); nothing with one
    process.  ``name`` labels the barrier in a failure."""
    if process_count() == 1:
        return
    try:
        dist.barrier()
    except RuntimeError as exc:
        raise RuntimeError(f"barrier {name!r} failed on rank {process_index()}") from exc


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """``obj`` as rank ``src`` holds it, on every rank (``pkr_tpu``'s
    ``broadcast_one_to_all`` for a host value)."""
    if process_count() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def shutdown() -> None:
    """Leave the process group, where one was formed."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_entry(rank: int, fn, nprocs: int, address: str, device: str,
                 backend: Optional[str], out_dir: str, args: tuple) -> None:
    """One spawned rank: join the group on this host's ``device`` (a card
    index is the rank modulo the cards), run ``fn(*args)`` and save what it
    returns for the parent."""
    if torch.device(device).type == "cuda":
        os.environ["LOCAL_RANK"] = str(rank % torch.cuda.device_count())
    else:  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // nprocs))
    initialize(address, nprocs, rank, device=device, backend=backend)
    try:
        result = fn(*args)
        torch.save(result, os.path.join(out_dir, f"{rank}.pt"))
    finally:
        shutdown()


def spawn(fn, nprocs: int, args: tuple = (), device: DeviceLike = None,
          backend: Optional[str] = None, timeout: float = 600.0) -> list:
    """Run ``fn(*args)`` in ``nprocs`` fresh processes joined in one group
    on this host (gloo on the CPU, NCCL on the cards unless ``backend``
    says otherwise; rank r takes card r mod the cards) and return each
    rank's result, by rank.  ``fn`` and its results must pickle (a
    module-level function; tensors come back through ``torch.save``).  A
    rank's failure or the timeout raises, after every rank has stopped."""
    import shutil
    import tempfile

    import torch.multiprocessing as mp

    dev = str(resolve_device(device))
    out_dir = tempfile.mkdtemp(prefix="pkr_spawn_")
    try:
        ctx = mp.start_processes(
            _spawn_entry, nprocs=nprocs, join=False, start_method="spawn",
            args=(fn, nprocs, f"127.0.0.1:{_free_port()}", dev, backend, out_dir, args))
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(0.0, min(1.0, deadline - time.monotonic()))):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"spawn of {nprocs} ranks passed {timeout:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(os.path.join(out_dir, f"{r}.pt"), weights_only=False)
                for r in range(nprocs)]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
