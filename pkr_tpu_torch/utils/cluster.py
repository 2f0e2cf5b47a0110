"""Multi-host launchers: the queue.pl / slurm.pl / ssh.pl role.

Port of ``pkr_tpu/utils/cluster.py``.  ``pkr_tpu`` launches one program a
host; PyTorch's idiom is one process a card, so these launchers start one
process per card, each with the environment contract of
``parallel/distributed.initialize`` (COORDINATOR_ADDRESS, NUM_PROCESSES,
PROCESS_ID, and LOCAL_RANK, the card on its host).  The launched command
needs no extra flags.  Two transports:

- ``slurm_script(...)`` renders an sbatch file: ``--ntasks-per-node`` tasks
  a node, one a card, the coordinator derived from the Slurm nodelist,
  NUM_PROCESSES from ``SLURM_NTASKS``, PROCESS_ID from ``SLURM_PROCID`` and
  LOCAL_RANK from ``SLURM_LOCALID``, read inside each task;
- ``launch_hosts(...)`` runs the program on an explicit host list over a
  pluggable transport (default ``ssh``), ``cards_per_host`` processes a
  host, mirroring ssh.pl: one log a process, fail-if-any-fails,
  COORDINATOR_ADDRESS = the first host.
"""

from __future__ import annotations

import os
import shlex
import subprocess
import time
from typing import Dict, List, Optional, Sequence

from pkr_tpu_torch.utils.jobs import JobError

SLURM_TEMPLATE = """#!/bin/bash
#SBATCH --job-name={name}
#SBATCH --nodes={nodes}
#SBATCH --ntasks-per-node={cards_per_node}
#SBATCH --gpus-per-node={cards_per_node}
#SBATCH --cpus-per-task={cpus_per_task}
#SBATCH --output={log_dir}/{name}.%n.%t.log
{extra_directives}
mkdir -p {log_dir_q}
# one process per card; rank 0's host is the rendezvous
export COORDINATOR_ADDRESS="$(scontrol show hostnames "$SLURM_JOB_NODELIST" \\
    | head -n1):{port}"
export NUM_PROCESSES="$SLURM_NTASKS"
# PROCESS_ID and LOCAL_RANK must be read inside each srun task: the batch
# script body runs once (where SLURM_PROCID=0), so exporting them here would
# pin every task to rank 0
srun --kill-on-bad-exit=1 bash -c {payload}
"""


def slurm_script(command: str, nodes: int, cards_per_node: int = 1,
                 name: str = "pkr_train", log_dir: str = "exp/log", port: int = 8476,
                 cpus_per_task: int = 8, directives: Sequence[str] = ()) -> str:
    """Render an sbatch script launching `command` once per card
    (``cards_per_node`` tasks on each of ``nodes`` nodes) with the
    process-group env contract (slurm.pl + conf/slurm.conf role).

    Note sbatch opens --output before the body runs: `log_dir` must exist on
    the submit host at submission time (write_slurm_script creates it)."""
    extra = "\n".join(f"#SBATCH {d}" for d in directives)
    payload = shlex.quote('export PROCESS_ID="$SLURM_PROCID"; '
                          'export LOCAL_RANK="$SLURM_LOCALID"; exec ' + command)
    return SLURM_TEMPLATE.format(name=name, nodes=nodes, cards_per_node=cards_per_node,
                                 log_dir=log_dir, log_dir_q=shlex.quote(log_dir),
                                 port=port, cpus_per_task=cpus_per_task,
                                 payload=payload, extra_directives=extra)


def write_slurm_script(path: str, command: str, nodes: int, **kw) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    os.makedirs(kw.get("log_dir", "exp/log"), exist_ok=True)
    with open(path, "w") as f:
        f.write(slurm_script(command, nodes, **kw))
    os.chmod(path, 0o755)
    return path


def launch_hosts(command: str, hosts: Sequence[str], cards_per_host: int = 1,
                 log_dir: str = "exp/log", name: str = "pkr_train",
                 port: int = 8476, transport: Optional[Sequence[str]] = None,
                 env_extra: Optional[Dict[str, str]] = None,
                 timeout: Optional[float] = None) -> List[int]:
    """ssh.pl role: run `command` once per card of every host, all
    concurrently, with the process-group env; one log a process
    (``<name>.<rank>.log``); raise JobError listing the failed ranks.

    transport: argv prefix invoked as `transport + [host, remote_cmd]`;
    defaults to ["ssh", "-o", "BatchMode=yes"].  Tests substitute a local
    shell transport — the launch logic is transport-agnostic.
    """
    transport = list(transport) if transport is not None else [
        "ssh", "-o", "BatchMode=yes"]
    os.makedirs(log_dir, exist_ok=True)
    coordinator = f"{hosts[0]}:{port}"
    world = len(hosts) * cards_per_host
    procs, logs = [], []
    for rank in range(world):
        host = hosts[rank // cards_per_host]
        exports = {
            "COORDINATOR_ADDRESS": coordinator,
            "NUM_PROCESSES": str(world),
            "PROCESS_ID": str(rank),
            "LOCAL_RANK": str(rank % cards_per_host),
            **(env_extra or {}),
        }
        prefix = " ".join(f"export {k}={shlex.quote(v)};" for k, v in exports.items())
        log_path = os.path.join(log_dir, f"{name}.{rank}.log")
        log = open(log_path, "w")
        log.write(f"# started at {time.strftime('%Y-%m-%d %H:%M:%S')} "
                  f"on {host} (process {rank}/{world})\n")
        log.flush()
        procs.append(subprocess.Popen(transport + [host, f"{prefix} {command}"],
                                      stdout=log, stderr=subprocess.STDOUT))
        logs.append(log)
    # one shared deadline (not per-wait: sequential waits would stack to
    # world * timeout); stragglers past it are killed and reported as
    # failures alongside nonzero exits, so every log gets its footer and
    # the caller always sees the full failure list
    deadline = None if timeout is None else time.monotonic() + timeout
    failures = []
    for rank, (p, log) in enumerate(zip(procs, logs)):
        try:
            remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
            rc = p.wait(timeout=remaining)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            rc = p.returncode
            log.write(f"# timed out after {timeout}s, killed\n")
        log.write(f"# finished at {time.strftime('%Y-%m-%d %H:%M:%S')} rc={rc}\n")
        log.close()
        if rc != 0:
            failures.append(rank)
    if failures:
        raise JobError(failures, log_dir)
    return [p.returncode for p in procs]
