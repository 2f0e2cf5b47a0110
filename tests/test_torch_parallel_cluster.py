"""The port's launchers and job runner (``pkr_tpu_torch.utils.{cluster,
jobs}``) and its process-group setup, as tests/test_cluster.py and
tests/test_utils_extra.py hold ``pkr_tpu``'s: the Slurm script (one task a
card: PROCESS_ID and LOCAL_RANK read inside each task), launch_hosts' logs,
fail-any and shared deadline over a local stand-in for ssh, a REAL
2-process torch group formed from the env contract alone, the fail-fast on
a partial contract, and run_jobs' results, logs, failures and retries
against pkr_tpu's."""

import os
import socket
import stat
import sys

import pytest

from pkr_tpu_torch.utils.cluster import launch_hosts, slurm_script, write_slurm_script
from pkr_tpu_torch.utils.jobs import JobError, run_jobs, summarize_logs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _local_transport(tmp_path):
    """A stand-in for ssh: ignores the host argument, runs the command
    locally (the launch logic is transport-agnostic)."""
    sh = tmp_path / "fake_ssh.sh"
    sh.write_text("#!/bin/bash\nshift\nexec bash -c \"$1\"\n")
    sh.chmod(0o755)
    return [str(sh)]


def test_slurm_script_one_task_per_card(tmp_path):
    log_dir = str(tmp_path / "log")
    path = write_slurm_script(
        str(tmp_path / "train.sbatch"),
        "python -m pkr_tpu_torch.recipes.run --stage 3 --stop-stage 3 "
        "--data-dir data --exp-dir exp",
        nodes=2, cards_per_node=8, name="vox", log_dir=log_dir, port=9999,
        directives=["--partition=gpu", "--time=24:00:00"])
    s = open(path).read()
    assert "#SBATCH --nodes=2" in s
    assert "#SBATCH --ntasks-per-node=8" in s and "#SBATCH --gpus-per-node=8" in s
    assert "#SBATCH --partition=gpu" in s and "#SBATCH --time=24:00:00" in s
    assert 'export NUM_PROCESSES="$SLURM_NTASKS"' in s
    # the rank and the card are read inside each srun task (the batch body
    # runs once, with SLURM_PROCID=0)
    srun_line = [l for l in s.splitlines() if l.startswith("srun")][0]
    assert 'export PROCESS_ID="$SLURM_PROCID"' in srun_line
    assert 'export LOCAL_RANK="$SLURM_LOCALID"' in srun_line
    assert "bash -c" in srun_line and "exec python -m pkr_tpu_torch" in srun_line
    body = s.split("srun")[0]
    assert "export PROCESS_ID" not in body and "export LOCAL_RANK" not in body
    assert ":9999" in s and f"mkdir -p {log_dir}" in s
    assert os.stat(path).st_mode & stat.S_IXUSR
    assert os.path.isdir(log_dir)


def test_slurm_script_keeps_pkr_tpus_contract():
    """Beside the tasks a node, the script is pkr_tpu's: the same
    coordinator line, cpus, fail-fast srun and log directory."""
    from pkr_tpu.utils.cluster import slurm_script as jax_slurm_script

    ours = slurm_script("prog", 3, cards_per_node=1, log_dir="L", port=7)
    ref = jax_slurm_script("prog", 3, log_dir="L", port=7)
    keep = ("#SBATCH --job-name", "#SBATCH --nodes", "#SBATCH --cpus-per-task",
            "export COORDINATOR_ADDRESS", "    | head -n1", "mkdir -p")
    for prefix in keep:
        assert ([l for l in ours.splitlines() if l.startswith(prefix)]
                == [l for l in ref.splitlines() if l.startswith(prefix)]), prefix
    assert ours.count("srun --kill-on-bad-exit=1 bash -c") == 1


def test_launch_hosts_one_process_per_card(tmp_path):
    transport = _local_transport(tmp_path)
    rcs = launch_hosts("echo process $PROCESS_ID of $NUM_PROCESSES card $LOCAL_RANK",
                       hosts=["hostA", "hostB"], cards_per_host=2,
                       log_dir=str(tmp_path / "log"), name="ok", transport=transport)
    assert rcs == [0, 0, 0, 0]
    for rank in range(4):
        text = open(tmp_path / "log" / f"ok.{rank}.log").read()
        assert f"process {rank} of 4 card {rank % 2}" in text
        assert f"on host{'AB'[rank // 2]}" in text and "rc=0" in text
    with pytest.raises(JobError) as e:
        launch_hosts("test $PROCESS_ID -ne 1", hosts=["a", "b", "c"],
                     log_dir=str(tmp_path / "log"), name="bad", transport=transport)
    assert e.value.failures == [1]


def test_launch_hosts_timeout_kills_and_reports(tmp_path):
    """A hung rank is killed at the shared deadline and reported through the
    fail-any JobError, its log footer written; the others succeed."""
    import time

    t0 = time.monotonic()
    with pytest.raises(JobError) as e:
        launch_hosts("test $PROCESS_ID -eq 0 && sleep 600; true", hosts=["a", "b"],
                     log_dir=str(tmp_path / "log"), name="hang",
                     transport=_local_transport(tmp_path), timeout=3.0)
    assert time.monotonic() - t0 < 30.0
    assert e.value.failures == [0]
    text = open(tmp_path / "log" / "hang.0.log").read()
    assert "timed out" in text and "rc=" in text
    assert "rc=0" in open(tmp_path / "log" / "hang.1.log").read()


def test_launch_hosts_forms_a_real_torch_group(tmp_path):
    """The launcher's env contract alone (no flags in the command) drives
    parallel.distributed.initialize: a 2-process gloo group forms on the
    CPU, and an all_reduce and host_info agree on both ranks."""
    worker = tmp_path / "worker.py"
    worker.write_text(f"""
import sys
sys.path.insert(0, {REPO!r})
import torch
import torch.distributed as dist
from pkr_tpu_torch.parallel.distributed import host_info, initialize, shutdown
assert initialize(device="cpu")  # everything comes from the launcher's env
pid, count, local = host_info()
x = torch.tensor([float(pid + 1)])
dist.all_reduce(x)
assert (count, local, float(x)) == (2, 1, 3.0), (count, local, float(x))
print("launched rank", pid, "sum", float(x), "backend", dist.get_backend(), "OK")
shutdown()
""")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    launch_hosts(f"{sys.executable} {worker}", hosts=["localhost", "localhost"],
                 log_dir=str(tmp_path / "log"), name="dist", port=port,
                 transport=_local_transport(tmp_path),
                 env_extra={"PYTHONPATH": REPO}, timeout=180)
    for rank in range(2):
        text = open(tmp_path / "log" / f"dist.{rank}.log").read()
        assert f"launched rank {rank} sum 3.0 backend gloo OK" in text, text


def test_initialize_rejects_incomplete_env_contract(monkeypatch):
    """A stray NUM_PROCESSES, or a contract without PROCESS_ID, fails fast
    naming the contract; nothing set is a one-process no-op."""
    from pkr_tpu_torch.parallel.distributed import initialize

    for k in ("COORDINATOR_ADDRESS", "PROCESS_ID", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("NUM_PROCESSES", "4")
    with pytest.raises(RuntimeError, match="COORDINATOR_ADDRESS"):
        initialize(device="cpu")
    monkeypatch.setenv("COORDINATOR_ADDRESS", "localhost:1")
    with pytest.raises(RuntimeError, match="PROCESS_ID"):
        initialize(device="cpu")
    monkeypatch.delenv("NUM_PROCESSES")
    monkeypatch.delenv("COORDINATOR_ADDRESS")
    assert initialize(device="cpu") is False


def _square(x):
    return x * x


def _maybe_fail(x):
    if x % 2:
        raise ValueError(f"odd {x}")
    return x


@pytest.mark.parametrize("backend", ["thread", "process"])
def test_run_jobs_matches_pkr_tpu(tmp_path, backend):
    """Results in order, one log a job with its footer, JobError naming the
    failed jobs: the same as pkr_tpu's run_jobs on the same items."""
    from pkr_tpu.utils.jobs import JobError as JaxJobError
    from pkr_tpu.utils.jobs import run_jobs as jax_run_jobs

    for pkg, run, err in (("port", run_jobs, JobError), ("ref", jax_run_jobs, JaxJobError)):
        d = tmp_path / pkg
        assert run(_square, [1, 2, 3, 4], n_jobs=2, log_dir=str(d / "ok"), name="sq",
                   backend=backend) == [1, 4, 9, 16]
        assert sorted(os.listdir(d / "ok")) == [f"sq.{j}.log" for j in (1, 2, 3, 4)]
        assert "ok" in open(d / "ok" / "sq.3.log").read()
        with pytest.raises(err) as e:
            run(_maybe_fail, [1, 2, 3, 4], n_jobs=2, log_dir=str(d / "bad"),
                backend=backend)
        assert e.value.failures == [1, 3]
        assert summarize_logs(str(d / "bad"))["Traceback"] == 2


def test_run_jobs_retries():
    calls = []

    def flaky(x):
        calls.append(x)
        if len(calls) == 1:
            raise RuntimeError("first attempt fails")
        return x

    assert run_jobs(flaky, [7], n_jobs=1, retries=1) == [7]
    assert calls == [7, 7]
