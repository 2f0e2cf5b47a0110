"""Local parallel job runner with per-job logs.

A copy of ``pkr_tpu/utils/jobs.py`` for the port.  The reference's
parallelism substrate is run.pl / queue.pl / slurm.pl — `cmd JOB=1:N log
dir/x.JOB.log prog args` forking N shell jobs and failing if any fail
(SURVEY §2.8).  Host-side work (corpus prep, wav decoding, ark writing)
still benefits from a process pool.  This module is the same contract as a
python API:

    run_jobs(fn, items, n_jobs=30, log_dir="exp/log", name="make_fbank")

- each job writes <log_dir>/<name>.<j>.log with start/end timestamps and the
  traceback on failure (run.pl's log format role);
- raises JobError if ANY job failed, after all have finished (run.pl:10);
- retries per job are available (`retries=`), covering utils/retry.pl.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence


class JobError(RuntimeError):
    def __init__(self, failures: List[int], log_dir: Optional[str]):
        self.failures = failures
        msg = f"{len(failures)} job(s) failed: {failures[:10]}"
        if log_dir:
            msg += f" (logs in {log_dir})"
        super().__init__(msg)


def _worker(fn, item, j, log_path, retries):
    start = time.strftime("%Y-%m-%d %H:%M:%S")
    log = open(log_path, "w") if log_path else None

    def say(s):
        if log:
            log.write(s + "\n")
            log.flush()

    say(f"# started at {start}")
    for attempt in range(retries + 1):
        try:
            result = fn(item)
            say(f"# finished at {time.strftime('%Y-%m-%d %H:%M:%S')} ok")
            if log:
                log.close()
            return (j, True, result)
        except Exception:
            say(f"# attempt {attempt + 1} failed:\n{traceback.format_exc()}")
    say(f"# giving up after {retries + 1} attempts")
    if log:
        log.close()
    return (j, False, None)


def run_jobs(fn: Callable[[Any], Any], items: Sequence[Any],
             n_jobs: int = 4, log_dir: Optional[str] = None,
             name: str = "job", retries: int = 0,
             backend: str = "thread") -> List[Any]:
    """Map fn over items in parallel; returns results in order.

    backend='thread' (default) suits the common I/O-bound jobs (wav decode
    pipes, ark writes) and accepts closures; backend='process' forks like
    run.pl did (fn must be picklable)."""
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
    args = []
    for j, item in enumerate(items):
        log_path = os.path.join(log_dir, f"{name}.{j + 1}.log") if log_dir else None
        args.append((fn, item, j, log_path, retries))
    if n_jobs <= 1 or len(items) <= 1:
        outs = [_worker(*a) for a in args]
    elif backend == "thread":
        from multiprocessing.pool import ThreadPool

        with ThreadPool(min(n_jobs, len(items))) as pool:
            outs = pool.starmap(_worker, args)
    else:
        with mp.get_context("fork").Pool(min(n_jobs, len(items))) as pool:
            outs = pool.starmap(_worker, args)
    outs.sort(key=lambda t: t[0])
    failures = [j + 1 for j, ok, _ in outs if not ok]
    if failures:
        raise JobError(failures, log_dir)
    return [r for _, _, r in outs]


def summarize_logs(log_dir: str, patterns: Sequence[str] = ("WARNING", "ERROR",
                                                            "Traceback")) -> Dict[str, int]:
    """Scan a job-log directory for warning/error lines and return counts per
    pattern (the utils/summarize_warnings.pl triage role, SURVEY §4.4)."""
    import glob

    counts = {p: 0 for p in patterns}
    for path in sorted(glob.glob(os.path.join(log_dir, "*.log"))):
        for line in open(path, errors="replace"):
            for p in patterns:
                if p in line:
                    counts[p] += 1
    return counts
