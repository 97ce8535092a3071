"""Start the ranks of a multi-process CPU test (gloo) and wait for them,
and the test that a failing rank fails the run at once.

A ``tests/test_torch_distributed_*.py`` file is also the worker: run as a
script it joins the process group and runs one case. It imports the port
only, never JAX, so its ranks start in a few seconds. The helpers here
import nothing of either package.
"""

import os
import socket
import subprocess
import sys
import time
from typing import List, Sequence

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_env() -> dict:
    """The ranks' environment: the repository importable, one thread each
    (the ranks of a test share the worker's cores)."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def wait_all(procs: List[subprocess.Popen], logs: Sequence[str],
             timeout: float) -> None:
    """Wait for every process; on a failure or past ``timeout`` seconds
    kill the rest and fail with the logs' tails."""
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while True:
            codes = [p.poll() for p in procs]
            bad = [i for i, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited with {codes[bad[0]]}"
                break
            if all(c == 0 for c in codes):
                return
            if time.monotonic() > deadline:
                failed = f"ranks still running after {timeout:.0f} s"
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    tails = []
    for i, path in enumerate(logs):
        with open(path) as fh:
            tails.append(f"--- rank {i} ---\n{fh.read()[-3000:]}")
    raise AssertionError(failed + "\n" + "\n".join(tails))


def run_ranks(script: str, case: str, world: int, out_dir: str,
              *args: str, timeout: float = 300.0) -> None:
    """Run ``python script case rank world port out_dir *args`` for every
    rank and wait for all of them."""
    os.makedirs(out_dir, exist_ok=True)
    port = free_port()
    procs, logs = [], []
    for rank in range(world):
        log = os.path.join(out_dir, f"{case}_rank{rank}.log")
        logs.append(log)
        with open(log, "w") as fh:
            procs.append(subprocess.Popen(
                [sys.executable, script, case, str(rank), str(world),
                 str(port), out_dir, *args],
                cwd=REPO, env=rank_env(), stdout=fh,
                stderr=subprocess.STDOUT))
    wait_all(procs, logs, timeout)


def worker_main(cases: dict) -> None:
    """A worker's entry: join the gloo group on the coordinator the test
    chose, run the case, leave the group."""
    case, rank, world, port, out_dir = sys.argv[1:6]
    import torch

    from vqa_transfer_externaldata_torch.parallel.mesh import (
        maybe_initialize_distributed)

    torch.set_num_threads(1)
    assert maybe_initialize_distributed(
        "on", f"localhost:{port}", int(world), int(rank), backend="gloo")
    cases[case](int(rank), int(world), out_dir, *sys.argv[6:])
    torch.distributed.destroy_process_group()


def test_a_failing_rank_fails_the_run_and_the_rest_are_killed(tmp_path):
    """Rank 1 exits 3 as soon as rank 0 has said it is up (at most 10 s
    on), so that rank 0's line is in its log however loaded the machine
    is; rank 0 would sleep a minute. The run fails naming rank 1 within
    seconds, rank 0 killed, its log in the message."""
    script = tmp_path / "worker.py"
    script.write_text(
        "import os, sys, time\n"
        "print('rank', sys.argv[2], 'up', flush=True)\n"
        "if sys.argv[2] == '1':\n"
        "    log = os.path.join(sys.argv[5], 'case_rank0.log')\n"
        "    end = time.monotonic() + 10\n"
        "    while time.monotonic() < end:\n"
        "        with open(log) as fh:\n"
        "            if 'rank 0 up' in fh.read():\n"
        "                break\n"
        "        time.sleep(0.05)\n"
        "    sys.exit(3)\n"
        "time.sleep(60)\n")
    start = time.monotonic()
    try:
        run_ranks(str(script), "case", 2, str(tmp_path), timeout=30)
    except AssertionError as e:
        msg = str(e)
    else:
        raise AssertionError("a failing rank did not fail the run")
    assert time.monotonic() - start < 20
    assert msg.startswith("rank 1 exited with 3"), msg
    assert "rank 0 up" in msg and "rank 1 up" in msg


def test_a_rank_past_its_timeout_fails_the_run(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text("import time\ntime.sleep(60)\n")
    start = time.monotonic()
    try:
        run_ranks(str(script), "case", 2, str(tmp_path), timeout=2)
    except AssertionError as e:
        assert str(e).startswith("ranks still running after 2 s"), e
    else:
        raise AssertionError("a hung rank did not fail the run")
    assert time.monotonic() - start < 15

