"""Run a function once per rank in separate processes — port of what data
parallelism needs of ``distributed_tensorflow_tpu/testing/
multi_process_runner.py``.

Ranks are ``multiprocessing`` *spawn* processes (never fork: a fresh
interpreter, no inherited CUDA or thread state). Each child gets the
launcher environment that :func:`~distributed_tensorflow_tpu_torch.
cluster.bootstrap.initialize` reads (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) plus the JAX runner's
``DTX_MPR_TASK_INDEX`` / ``DTX_MPR_NUM_TASKS``, and calls ``fn`` —
which initialises the process group itself::

    def rank_fn(device):
        bootstrap.initialize(device=device)
        return torch.distributed.get_rank()

    result = multi_process_runner.run(rank_fn, 2, args=("cpu",),
                                      device="cpu")
    assert result.return_values == [0, 1]

``fn`` must be a module-level function (spawn pickles it by import
path). A child that raises comes back as :class:`SubprocessError` with
its traceback; one that dies without reporting, or does not finish
within ``timeout``, as :class:`UnexpectedSubprocessExitError` (the
others are killed). A rank that has reported stays up until every rank
has (or one has failed): rank 0 hosts the rendezvous store, which a
slower peer may still need to build its process groups. ``restart``,
``reform`` and ``terminate`` belong to a later slice.
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import os
import pickle
import shutil
import socket
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, Mapping

_MP = multiprocessing.get_context("spawn")


def pick_unused_port() -> int:
    """Reserve an ephemeral localhost port and release it for the task."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@dataclasses.dataclass
class TaskResult:
    task_type: str
    task_id: int
    exitcode: int | None
    value: Any = None
    error: str | None = None
    stdout: str = ""


@dataclasses.dataclass
class MultiProcessRunnerResult:
    """Every rank's :class:`TaskResult`, keyed ``("worker", rank)``."""
    tasks: dict[tuple[str, int], TaskResult]

    @property
    def return_values(self) -> list[Any]:
        """The ranks' return values, in rank order."""
        return [t.value for t in self._ordered() if t.error is None
                and t.exitcode == 0]

    @property
    def stdout(self) -> list[str]:
        return [t.stdout for t in self._ordered()]

    def _ordered(self) -> list[TaskResult]:
        return [self.tasks[k] for k in sorted(self.tasks)]


class UnexpectedSubprocessExitError(RuntimeError):
    """A rank died without reporting a result, or timed out."""

    def __init__(self, msg: str, result: MultiProcessRunnerResult):
        super().__init__(msg)
        self.mpr_result = result


class SubprocessError(RuntimeError):
    """A rank raised; the message carries its traceback."""

    def __init__(self, msg: str, result: MultiProcessRunnerResult):
        super().__init__(msg)
        self.mpr_result = result


def _child_main(env: dict, payload: bytes, conn, stdout_path: str,
                threads: int):
    """Spawn-process entry: the environment first, then ``fn``."""
    os.environ.update(env)
    sys.stdout.flush()
    sys.stderr.flush()
    out_f = open(stdout_path, "w", buffering=1)
    os.dup2(out_f.fileno(), 1)
    os.dup2(out_f.fileno(), 2)
    try:
        if threads:
            import torch
            torch.set_num_threads(threads)
        fn, args, kwargs = pickle.loads(payload)
        reply = pickle.dumps(("ok", fn(*args, **kwargs)))
        exitcode = 0
    except BaseException:
        reply = pickle.dumps(("error", traceback.format_exc()))
        exitcode = 1
    # plain pickle bytes: the connection's own pickler would hand tensors
    # over as shared-memory handles, which die with this process
    conn.send_bytes(reply)
    out_f.flush()
    # stay up until the parent releases every rank: rank 0 hosts the
    # rendezvous store, and a peer that is still building its process
    # groups (a mesh dim rank 0 is no member of) needs it after rank 0
    # has finished
    try:
        conn.recv_bytes()
    except (EOFError, OSError):
        pass
    conn.close()
    # skip interpreter teardown: a peer that died can leave a collective
    # library's shutdown waiting on it
    os._exit(exitcode)


def run(fn: Callable, num_workers: int, *, args: tuple = (),
        kwargs: dict | None = None, device="cuda",
        env: Mapping[str, str] | None = None,
        timeout: float = 300.0) -> MultiProcessRunnerResult:
    """Spawn ``num_workers`` ranks running ``fn(*args, **kwargs)``, wait
    for all, and return their results (``return_values`` in rank order).
    ``device`` is what the ranks run on: with ``"cpu"`` each child uses
    one intra-op thread; with ``"cuda"`` rank r's ``LOCAL_RANK`` is r.
    Raises :class:`SubprocessError` if a rank raised, and
    :class:`UnexpectedSubprocessExitError` if one crashed or ``timeout``
    seconds passed (every rank is killed first)."""
    import torch
    cpu = torch.device(device).type == "cpu"
    port = pick_unused_port()
    payload = pickle.dumps((fn, args, kwargs or {}))
    tmpdir = tempfile.mkdtemp(prefix="mpr_")
    procs, conns, paths = {}, {}, {}
    for rank in range(num_workers):
        child_env = {"RANK": str(rank), "LOCAL_RANK": str(rank),
                     "WORLD_SIZE": str(num_workers),
                     "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                     "DTX_MPR_TASK_INDEX": str(rank),
                     "DTX_MPR_NUM_TASKS": str(num_workers)}
        child_env.update(env or {})
        parent_conn, child_conn = _MP.Pipe()
        paths[rank] = os.path.join(tmpdir, f"worker_{rank}.out")
        p = _MP.Process(target=_child_main,
                        args=(child_env, payload, child_conn, paths[rank],
                              1 if cpu else 0),
                        daemon=True)
        p.start()
        child_conn.close()
        procs[rank], conns[rank] = p, parent_conn
    replies: dict[int, tuple] = {}
    deadline = time.monotonic() + timeout
    released = False

    def release():
        # every rank may exit now: all have reported, or one failed (its
        # exit then ends the peers' waits on it, as a crash would)
        for conn in conns.values():
            try:
                conn.send_bytes(b"exit")
            except (BrokenPipeError, OSError):
                pass

    try:
        # read each reply as it comes: a child blocks in send() until
        # its value is read, so waiting for exits first could deadlock
        while len(replies) < num_workers and time.monotonic() < deadline:
            for rank, conn in conns.items():
                if rank in replies:
                    continue
                if conn.poll(0.02):
                    try:
                        replies[rank] = pickle.loads(conn.recv_bytes())
                    except (EOFError, OSError):
                        replies[rank] = ("died", None)
                elif procs[rank].exitcode is not None and not conn.poll(0):
                    replies[rank] = ("died", None)
                if (not released and rank in replies
                        and replies[rank][0] != "ok"):
                    release()
                    released = True
        if not released:
            release()
        for p in procs.values():
            p.join(max(0.0, deadline - time.monotonic()) + 5.0)
    finally:
        for p in procs.values():
            if p.is_alive():
                p.kill()
                p.join(5)
    tasks = {}
    for rank, p in procs.items():
        status, data = replies.get(rank, ("timeout", None))
        stdout = ""
        if os.path.exists(paths[rank]):     # not if it died at start-up
            with open(paths[rank], errors="replace") as f:
                stdout = f.read()
        tasks[("worker", rank)] = TaskResult(
            "worker", rank, p.exitcode,
            value=data if status == "ok" else None,
            error=data if status == "error" else None, stdout=stdout)
    shutil.rmtree(tmpdir, ignore_errors=True)
    result = MultiProcessRunnerResult(tasks)
    errors = sorted(k for k, t in tasks.items() if t.error is not None)
    if errors:
        raise SubprocessError(
            f"task {errors[0]} raised:\n{tasks[errors[0]].error}", result)
    bad = sorted(k for k, t in tasks.items() if t.exitcode != 0
                 or replies.get(k[1], ("timeout",))[0] != "ok")
    if bad:
        logs = "\n".join(f"--- {k} (exit {tasks[k].exitcode}) ---\n"
                         f"{tasks[k].stdout[-2000:]}" for k in bad)
        raise UnexpectedSubprocessExitError(
            f"tasks {bad} did not report within {timeout}s or exited "
            f"abnormally; stdout:\n{logs}", result)
    return result
