"""Run a function in separate processes — port of
``distributed_tensorflow_tpu/testing/multi_process_runner.py``.

Tasks are ``multiprocessing`` *spawn* processes (never fork: a fresh
interpreter, no inherited CUDA or thread state). Two forms:

- :func:`run` ``(fn, n)``: ``n`` ranks with the launcher environment
  that :func:`~distributed_tensorflow_tpu_torch.cluster.bootstrap.
  initialize` reads (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``MASTER_ADDR``, ``MASTER_PORT``) plus the JAX runner's
  ``DTX_MPR_TASK_INDEX`` / ``DTX_MPR_NUM_TASKS``; ``fn`` initialises
  the process group itself::

      def rank_fn(device):
          bootstrap.initialize(device=device)
          return torch.distributed.get_rank()

      result = multi_process_runner.run(rank_fn, 2, args=("cpu",),
                                        device="cpu")
      assert result.return_values == [0, 1]

- :class:`MultiProcessRunner` over a cluster spec
  (:func:`create_cluster_spec`; ``run(..., num_ps=, has_evaluator=,
  has_chief=)`` builds one): every task gets JAX's ``TF_CONFIG``, and on
  the card a chief or worker task also gets its card (``LOCAL_RANK``,
  its rank in the group); ``start``, ``poll``, ``terminate`` (SIGKILL
  one task), ``terminate_all`` and ``join``. ``run(fn, n)`` is such a
  runner too, whose ``task_env`` hook gives the launcher environment.

``fn`` must be a module-level function (spawn pickles it by import
path). A child that raises comes back as :class:`SubprocessError` with
its traceback; one that dies without reporting, or does not finish
within ``timeout``, as :class:`UnexpectedSubprocessExitError` (the
others are killed). A task that has reported stays up until every live
task has (or one has failed): rank 0 hosts the rendezvous store, which
a slower peer may still need; ``poll`` counts it with the exit code it
will leave with. A child leaves with ``os._exit``, skipping
interpreter teardown: a dead peer can leave a collective library's
shutdown waiting on it.

The recovery supervisor's primitives are JAX's: ``restart`` (one task
respawned with its environment plus overrides, the dead incarnation's
result kept in ``history``), ``reform`` (every task respawned under a
fresh cluster spec, resized with ``allow_resize``) and ``alive_tasks``.

:class:`MultiProcessPoolRunner` keeps its task processes across runs
(JAX's pool runner): each :meth:`~MultiProcessPoolRunner.run` sends the
function down a pipe with a fresh ``TF_CONFIG`` (fresh ports), so a
suite pays the spawn and the torch import once, and each run still gets
a cluster of its own. A task that must be killed mid-run needs
:class:`MultiProcessRunner`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import multiprocessing
import os
import pickle
import shutil
import socket
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, Mapping, Sequence

_MP = multiprocessing.get_context("spawn")


def pick_unused_port() -> int:
    """Reserve an ephemeral localhost port and release it for the task."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def create_cluster_spec(num_workers: int = 1, num_ps: int = 0,
                        has_chief: bool = False,
                        has_evaluator: bool = False) -> dict[str, list[str]]:
    """≙ multi_worker_test_base.create_cluster_spec: localhost addresses
    with freshly picked ports (JAX's)."""
    spec: dict[str, list[str]] = {}
    if has_chief:
        spec["chief"] = [f"127.0.0.1:{pick_unused_port()}"]
    if num_workers:
        spec["worker"] = [f"127.0.0.1:{pick_unused_port()}"
                          for _ in range(num_workers)]
    if num_ps:
        spec["ps"] = [f"127.0.0.1:{pick_unused_port()}"
                      for _ in range(num_ps)]
    if has_evaluator:
        spec["evaluator"] = [f"127.0.0.1:{pick_unused_port()}"]
    return spec


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
        reply = pickle.dumps(("ok", fn(*args, **kwargs), 0))
        exitcode = 0
    except SystemExit as e:
        # keep a platform exit code (the preemption-restart convention:
        # the recovery supervisor classifies failures by exit code)
        exitcode = e.code if isinstance(e.code, int) else \
            (0 if e.code is None else 1)
        reply = pickle.dumps(("ok", None, 0) if exitcode == 0
                             else ("error", f"SystemExit({e.code})",
                                   exitcode))
    except BaseException:
        reply = pickle.dumps(("error", traceback.format_exc(), 1))
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


def _launcher_env(num_workers: int) -> Callable[[str, int, int], dict]:
    """The task environment of :func:`run`'s launcher form: what
    ``torchrun`` gives rank ``task_id`` of ``num_workers``."""
    port = str(pick_unused_port())

    def env(task_type: str, task_id: int, task_index: int) -> dict:
        return {"RANK": str(task_id), "LOCAL_RANK": str(task_id),
                "WORLD_SIZE": str(num_workers),
                "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port}
    return env


def run(fn: Callable, num_workers: int, *, args: tuple = (),
        kwargs: dict | None = None, device="cuda",
        env: Mapping[str, str] | None = None,
        timeout: float = 300.0, num_ps: int = 0,
        has_evaluator: bool = False,
        has_chief: bool = False) -> MultiProcessRunnerResult:
    """Spawn ``num_workers`` ranks running ``fn(*args, **kwargs)``, wait
    for all, and return their results (``return_values`` in rank order).
    ``device`` is what the ranks run on: with ``"cpu"`` each child uses
    one intra-op thread; with ``"cuda"`` rank r's ``LOCAL_RANK`` is r.
    With ``num_ps``, ``has_evaluator`` or ``has_chief`` the tasks are a
    ``TF_CONFIG`` cluster instead (JAX's ``run``), ``return_values`` in
    task order (chief, evaluator, ps, worker). Raises
    :class:`SubprocessError` if a task raised, and
    :class:`UnexpectedSubprocessExitError` if one crashed or ``timeout``
    seconds passed (every task is killed first)."""
    cluster = num_ps or has_evaluator or has_chief
    spec = create_cluster_spec(num_workers=num_workers, num_ps=num_ps,
                               has_chief=has_chief,
                               has_evaluator=has_evaluator)
    runner = MultiProcessRunner(
        fn, spec, args=args, kwargs=kwargs, env=env, device=device,
        timeout=timeout,
        task_env=None if cluster else _launcher_env(num_workers))
    runner.start()
    try:
        return runner.join()
    finally:
        runner.terminate_all()


class MultiProcessRunner:
    """Run ``fn`` once a cluster task, in spawn processes (≙
    multi_process_runner.MultiProcessRunner :107): each task gets JAX's
    ``TF_CONFIG`` (``{"cluster": spec, "task": {"type", "index"}}``) and
    ``DTX_MPR_*``; a chief or worker task also gets ``LOCAL_RANK`` = its
    rank in the group (its card on ``device="cuda"``), a ``ps`` or
    ``evaluator`` task none. ``task_env(task_type, task_id, task_index)``,
    if given, makes a task's environment in place of those two.
    ``terminate`` SIGKILLs a task (≙ :646); ``restart`` and ``reform``
    respawn tasks (≙ :279, :297); ``join`` collects the results and
    raises a child's failure."""

    def __init__(self, fn: Callable, cluster_spec: Mapping[str, Sequence[str]],
                 *, args: tuple = (), kwargs: dict | None = None,
                 env: Mapping[str, str] | None = None, device="cuda",
                 timeout: float = 300.0,
                 task_env: Callable[[str, int, int], Mapping[str, str]]
                 | None = None):
        import torch
        self._fn = fn
        self._spec = {k: list(v) for k, v in cluster_spec.items()}
        self._args = args
        self._kwargs = kwargs or {}
        self._extra_env = dict(env or {})
        self._cpu = torch.device(device).type == "cpu"
        self._timeout = timeout
        self._env_fn = task_env
        self._procs: dict[tuple[str, int], Any] = {}
        self._conns: dict[tuple[str, int], Any] = {}
        self._paths: dict[tuple[str, int], str] = {}
        self._envs: dict[tuple[str, int], dict] = {}
        self._incarnation: dict[tuple[str, int], int] = {}
        self._replies: dict[tuple[str, int], tuple] = {}
        self._terminated: set = set()
        self._released = False
        self._payload: bytes | None = None
        self._tmpdir = None
        #: TaskResults of dead incarnations replaced by :meth:`restart`
        #: or dropped by :meth:`reform` (a supervisor's failure history)
        self.history: list[TaskResult] = []

    def _task_keys(self) -> list[tuple[str, int]]:
        return [(t, i) for t in sorted(self._spec)
                for i in range(len(self._spec[t]))]

    @property
    def num_tasks(self) -> int:
        return sum(len(v) for v in self._spec.values())

    def _task_env(self, task_type: str, task_id: int,
                  task_index: int) -> dict:
        env = {"DTX_MPR_NUM_TASKS": str(self.num_tasks),
               "DTX_MPR_TASK_INDEX": str(task_index)}
        if self._env_fn is not None:
            env.update(self._env_fn(task_type, task_id, task_index))
            env.update(self._extra_env)
            return env
        env["TF_CONFIG"] = json.dumps({
            "cluster": self._spec,
            "task": {"type": task_type, "index": task_id}})
        if task_type in ("chief", "worker"):
            chiefs = len(self._spec.get("chief", ()))
            env["LOCAL_RANK"] = str(task_id + chiefs
                                    if task_type == "worker" else 0)
        env.update(self._extra_env)
        return env

    def _spawn(self, key: tuple[str, int], env: dict):
        """(Re)spawn one task with ``env``; a later incarnation logs to
        a file of its own."""
        inc = self._incarnation.get(key, 0)
        os.makedirs(self._tmpdir, exist_ok=True)
        parent_conn, child_conn = _MP.Pipe()
        self._paths[key] = os.path.join(
            self._tmpdir, f"{key[0]}_{key[1]}.out" if inc == 0
            else f"{key[0]}_{key[1]}.r{inc}.out")
        p = _MP.Process(
            target=_child_main,
            args=(env, self._payload, child_conn, self._paths[key],
                  1 if self._cpu else 0),
            daemon=True)
        p.start()
        child_conn.close()
        self._procs[key], self._conns[key] = p, parent_conn
        self._envs[key] = env
        self._incarnation[key] = inc + 1
        self._replies.pop(key, None)
        self._terminated.discard(key)
        self._released = False

    def start(self) -> "MultiProcessRunner":
        self._tmpdir = tempfile.mkdtemp(prefix="mpr_")
        self._payload = pickle.dumps((self._fn, self._args, self._kwargs))
        for task_index, key in enumerate(self._task_keys()):
            self._spawn(key, self._task_env(key[0], key[1], task_index))
        return self

    def _task_result(self, key: tuple[str, int]) -> TaskResult:
        """The current incarnation's result: its reply, if it sent one,
        and its output so far."""
        status, data = self._replies.get(key, ("timeout", None, None))[:2]
        stdout = ""
        if os.path.exists(self._paths[key]):
            with open(self._paths[key], errors="replace") as f:
                stdout = f.read()
        return TaskResult(key[0], key[1], self._procs[key].exitcode,
                          value=data if status == "ok" else None,
                          error=data if status == "error" else None,
                          stdout=stdout)

    def restart(self, task_type: str, task_id: int, *,
                env: Mapping[str, str] | None = None):
        """Per-task restart (≙ :279): SIGKILL the task if still up,
        keep its result in :attr:`history`, and respawn it with its
        prior environment plus ``env`` (e.g. a fresh ``TF_CONFIG`` or a
        bumped ``DTX_CLUSTER_GENERATION``). ``join`` then waits on the
        new incarnation."""
        key = (task_type, task_id)
        p = self._procs[key]
        if p.exitcode is None:
            p.kill()
            p.join(10)
        self._read_replies(wait_s=0.0)
        self.history.append(self._task_result(key))
        self._conns[key].close()
        new_env = dict(self._envs[key])
        new_env.update(env or {})
        self._spawn(key, new_env)

    def reform(self, cluster_spec: Mapping[str, Sequence[str]] | None = None,
               *, env: Mapping[str, str] | None = None,
               allow_resize: bool = False):
        """Whole-cluster restart (≙ :297): kill every task, take a fresh
        cluster spec (fresh ports: the dead incarnation's sockets may
        linger), and respawn every task with its new ``TF_CONFIG``,
        ``LOCAL_RANK`` and ``DTX_MPR_*`` plus ``env``. The recovery
        supervisor's reform primitive. ``allow_resize=True`` lets the
        spec change the cluster's shape: dropped slots go to
        :attr:`history`, new slots spawn fresh."""
        self.terminate_all()
        if cluster_spec is not None:
            new = {k: list(v) for k, v in cluster_spec.items()}
            if sorted((t, len(v)) for t, v in new.items()) != \
                    sorted((t, len(v)) for t, v in self._spec.items()) \
                    and not allow_resize:
                raise ValueError(
                    f"reform must keep the cluster shape: "
                    f"{self._spec.keys()} -> {new.keys()}")
            old_keys = set(self._task_keys())
            self._spec = new
            self._read_replies(wait_s=0.0)
            for key in sorted(old_keys - set(self._task_keys())):
                self.history.append(self._task_result(key))
                self._conns.pop(key).close()
                for table in (self._procs, self._paths, self._envs,
                              self._replies):
                    table.pop(key, None)
        for task_index, key in enumerate(self._task_keys()):
            new_env = self._task_env(key[0], key[1], task_index)
            new_env.update(env or {})
            if key in self._procs:
                self.restart(key[0], key[1], env=new_env)
            else:
                self._spawn(key, new_env)

    def poll(self) -> dict[tuple[str, int], int]:
        """Exit codes of the tasks that have finished (non-blocking): a
        task that has reported counts with the code it will exit with,
        though it stays up until :meth:`join` releases it."""
        self._read_replies(wait_s=0.0)
        out = {}
        for key, p in self._procs.items():
            reply = self._replies.get(key)
            if reply is not None and reply[0] != "died":
                out[key] = reply[2]
            elif p.exitcode is not None:
                out[key] = p.exitcode
        return out

    def alive_tasks(self) -> list[tuple[str, int]]:
        """Tasks still running their function (not exited, not
        reported)."""
        return sorted(k for k, p in self._procs.items()
                      if p.exitcode is None and k not in self._replies)

    def terminate(self, task_type: str, task_id: int):
        """SIGKILL one task (≙ multi_process_runner.terminate :646)."""
        key = (task_type, task_id)
        self._terminated.add(key)
        p = self._procs[key]
        p.kill()
        p.join(10)

    def terminate_all(self):
        for p in self._procs.values():
            if p.is_alive():
                p.kill()
        for p in self._procs.values():
            p.join(5)

    def _read_replies(self, wait_s: float = 0.02):
        for key, conn in self._conns.items():
            if key in self._replies:
                continue
            if conn.poll(wait_s):
                try:
                    self._replies[key] = pickle.loads(conn.recv_bytes())
                except (EOFError, OSError):
                    self._replies[key] = ("died", None, None)
            elif self._procs[key].exitcode is not None \
                    and not conn.poll(0):
                self._replies[key] = ("died", None, None)

    def _release(self):
        for conn in self._conns.values():
            try:
                conn.send_bytes(b"exit")
            except (BrokenPipeError, OSError):
                pass
        self._released = True

    def join(self, timeout: float | None = None,
             raise_on_error: bool = True) -> MultiProcessRunnerResult:
        """Wait for every task (a terminated one counts as done); release
        them, collect their results and raise the first failure (unless
        ``raise_on_error`` is False). A failure releases every task at
        once: the failed one's exit then ends its peers' waits on it, as
        a crash would, and their replies are still read."""
        deadline = time.monotonic() + (timeout or self._timeout)
        try:
            # read each reply as it comes: a child blocks in send() until
            # its value is read, so waiting for exits first could deadlock
            while time.monotonic() < deadline:
                self._read_replies()
                if not self._released and any(
                        r[0] != "ok" for k, r in self._replies.items()
                        if k not in self._terminated):
                    self._release()
                if all(k in self._replies or k in self._terminated
                       for k in self._procs):
                    break
            if not self._released:
                self._release()
            for p in self._procs.values():
                p.join(max(0.0, deadline - time.monotonic()) + 5.0)
        finally:
            for p in self._procs.values():
                if p.is_alive():
                    p.kill()
                    p.join(5)
        tasks = {key: self._task_result(key) for key in self._procs}
        shutil.rmtree(self._tmpdir, ignore_errors=True)
        result = MultiProcessRunnerResult(tasks)
        if not raise_on_error:
            return result
        errors = sorted(k for k, t in tasks.items() if t.error is not None)
        if errors:
            raise SubprocessError(
                f"task {errors[0]} raised:\n{tasks[errors[0]].error}", result)
        bad = sorted(k for k, t in tasks.items() if k not in self._terminated
                     and (t.exitcode != 0 or self._replies.get(
                         k, ("timeout",))[0] != "ok"))
        if bad:
            logs = "\n".join(f"--- {k} (exit {tasks[k].exitcode}) ---\n"
                             f"{tasks[k].stdout[-2000:]}" for k in bad)
            raise UnexpectedSubprocessExitError(
                f"tasks {bad} did not report within "
                f"{timeout or self._timeout}s or exited abnormally; "
                f"stdout:\n{logs}", result)
        return result


# ---------------------------------------------------------------------------
# Pool runner: persistent task processes amortising spawn and the import
# ---------------------------------------------------------------------------

_POOL_TASK_DIED = "pool task died without reporting"


def _pool_task_cleanup():
    """Reset a pooled process between runs (JAX ``:474``): every run
    gets a fresh cluster (fresh ports in a fresh ``TF_CONFIG``), so the
    child drops the old process group and store client, the in-process
    KV and barriers, and the remote-dispatch generation; the next run's
    ``bootstrap.initialize`` rebuilds them."""
    with contextlib.suppress(Exception):
        from distributed_tensorflow_tpu_torch.cluster import bootstrap
        bootstrap.shutdown()
    with contextlib.suppress(Exception):
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()
    with contextlib.suppress(Exception):
        from distributed_tensorflow_tpu_torch.cluster import coordination
        coordination._LOCAL._kv.clear()
        coordination._LOCAL._barriers.clear()
        coordination.attach_store(None)
        coordination._AGENT = None
    with contextlib.suppress(Exception):
        rd = sys.modules.get(
            "distributed_tensorflow_tpu_torch.coordinator.remote_dispatch")
        if rd is not None:
            rd._reset_generation_for_tests()


def _pool_child_main(base_env: dict, conn, ready_path: str, threads: int):
    """Persistent pool-task entry (JAX ``:513``): import torch once,
    then serve tasks. One message a task: ``(env_updates, stdout_path,
    payload)``; the reply is ``("ok", value)`` or ``("error",
    traceback)`` as plain pickle bytes. ``None`` ends the process."""
    os.environ.update(base_env)
    sys.stdout.flush()
    sys.stderr.flush()
    import torch
    if threads:
        torch.set_num_threads(threads)
    with open(ready_path, "w") as f:
        f.write("ready")
    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            break
        if msg is None:
            break
        env_updates, stdout_path, payload = msg
        out_f = open(stdout_path, "w", buffering=1)
        os.dup2(out_f.fileno(), 1)
        os.dup2(out_f.fileno(), 2)
        # restore every variable this run sets: a caller's ``env`` must
        # not leak into later pooled runs
        env_saved = {k: os.environ.get(k) for k in env_updates}
        try:
            os.environ.update(env_updates)
            fn, args, kwargs = pickle.loads(payload)
            value = fn(*args, **kwargs)
            try:
                reply = pickle.dumps(("ok", value))
            except Exception:
                reply = pickle.dumps(("ok", repr(value)))
        except BaseException:
            reply = pickle.dumps(("error", traceback.format_exc()))
        finally:
            with contextlib.suppress(BaseException):
                _pool_task_cleanup()
            for k, old in env_saved.items():
                if old is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = old
            out_f.flush()
            out_f.close()       # fds 1/2 keep their dup'd descriptors
        conn.send_bytes(reply)
    os._exit(0)


class MultiProcessPoolRunner:
    """A persistent pool of cluster-task processes (JAX ``:561``).

    Tests share long-lived task processes, so each run pays pipe round
    trips instead of a spawn and the torch import. Every :meth:`run`
    builds a fresh localhost cluster spec (fresh ports), so runs stay
    hermetic. ``device`` is what the tasks run on: ``"cpu"`` gives each
    one intra-op thread, ``"cuda"`` gives a chief or worker task its
    card (``LOCAL_RANK``). A child that dies marks the pool broken, and
    the next ``run`` restarts it.
    """

    def __init__(self, *, num_workers: int = 2, num_ps: int = 0,
                 has_chief: bool = False, has_evaluator: bool = False,
                 device="cuda", env: Mapping[str, str] | None = None):
        import torch
        self._shape = dict(num_workers=num_workers, num_ps=num_ps,
                           has_chief=has_chief, has_evaluator=has_evaluator)
        self._cpu = torch.device(device).type == "cpu"
        self._extra_env = dict(env or {})
        self._procs: dict[tuple[str, int], Any] = {}
        self._conns: dict[tuple[str, int], Any] = {}
        self._tmpdir = None
        self._run_seq = 0

    # -- lifecycle --------------------------------------------------------
    @property
    def started(self) -> bool:
        return bool(self._procs)

    def _task_keys(self) -> list[tuple[str, int]]:
        spec = create_cluster_spec(**self._shape)
        return [(t, i) for t in sorted(spec) for i in range(len(spec[t]))]

    def start(self, timeout: float = 120.0) -> "MultiProcessPoolRunner":
        self.shutdown()
        self._tmpdir = tempfile.mkdtemp(prefix="mpp_")
        ready_paths = {}
        for key in self._task_keys():
            env = dict(self._extra_env)
            parent_conn, child_conn = _MP.Pipe()
            ready = os.path.join(self._tmpdir, f"ready_{key[0]}_{key[1]}")
            p = _MP.Process(target=_pool_child_main,
                            args=(env, child_conn, ready,
                                  1 if self._cpu else 0), daemon=True)
            p.start()
            child_conn.close()
            self._procs[key] = p
            self._conns[key] = parent_conn
            ready_paths[key] = ready
        deadline = time.monotonic() + timeout
        for key, path in ready_paths.items():
            while not os.path.exists(path):
                if time.monotonic() > deadline:
                    self.shutdown()
                    raise RuntimeError(
                        f"pool task {key} failed to come up in {timeout}s")
                if self._procs[key].exitcode is not None:
                    self.shutdown()
                    raise RuntimeError(f"pool task {key} died during startup")
                time.sleep(0.05)
        return self

    def shutdown(self):
        for conn in self._conns.values():
            with contextlib.suppress(Exception):
                conn.send(None)
        for p in self._procs.values():
            p.join(5)
            if p.is_alive():
                p.kill()
                p.join(5)
        self._procs.clear()
        self._conns.clear()
        if self._tmpdir is not None:
            shutil.rmtree(self._tmpdir, ignore_errors=True)
            self._tmpdir = None

    # -- dispatch ---------------------------------------------------------
    def run(self, fn: Callable, *, args: tuple = (),
            kwargs: dict | None = None,
            env: Mapping[str, str] | None = None,
            timeout: float = 300.0,
            raise_on_error: bool = True) -> MultiProcessRunnerResult:
        """Run ``fn`` once a cluster task on the pooled processes: the
        contract of :func:`run` (``TF_CONFIG`` tasks), without killing
        tasks. A task that raised is :class:`SubprocessError`; one that
        died, or did not report within ``timeout``, is
        :class:`UnexpectedSubprocessExitError` (the pool restarts)."""
        if not self.started or any(p.exitcode is not None
                                   for p in self._procs.values()):
            # a child died while the pool was idle: restart
            self.start()
        self._run_seq += 1
        spec = create_cluster_spec(**self._shape)
        payload = pickle.dumps((fn, args, kwargs or {}))
        ntasks = sum(len(v) for v in spec.values())
        chiefs = len(spec.get("chief", ()))
        stdout_paths: dict[tuple[str, int], str] = {}
        task_index = 0
        for task_type in sorted(spec):
            for task_id in range(len(spec[task_type])):
                key = (task_type, task_id)
                env_updates = {
                    "TF_CONFIG": json.dumps({
                        "cluster": spec,
                        "task": {"type": task_type, "index": task_id}}),
                    "DTX_MPR_NUM_TASKS": str(ntasks),
                    "DTX_MPR_TASK_INDEX": str(task_index),
                }
                if task_type in ("chief", "worker"):
                    env_updates["LOCAL_RANK"] = str(
                        task_id + chiefs if task_type == "worker" else 0)
                env_updates.update(env or {})
                stdout_path = os.path.join(
                    self._tmpdir,
                    f"run{self._run_seq}_{task_type}_{task_id}.out")
                stdout_paths[key] = stdout_path
                self._conns[key].send((env_updates, stdout_path, payload))
                task_index += 1

        results: dict[tuple[str, int], TaskResult] = {}
        deadline = time.monotonic() + timeout
        pending = dict(self._conns)
        broken = False
        while pending and time.monotonic() < deadline:
            for key, conn in list(pending.items()):
                value, error, got = None, None, False
                if conn.poll(0.05):
                    try:
                        status, data = pickle.loads(conn.recv_bytes())
                        got = True
                        if status == "ok":
                            value = data
                        else:
                            error = data
                    except (EOFError, OSError):
                        got, error, broken = True, _POOL_TASK_DIED, True
                elif self._procs[key].exitcode is not None:
                    got, error, broken = True, _POOL_TASK_DIED, True
                if got:
                    stdout = ""
                    path = stdout_paths[key]
                    if os.path.exists(path):
                        with open(path, errors="replace") as f:
                            stdout = f.read()
                    results[key] = TaskResult(
                        task_type=key[0], task_id=key[1],
                        exitcode=self._procs[key].exitcode or 0,
                        value=value, error=error, stdout=stdout)
                    del pending[key]
        if pending or broken:
            self.shutdown()      # the next run restarts cleanly
            if pending:
                raise UnexpectedSubprocessExitError(
                    f"pooled tasks {sorted(pending)} did not report within "
                    f"{timeout}s (pool restarted)",
                    MultiProcessRunnerResult(results))
        result = MultiProcessRunnerResult(results)
        if raise_on_error:
            crashed = sorted(k for k, t in results.items()
                             if t.error == _POOL_TASK_DIED)
            if crashed:
                raise UnexpectedSubprocessExitError(
                    f"pooled tasks {crashed} died without reporting "
                    f"(pool restarted)", result)
            errors = sorted(k for k, t in results.items()
                            if t.error is not None)
            if errors:
                raise SubprocessError(
                    f"pooled task {errors[0]} raised:\n"
                    f"{results[errors[0]].error}", result)
        return result
