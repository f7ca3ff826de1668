"""What the port's entry-point scripts (``tools/torch_<name>.py``, each
the counterpart of the JAX package's ``examples/<name>.py`` or
``tools/<name>.py``) share: the ``--device`` flag and its refusal, the
import path of a script's worker functions, the axes parser and the
run report.

- ``--device {cuda,cpu}`` (default ``cuda``) is the one flag a port
  script adds to its JAX counterpart's. There is no fallback: asking
  for the card on a machine without CUDA exits non-zero with a message
  that names CUDA (:func:`check_device`).
- A function that spawned processes run (a rank, a supervised worker)
  is handed to the process runner as ``worker("torch_<name>", fn)``,
  imported under the script's module name from ``tools/`` (which
  :mod:`multiprocessing`'s spawn passes on in ``sys.path``), never
  pickled from ``__main__``.
- A script over a mesh (``--axes``) runs its ``rank_main`` through
  :func:`run_ranks`, each rank opening with :class:`Rank`.
- With ``DTX_ENTRY_REPORT`` set, :func:`write_report` writes the
  process's kernel launch counters and the script's own measurements
  there as one JSON object, for a harness that runs the script as a
  subprocess (``chip_smoke.py entry_points``).
"""

from __future__ import annotations

import importlib
import json
import os
import sys

TOOLS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TOOLS)
for _p in (REPO, TOOLS):
    if _p not in sys.path:
        sys.path.insert(0, _p)

#: where :func:`write_report` writes (unset: nowhere)
ENV_REPORT = "DTX_ENTRY_REPORT"


def add_device_flag(ap):
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the port runs: the card (default; no "
                         "CUDA exits non-zero) or the CPU")


def check_device(device: str, prog: str) -> str:
    """``device``, or ``SystemExit`` naming CUDA when it is ``"cuda"``
    and ``torch.cuda.is_available()`` is False."""
    if device == "cuda":
        import torch
        if not torch.cuda.is_available():
            raise SystemExit(
                f"{prog}: --device cuda (the default) needs a CUDA "
                f"device, and torch.cuda.is_available() is False; pass "
                f"--device cpu to run on the CPU")
    return device


def worker(module: str, name: str):
    """``module.name``, imported by the module's name (``tools/`` is on
    ``sys.path``), so a spawned process can import it in turn."""
    return getattr(importlib.import_module(module), name)


def parse_axes(spec: str) -> dict:
    """``"dp=2,tp=2"`` → ``{"dp": 2, "tp": 2}`` (JAX's parser)."""
    out = {}
    for kv in spec.split(","):
        k, v = kv.split("=")
        out[k] = int(v)
    return out


def world_of(axes: dict, device: str) -> int:
    """The ranks a mesh of ``axes`` needs, one a card: a -1 is filled
    from the visible cards (on the CPU from one process)."""
    known = 1
    for v in axes.values():
        if v != -1:
            known *= v
    if -1 not in axes.values():
        return known
    if device == "cuda":
        import torch
        return torch.cuda.device_count()
    return known


class Rank:
    """One rank of a mesh script (or its only process): the process
    group from the launcher's variables, the mesh of ``--axes``, the
    printed lines (``say``) and, at :meth:`finish`, rank 0's report."""

    def __init__(self, args_dict: dict, echo: bool):
        import argparse

        import torch.distributed as dist

        from distributed_tensorflow_tpu_torch.cluster import bootstrap
        from distributed_tensorflow_tpu_torch.cluster.topology import (
            make_mesh)
        self.args = argparse.Namespace(**args_dict)
        self.owned = not dist.is_initialized()
        self.rt = bootstrap.initialize(device=self.args.device)
        self.mesh = make_mesh(parse_axes(self.args.axes),
                              device=self.args.device)
        self.echo = echo
        self.lines: list = []

    def say(self, line: str):
        self.lines.append(line)
        if self.echo:
            print(line, flush=True)

    def finish(self, out: dict) -> dict:
        """``out`` with the lines; written as the report on rank 0."""
        from distributed_tensorflow_tpu_torch.cluster import bootstrap
        out = {"lines": self.lines, "rank": self.rt.process_id, **out}
        if self.rt.process_id == 0:
            write_report(out)
        if self.owned:
            bootstrap.shutdown()
        return out


def run_ranks(prog: str, rank_main, args, *extra) -> dict:
    """``rank_main(vars(args), *extra, echo=True)`` in this process when
    the mesh of ``args.axes`` has one rank or a launcher started it
    (``WORLD_SIZE`` set), else over spawned ranks (``rank_main`` imported
    from ``prog`` by name), whose rank 0 lines are printed once they
    finish. Returns rank 0's results."""
    check_device(args.device, prog)
    world = world_of(parse_axes(args.axes), args.device)
    if world == 1 or "WORLD_SIZE" in os.environ:
        return rank_main(vars(args), *extra, echo=True)
    from distributed_tensorflow_tpu_torch.testing import multi_process_runner
    result = multi_process_runner.run(
        worker(prog, rank_main.__name__), world,
        args=(vars(args), *extra), device=args.device, timeout=3600)
    out = result.return_values[0]
    for line in out["lines"]:
        print(line, flush=True)
    return out


def write_report(extra: "dict | None" = None, suffix: str = ""):
    """This process's launch counters and ``extra`` as JSON at
    ``$DTX_ENTRY_REPORT`` (+ ``suffix``); nothing when it is unset."""
    path = os.environ.get(ENV_REPORT)
    if not path:
        return
    from distributed_tensorflow_tpu_torch.ops import launch_counts
    path += suffix
    with open(path + ".tmp", "w") as f:
        json.dump({"launches": launch_counts(), **(extra or {})}, f)
    os.replace(path + ".tmp", path)
