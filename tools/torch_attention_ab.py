#!/usr/bin/env python3
"""The bf16 attention kernels of an earlier checkout against this tree's,
in turns, on one GPU.

    git archive <commit> distributed_tensorflow_tpu_torch | tar -x -C DIR
    python3 tools/torch_attention_ab.py --parent DIR [--ops dq]

``DIR`` holds the port's package as an earlier commit had it; its own
``ops/_build.py`` builds its kernel sources into its own build
directory. ``--ops`` names the kernels to compare (comma-separated, of
``fwd``, ``dq``, ``dkv``; default ``dq``): for each, the parent's
CUDA-core C entry point (``flash_fwd``, ``flash_bwd_dq``,
``flash_bwd_dkv``) called in bf16, which a parent from before this
tree's tensor-core kernel of that op still takes, against this tree's
wrapper (the kernel ``attention_route`` names). At the train step's
shape ``(8, 16, 1024, 64)`` (and for ``fwd`` also the serve shape
``(1, 16, 1024, 64)``), bf16 causal, on the same seeded inputs, both
are held to the plain version with ``chip_smoke.py``'s ``TOL`` /
``GRAD_TOL``, then timed with CUDA events in turns parent, this, this,
parent. Prints one JSON line per shape and kernel, then the card's name
and power limit. Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

SHAPES = {"train": (8, 16, 1024, 64), "serve": (1, 16, 1024, 64)}
OPS = ("fwd", "dq", "dkv")


def parent_build(parent: str):
    """The parent checkout's own ``ops/_build`` module, which builds from
    and into that checkout."""
    path = os.path.join(parent, "distributed_tensorflow_tpu_torch", "ops",
                        "_build.py")
    spec = importlib.util.spec_from_file_location("parent_build", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ok(entry: str, err: int):
    if err != 0:
        raise RuntimeError(f"{entry} (parent) failed: CUDA error {err}")


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--ops", default="dq")
    args = ap.parse_args()
    ops = args.ops.split(",")
    if not set(ops) <= set(OPS):
        ap.error(f"--ops: {ops} not all in {OPS}")
    if not torch.cuda.is_available():
        print("torch_attention_ab: no CUDA device", file=sys.stderr)
        return 2
    from distributed_tensorflow_tpu_torch.ops import attention as A

    pb = parent_build(os.path.abspath(args.parent))
    fwd = pb.load("flash_fwd", {"flash_fwd": A.FLASH_FWD_ARGTYPES})
    bwd = pb.load("flash_bwd", A.FLASH_BWD_ARGTYPES)
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(0)
    ok = True
    for tag, shape in SHAPES.items():
        b, h, s, hd = shape
        q, k, v, do = (cs._rand(shape, torch.bfloat16, gen) for _ in range(4))
        sm = hd ** -0.5
        po, plse = A.flash_attention_plain(q, k, v, causal=True, sm_scale=sm)
        pdq, pdk, pdv = A.flash_attention_bwd_plain(
            q, k, v, po, plse, do, causal=True, sm_scale=sm)
        delta = (po.float() * do.float()).sum(-1)
        kw = dict(sm_scale=sm, causal=True, causal_offset=0)
        # the parent's outputs, and the C arguments its entry points share
        o, lse = torch.empty_like(q), torch.empty_like(plse)
        dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
        tail = (b * h, s, s, hd, 1, ctypes.c_float(sm), 1, 0, stream)
        ins = (q.data_ptr(), k.data_ptr(), v.data_ptr())
        bwd_ins = ins + (do.data_ptr(), plse.data_ptr(), delta.data_ptr())

        kernels = {
            "fwd": (lambda: _ok("flash_fwd", fwd.flash_fwd(
                        *ins, o.data_ptr(), lse.data_ptr(), *tail)),
                    lambda: A.flash_attention_fwd(q, k, v, causal=True),
                    "flash_fwd"),
            "dq": (lambda: _ok("flash_bwd_dq", bwd.flash_bwd_dq(
                       *bwd_ins, dq.data_ptr(), *tail)),
                   lambda: A.launch_bwd_dq(q, k, v, do, plse, delta, **kw),
                   "flash_bwd_dq"),
            "dkv": (lambda: _ok("flash_bwd_dkv", bwd.flash_bwd_dkv(
                        *bwd_ins, dk.data_ptr(), dv.data_ptr(), *tail)),
                    lambda: A.launch_bwd_dkv(q, k, v, do, plse, delta, **kw),
                    "flash_bwd_dkv"),
        }
        for op in ops:
            if op != "fwd" and tag != "train":
                continue
            parent_fn, this_fn, name = kernels[op]
            parent_fn()
            got = this_fn()
            torch.cuda.synchronize()
            if op == "fwd":
                tol = cs.TOL["bfloat16"]
                errs = {"parent_o": cs.abs_err(o, po),
                        "this_o": cs.abs_err(got[0], po),
                        "parent_lse": cs.abs_err(lse, plse),
                        "this_lse": cs.abs_err(got[1], plse)}
                ok &= (max(errs["parent_o"], errs["this_o"]) <= tol["o"]
                       and max(errs["parent_lse"], errs["this_lse"])
                       <= tol["lse"])
            else:
                pairs = ([(dq, got, pdq)] if op == "dq" else
                         [(dk, got[0], pdk), (dv, got[1], pdv)])
                errs = {"parent": max(cs.rel_err(p, w) for p, _, w in pairs),
                        "this": max(cs.rel_err(t, w) for _, t, w in pairs)}
                ok &= max(errs.values()) <= cs.GRAD_TOL["bfloat16"]
            del got
            p1 = cs.time_ms(parent_fn)
            t1 = cs.time_ms(this_fn)
            t2 = cs.time_ms(this_fn)
            p2 = cs.time_ms(parent_fn)
            flops, nbytes = cs.attention_work(q, k, True, 0, op)
            bound, bound_by = cs.bound_ms(flops, nbytes, q.dtype)
            this_ms, parent_ms = (t1 + t2) / 2, (p1 + p2) / 2
            cs.emit({"shape_name": tag, "shape": list(shape),
                     "dtype": "bfloat16", "kernel": name,
                     "route": A.attention_route(q.dtype, hd, op),
                     "parent_ms": parent_ms, "parent_ms_runs": [p1, p2],
                     "ms": this_ms, "ms_runs": [t1, t2],
                     "speedup": parent_ms / this_ms,
                     "bound_ms": bound, "bound_by": bound_by,
                     "tflops": flops / (this_ms * 1e-3) / 1e12,
                     "parent_tflops": flops / (parent_ms * 1e-3) / 1e12,
                     "bound_share": bound / this_ms, "errors": errs})
    print(cs.nvidia_smi(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
