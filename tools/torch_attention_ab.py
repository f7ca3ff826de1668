#!/usr/bin/env python3
"""The bf16 attention kernels of an earlier checkout against this tree's,
in turns, on one GPU.

    git archive <commit> distributed_tensorflow_tpu_torch | tar -x -C DIR
    python3 tools/torch_attention_ab.py --parent DIR

``DIR`` holds the port's package as an earlier commit had it; its own
``ops/_build.py`` builds its kernel sources into its own build
directory. At the train step's shape ``(8, 16, 1024, 64)`` and the serve
shape ``(1, 16, 1024, 64)``, bf16 causal, on the same seeded inputs, the
parent's C entry points ``flash_fwd`` and ``flash_bwd_dkv`` and this
tree's wrappers (the kernels ``attention_route`` names) are each held to
the plain version with ``chip_smoke.py``'s ``TOL`` / ``GRAD_TOL``, then
timed with CUDA events in turns parent, this, this, parent. Prints one
JSON line per shape and kernel, then the card's name and power limit.
Needs a CUDA device; imports nothing of JAX.
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
    args = ap.parse_args()
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
        o, lse = torch.empty_like(q), torch.empty_like(plse)

        def parent_fwd():
            _ok("flash_fwd", fwd.flash_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), b * h, s, s, hd, 1, ctypes.c_float(sm), 1, 0,
                stream))

        def this_fwd():
            return A.flash_attention_fwd(q, k, v, causal=True)

        parent_fwd()
        to, tlse = this_fwd()
        delta = (to.float() * do.float()).sum(-1)
        kw = dict(sm_scale=sm, causal=True, causal_offset=0)
        dk, dv = torch.empty_like(k), torch.empty_like(v)

        def parent_dkv():
            _ok("flash_bwd_dkv", bwd.flash_bwd_dkv(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                tlse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), b * h, s, s, hd, 1, ctypes.c_float(sm), 1, 0,
                stream))

        def this_dkv():
            return A.launch_bwd_dkv(q, k, v, do, tlse, delta, **kw)

        parent_dkv()
        tdk, tdv = this_dkv()
        torch.cuda.synchronize()
        _, pdk, pdv = A.flash_attention_bwd_plain(q, k, v, to, tlse, do,
                                                  causal=True, sm_scale=sm)
        errs = {
            "fwd": {"parent_o": cs.abs_err(o, po),
                    "this_o": cs.abs_err(to, po),
                    "parent_lse": cs.abs_err(lse, plse),
                    "this_lse": cs.abs_err(tlse, plse)},
            "dkv": {"parent": max(cs.rel_err(dk, pdk), cs.rel_err(dv, pdv)),
                    "this": max(cs.rel_err(tdk, pdk), cs.rel_err(tdv, pdv))}}
        tol = cs.TOL["bfloat16"]
        ok &= (max(errs["fwd"]["parent_o"], errs["fwd"]["this_o"]) <= tol["o"]
               and max(errs["fwd"]["parent_lse"], errs["fwd"]["this_lse"])
               <= tol["lse"]
               and max(errs["dkv"].values()) <= cs.GRAD_TOL["bfloat16"])
        kernels = [("flash_fwd", parent_fwd, this_fwd, "fwd")]
        if tag == "train":
            kernels.append(("flash_bwd_dkv", parent_dkv, this_dkv, "dkv"))
        for name, parent_fn, this_fn, which in kernels:
            p1 = cs.time_ms(parent_fn)
            t1 = cs.time_ms(this_fn)
            t2 = cs.time_ms(this_fn)
            p2 = cs.time_ms(parent_fn)
            flops, nbytes = cs.attention_work(q, k, True, 0, which)
            bound, bound_by = cs.bound_ms(flops, nbytes, q.dtype)
            this_ms, parent_ms = (t1 + t2) / 2, (p1 + p2) / 2
            cs.emit({"shape_name": tag, "shape": list(shape),
                     "dtype": "bfloat16", "kernel": name,
                     "route": A.attention_route(q.dtype, hd, which),
                     "parent_ms": parent_ms, "parent_ms_runs": [p1, p2],
                     "ms": this_ms, "ms_runs": [t1, t2],
                     "speedup": parent_ms / this_ms,
                     "bound_ms": bound, "bound_by": bound_by,
                     "tflops": flops / (this_ms * 1e-3) / 1e12,
                     "parent_tflops": flops / (parent_ms * 1e-3) / 1e12,
                     "bound_share": bound / this_ms, "errors": errs[which]})
    print(cs.nvidia_smi(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
