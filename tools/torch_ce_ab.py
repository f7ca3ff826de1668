#!/usr/bin/env python3
"""A bf16 cross-entropy backward of an earlier checkout against this
tree's, in turns, on one GPU.

    git archive <commit> distributed_tensorflow_tpu_torch | tar -x -C DIR
    python3 tools/torch_ce_ab.py --parent DIR [--variant split|a]

``DIR`` holds the port's package as an earlier commit had it, built by
its own ``ops/_build.py`` (``tools/torch_attention_ab.py``'s
``parent_build``). At the train step's chunk (N 4096, V 32768, D 1024,
bf16) on the same seeded inputs, the parent's CUDA-core C entry points
called in bf16 against this tree's tensor-core kernels:

- ``--variant split`` (the default): each pass of the split backward,
  the parent's ``fused_ce_dh`` and ``fused_ce_de`` against
  ``fused_ce_dh_tc`` and ``fused_ce_de_tc``; one line per pass and one
  for the pair;
- ``--variant a``: the merged backward "a", the parent's
  ``fused_ce_bwd_a`` (its dh accumulator zeroed before and cast to bf16
  after, as its wrapper did) against this tree's
  ``fused_ce_bwd(..., variant="a")``, which launches
  ``fused_ce_bwd_a_tc``; both outputs (dh, dE).

Each is held to its plain version within ``chip_smoke.py``'s
``GRAD_TOL["bfloat16"]``, then timed with CUDA events in turns parent,
this, this, parent. Prints one JSON line per kernel, then the card's
name and power limit. Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from torch_attention_ab import parent_build  # noqa: E402

N, V, D = 4096, 32768, 1024


def _check(err: int, entry: str):
    if err != 0:
        raise RuntimeError(f"{entry} (parent) failed: CUDA error {err}")


def _row(kernel, parent_kernel, which, parent, this, errs):
    """Time ``parent`` and ``this`` in turns; the line of the pair."""
    import torch
    p1 = cs.time_ms(parent, 3, 1)
    t1 = cs.time_ms(this, 3, 1)
    t2 = cs.time_ms(this, 3, 1)
    p2 = cs.time_ms(parent, 3, 1)
    flops, nbytes = cs.ce_work(N, V, D, 2, which)
    bound, bound_by = cs.bound_ms(flops, nbytes, torch.bfloat16)
    this_ms, parent_ms = (t1 + t2) / 2, (p1 + p2) / 2
    return {"shape": [N, V, D], "dtype": "bfloat16", "kernel": kernel,
            "parent_kernel": parent_kernel, "parent_ms": parent_ms,
            "parent_ms_runs": [p1, p2], "ms": this_ms, "ms_runs": [t1, t2],
            "speedup": parent_ms / this_ms, "bound_ms": bound,
            "bound_by": bound_by,
            "tflops": flops / (this_ms * 1e-3) / 1e12,
            "bound_share": bound / this_ms, "rel_errors": errs,
            "tol": cs.GRAD_TOL["bfloat16"]}


def split_rows(lib, ce, h, e, t, lse, g, ptrs, stream):
    import torch
    rows, total = [], {"parent_ms": 0.0, "ms": 0.0}
    for which, like in (("dh", h), ("de", e)):
        parent_out, this_out = torch.empty_like(like), torch.empty_like(like)
        entry = f"fused_ce_{which}"

        def parent():
            _check(getattr(lib, entry)(*ptrs, parent_out.data_ptr(), N, V, D,
                                       1, stream), entry)

        def this():
            ce._launch(f"{entry}_tc", h.device, *ptrs, this_out.data_ptr(),
                       N, V, D, source="fused_ce_tc")

        parent()
        this()
        torch.cuda.synchronize()
        want = getattr(ce, f"{entry}_plain")(h, e, t, lse, g)
        errs = {"parent": cs.rel_err(parent_out, want),
                "this": cs.rel_err(this_out, want)}
        del want
        row = _row(f"{entry}_tc", entry, which, parent, this, errs)
        total["parent_ms"] += row["parent_ms"]
        total["ms"] += row["ms"]
        rows.append(row)
    rows.append({"pair": "split (dh + dE)", **total,
                 "speedup": total["parent_ms"] / total["ms"]})
    return rows


def a_rows(lib, ce, h, e, t, lse, g, ptrs, stream):
    import torch
    dh_acc = torch.zeros((N, D), dtype=torch.float32, device="cuda")
    parent_de = torch.empty_like(e)
    got = {}

    def parent():
        dh_acc.zero_()
        _check(lib.fused_ce_bwd_a(*ptrs, dh_acc.data_ptr(),
                                  parent_de.data_ptr(), N, V, D, 1, stream),
               "fused_ce_bwd_a")
        got["parent"] = (dh_acc.to(torch.bfloat16), parent_de)

    def this():
        got["this"] = ce.fused_ce_bwd(h, e, t, lse, g, variant="a")

    before = ce.fused_ce_bwd.launches_a_tc
    parent()
    this()
    torch.cuda.synchronize()
    if ce.fused_ce_bwd.launches_a_tc != before + 1:
        raise AssertionError("fused_ce_bwd(variant='a') did not launch "
                             "fused_ce_bwd_a_tc")
    wdh, wde = ce.fused_ce_bwd_plain(h, e, t, lse, g)
    errs = {f"{who}_{name}": cs.rel_err(x, w)
            for who, pair in got.items()
            for name, x, w in zip(("dh", "de"), pair, (wdh, wde))}
    del wdh, wde
    return [_row("fused_ce_bwd_a_tc", "fused_ce_bwd_a", "bwd", parent, this,
                 errs)]


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--variant", choices=("split", "a"), default="split")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_ce_ab: no CUDA device", file=sys.stderr)
        return 2
    from distributed_tensorflow_tpu_torch.ops import fused_ce as ce

    lib = parent_build(os.path.abspath(args.parent)).load(
        "fused_ce", ce.CE_ARGTYPES)
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(0)
    h = cs._rand((N, D), torch.bfloat16, gen)
    e = cs._rand((V, D), torch.bfloat16, gen, 0.1)
    t = torch.randint(0, V, (N,), device="cuda", generator=gen)
    t32 = t.to(torch.int32)
    g = torch.rand(N, device="cuda", generator=gen) / N
    lse, _ = ce.fused_ce_fwd(h, e, t)
    ptrs = (h.data_ptr(), e.data_ptr(), t32.data_ptr(), lse.data_ptr(),
            g.data_ptr())
    rows = (split_rows if args.variant == "split" else a_rows)(
        lib, ce, h, e, t, lse, g, ptrs, stream)
    ok = True
    for row in rows:
        ok &= max(row.get("rel_errors", {0: 0}).values()) \
            <= cs.GRAD_TOL["bfloat16"]
        cs.emit(row)
    print(cs.nvidia_smi(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
