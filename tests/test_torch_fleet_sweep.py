"""Port parity: ``tools/torch_fleet_sweep.py`` against the JAX package's
``tools/fleet_sweep.py`` on the same inputs.

- ``--check`` over the checked-in ``FLEET_r*.json`` / ``DATA_r*.json``
  (the JAX package's records), over tampered copies of them in another
  ``--repo`` and over a ``--repo`` without them: the same standard
  output, standard error and return code, byte for byte (``--seeds 0``:
  the curve gates alone).
- The gate functions ``check_curve`` and ``check_data_curve`` return
  JAX's violations on the checked-in rows and on tampered rows.
- A seeded sweep through the port's ``testing/fleet_sim`` and its real
  ``RecoverySupervisor`` at the tool's defaults (3 seeds, 64 workers, 12
  steps; JAX's own sweep at 16 workers and 6 steps loses seed 0 to its
  KV GC timing, on the CPU): every seed survives in both,
  and the printed lines are JAX's but for each seed's measured seconds.
"""

import copy
import importlib.util
import json
import os
import re
import shutil
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import torch_fleet_sweep as port  # noqa: E402


def _jax_tool(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_sweep():
    return _jax_tool("fleet_sweep")


def _call(main, argv, capsys):
    capsys.readouterr()
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def _rows(pattern):
    with open(os.path.join(REPO, pattern)) as f:
        return json.load(f)["rows"]


def _tamper_fleet(rows):
    rows = copy.deepcopy(rows)
    rows[-1]["extra"]["ops_per_worker_per_step"] *= 50
    rows[0]["extra"].pop("mttr_ms", None)
    return rows


def _tamper_data(rows):
    rows = copy.deepcopy(rows)
    hi = max(rows, key=lambda r: r["extra"]["n_input_workers"])
    hi["extra"]["churn_duplicates"] = 3
    hi["vs_baseline"] = 0.5
    return rows


@pytest.fixture(scope="module")
def repos(tmp_path_factory):
    tampered = tmp_path_factory.mktemp("tampered")
    for name, fn in (("FLEET_r01.json", _tamper_fleet),
                     ("DATA_r01.json", _tamper_data)):
        with open(os.path.join(REPO, name)) as f:
            rec = json.load(f)
        rec["rows"] = fn(rec["rows"])
        with open(tampered / name.replace("r01", "r02"), "w") as f:
            json.dump(rec, f)
        shutil.copy(os.path.join(REPO, name), tampered / name)
    return {"repo": REPO, "tampered": str(tampered),
            "empty": str(tmp_path_factory.mktemp("empty"))}


@pytest.mark.parametrize("which,rc", [("repo", 0), ("tampered", 1),
                                      ("empty", 1)])
def test_check_is_byte_identical(jax_sweep, repos, which, rc, capsys):
    argv = ["--check", "--seeds", "0", "--repo", repos[which]]
    want = _call(jax_sweep.main, argv, capsys)
    got = _call(port.main, argv + ["--device", "cpu"], capsys)
    assert got == want
    assert want[0] == rc


@pytest.mark.parametrize("name", ["FLEET_r01.json", "DATA_r01.json"])
@pytest.mark.parametrize("tampered", [False, True], ids=["clean",
                                                          "tampered"])
def test_curve_gates_equal_jax(jax_sweep, name, tampered):
    rows = _rows(name)
    if tampered:
        rows = (_tamper_fleet if name.startswith("FLEET")
                else _tamper_data)(rows)
    fn = "check_curve" if name.startswith("FLEET") else "check_data_curve"
    want = getattr(jax_sweep, fn)(copy.deepcopy(rows))
    assert getattr(port, fn)(copy.deepcopy(rows)) == want
    assert bool(want) == tampered
    for bad in ([], [{"extra": {}}]):
        assert getattr(port, fn)(bad) == getattr(jax_sweep, fn)(bad)


def _untimed(text):
    return re.sub(r"\(\d+\.\d+s\)", "(_s)", text)


def test_seeded_sweep_survives_as_jax(jax_sweep, capsys):
    argv = ["--seeds", "3"]
    want = _call(jax_sweep.main, argv, capsys)
    got = _call(port.main, argv + ["--device", "cpu"], capsys)
    assert want[0] == got[0] == 0
    assert _untimed(got[1]) == _untimed(want[1])
    assert got[2] == want[2]
    assert "survival: 3/3 seeds (100%) at N=64" in got[1]
