"""Port parity, host-exact: the KV generation sweeper
(``cluster/kv_gc.py``) on each package's in-process coordination
service, and ``Topology`` / ``DeviceAssignment``
(``cluster/topology.py``) on the same device stand-ins, against the JAX
package's: the keys left, the generations swept and every topology
answer equal."""

import dataclasses

import pytest
import torch

from distributed_tensorflow_tpu.cluster import coordination as jco
from distributed_tensorflow_tpu.cluster import elastic as jel
from distributed_tensorflow_tpu.cluster import kv_gc as jgc
from distributed_tensorflow_tpu.cluster import topology as jtopo
from distributed_tensorflow_tpu_torch.cluster import coordination as tco
from distributed_tensorflow_tpu_torch.cluster import elastic as tel
from distributed_tensorflow_tpu_torch.cluster import kv_gc as tgc
from distributed_tensorflow_tpu_torch.cluster import topology as ttopo

PACKAGES = {"jax": (jco, jel, jgc), "port": (tco, tel, tgc)}


def _fill(co, el, tag):
    agent = co.coordination_service()
    with el.generation_override(0):
        for g in range(5):
            for k in ("hb/0", "hb/1", "ckpt/commit"):
                agent.key_value_set(f"gen{g}/{tag}/{k}", "1")
        agent.key_value_set(f"{tag}/plain", "1")
    return agent


def _keys(co, el, tag):
    with el.generation_override(0):
        return sorted(k for k, _ in co.coordination_service()
                      .key_value_dir_get("") if f"/{tag}/" in k
                      or k.startswith(f"{tag}/"))


def _sweep_run(name, tag):
    co, el, gc = PACKAGES[name]
    agent = _fill(co, el, tag)
    out = [gc.generation_prefix(7),
           gc.sweep_generations(agent, [0, 1, 3, 4, 9], current_gen=4)]
    out.append(_keys(co, el, tag))
    sweeper = gc.GenerationGC(agent, grace_s=10.0)
    sweeper.note_generation_end(0, 100.0)
    sweeper.note_generation_end(2, 100.0)
    sweeper.note_generation_end(4, 104.0)
    sweeper.note_generation_end(2, 95.0)          # keeps the later wall
    out += [sweeper.pending(),
            sweeper.maybe_sweep(current_gen=6, now=105.0),
            sweeper.maybe_sweep(current_gen=6, now=110.0),
            sweeper.pending(),
            sweeper.maybe_sweep(current_gen=6, now=200.0),
            sweeper.swept, _keys(co, el, tag)]
    return out


def test_kv_gc_matches_jax():
    assert _sweep_run("port", "gc_t") == [
        x if not isinstance(x, list) or not x or not isinstance(x[0], str)
        else [k.replace("gc_j", "gc_t") for k in x]
        for x in _sweep_run("jax", "gc_j")]
    assert tgc.DEFAULT_GRACE_S == jgc.DEFAULT_GRACE_S


@dataclasses.dataclass(frozen=True)
class _Dev:
    id: int
    process_index: int = 0
    coords: tuple | None = None
    core_on_chip: int = 0
    platform: str = "stand-in"


DEVICE_SETS = {
    "flat": tuple(_Dev(i) for i in range(8)),
    "two_hosts": tuple(_Dev(i, process_index=i // 4) for i in range(8)),
    "torus": tuple(_Dev(i, coords=(i % 2, (i // 2) % 2, 0),
                        core_on_chip=i // 4) for i in range(8)),
}


def _topology_answers(mod, devices, nproc, pidx):
    t = mod.Topology(devices=devices, num_processes=nproc,
                     process_index=pidx, platform="stand-in")
    out = [t.num_devices, t.num_devices_per_process, t.local_devices(),
           t.mesh_shape]
    for reps, cores in ((None, 1), (4, 2), (2, 4), (None, 2)):
        da = mod.DeviceAssignment.build(t, reps, cores)
        out.append((da.num_replicas, da.num_cores_per_replica,
                    [da.device(r, c) for r in range(da.num_replicas)
                     for c in range(cores)],
                    [da.replica_devices(r)
                     for r in range(da.num_replicas)]))
    with pytest.raises(ValueError, match="devices"):
        mod.DeviceAssignment.build(t, 5, 2)
    return out


@pytest.mark.parametrize("name", sorted(DEVICE_SETS))
@pytest.mark.parametrize("nproc,pidx", [(1, 0), (2, 1)])
def test_topology_and_device_assignment_match_jax(name, nproc, pidx):
    devs = DEVICE_SETS[name]
    assert _topology_answers(ttopo, devs, nproc, pidx) == \
        _topology_answers(jtopo, devs, nproc, pidx)


def test_topology_detects_the_visible_cards():
    t = ttopo.Topology.detect()
    n = torch.cuda.device_count()
    assert t.devices == (tuple(torch.device("cuda", i) for i in range(n))
                         or (torch.device("cpu"),))
    assert t.platform == ("gpu" if n else "cpu")
    assert (t.num_processes, t.process_index) == (1, 0)
    assert t.mesh_shape == (t.num_devices,)
    fake = ttopo.Topology.detect(DEVICE_SETS["flat"])
    assert fake.platform == "stand-in" and fake.num_devices == 8
