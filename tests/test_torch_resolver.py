"""Port parity: the cluster resolvers (``cluster/resolver.py``,
``cluster/platform_resolvers.py``) against the JAX package's on the same
environments — the spec, ``master``, ``num_processes``, ``process_id``,
``is_chief``, the task and the Slurm expansions exactly equal — and the
port's ``bootstrap.initialize`` from a resolver (the world counts chief
and worker tasks only; a ``ps`` or ``evaluator`` task is outside the
group). ``num_accelerators`` differs on purpose: the visible cards."""

import json

import pytest
import torch

from distributed_tensorflow_tpu.cluster import platform_resolvers as jpr
from distributed_tensorflow_tpu.cluster import resolver as jr
from distributed_tensorflow_tpu_torch.cluster import platform_resolvers as tpr
from distributed_tensorflow_tpu_torch.cluster import resolver as tr

SPECS = {
    "workers": {"worker": ["h0:2222", "h1:2222", "h2:2222"]},
    "chief": {"chief": ["c:1"], "worker": ["h0:2", "h1:2"]},
    "ps": {"chief": ["c:1"], "worker": ["h0:2"], "ps": ["p0:3", "p1:3"]},
    "evaluator": {"worker": ["h0:2", "h1:2"], "evaluator": ["e:9"]},
    "sparse": {"worker": {0: "a:1", 2: "c:3"}},
    "empty": {},
}
TASKS = [("workers", "worker", 0), ("workers", "worker", 2),
         ("chief", "chief", 0), ("chief", "worker", 1),
         ("ps", "worker", 0), ("ps", "chief", 0),
         ("evaluator", "worker", 1),
         ("empty", None, 0)]


def _facts(r, with_process: bool = True) -> dict:
    spec = r.cluster_spec()
    out = {"spec": spec.as_dict(), "jobs": spec.jobs,
           "total": spec.num_total_tasks, "bool": bool(spec),
           "master": r.master(), "is_chief": r.is_chief(),
           "num_processes": r.num_processes(),
           "task": (r.task_type, r.task_id),
           "environment": r.environment}
    if with_process:
        out["process_id"] = r.process_id()
    return out


@pytest.mark.parametrize("name,task_type,index", TASKS)
def test_tf_config_resolver_matches_jax(monkeypatch, name, task_type, index):
    cfg = {"cluster": SPECS[name]}
    if task_type is not None:
        cfg["task"] = {"type": task_type, "index": index}
    cfg["environment"] = "cloud"
    monkeypatch.setenv("TF_CONFIG", json.dumps(cfg))
    assert _facts(tr.TFConfigClusterResolver()) == \
        _facts(jr.TFConfigClusterResolver())


@pytest.mark.parametrize("task_type", ["ps", "evaluator"])
def test_tasks_outside_the_group_match_jax(monkeypatch, task_type):
    """``ps`` / ``evaluator``: no rank (``process_id`` raises for ps in
    both), the same master and the same world (chief and workers)."""
    cfg = {"cluster": SPECS["ps"] | {"evaluator": ["e:9"]},
           "task": {"type": task_type, "index": 0}}
    monkeypatch.setenv("TF_CONFIG", json.dumps(cfg))
    t, j = tr.TFConfigClusterResolver(), jr.TFConfigClusterResolver()
    assert _facts(t, False) == _facts(j, False)
    if task_type == "ps":
        for r in (t, j):
            with pytest.raises(ValueError):
                r.process_id()
    else:
        assert t.process_id() == j.process_id()


def test_tf_config_overrides_and_errors_match_jax(monkeypatch):
    monkeypatch.setenv("TF_CONFIG", json.dumps(
        {"cluster": SPECS["chief"], "task": {"type": "worker", "index": 0}}))
    t = tr.TFConfigClusterResolver(task_type="chief", task_id=0)
    j = jr.TFConfigClusterResolver(task_type="chief", task_id=0)
    assert _facts(t) == _facts(j)
    monkeypatch.setenv("TF_CONFIG", "{not json")
    for mod in (tr, jr):
        with pytest.raises(ValueError, match="Malformed"):
            mod.TFConfigClusterResolver()


@pytest.mark.parametrize("name", sorted(SPECS))
def test_cluster_spec_and_helpers_match_jax(name):
    t, j = tr.ClusterSpec(SPECS[name]), jr.ClusterSpec(SPECS[name])
    assert t.as_dict() == j.as_dict() and t.jobs == j.jobs
    assert repr(t) == repr(j)
    if not j:
        return
    assert tr.coordinator_address(t) == jr.coordinator_address(j)
    for job in j.jobs:
        for mod, spec in ((tr, t), (jr, j)):
            assert mod.worker_count(spec, job) == jr.worker_count(j, job)
        for i in range(j.num_tasks(job)):
            assert tr.is_chief(t, job, i) == jr.is_chief(j, job, i)
            if job in ("chief", "worker", "evaluator"):
                assert tr.id_in_cluster(t, job, i) == \
                    jr.id_in_cluster(j, job, i)


def test_validate_and_simple_resolver_match_jax():
    for mod in (tr, jr):
        spec = mod.ClusterSpec({"worker": ["a:1"], "chief": ["c:0"]})
        mod.validate_cluster_spec(spec, "worker", 0)
        with pytest.raises(ValueError):
            mod.validate_cluster_spec(spec, "worker", 5)
        with pytest.raises(ValueError):
            mod.validate_cluster_spec(
                mod.ClusterSpec({"chief": ["a", "b"]}), "chief", 0)
    t = tr.SimpleClusterResolver(tr.ClusterSpec(SPECS["chief"]), "worker", 1,
                                 environment="google")
    j = jr.SimpleClusterResolver(jr.ClusterSpec(SPECS["chief"]), "worker", 1,
                                 environment="google")
    assert _facts(t) == _facts(j)
    assert t.master("worker", 0) == j.master("worker", 0)


@pytest.mark.parametrize("env", [
    {"TPU_WORKER_HOSTNAMES": "t0,t1,t2,t3", "TPU_WORKER_ID": "2"},
    {"TPU_WORKER_HOSTNAMES": "t0,t1", "TPU_WORKER_ID": "0",
     "MEGASCALE_COORDINATOR_ADDRESS": "m0"},
    {"TPU_WORKER_HOSTNAMES": "t0", "MEGASCALE_COORDINATOR_ADDRESS": "m:9"},
    {}])
def test_tpu_resolver_matches_jax(monkeypatch, env):
    for k in ("TPU_WORKER_HOSTNAMES", "TPU_WORKER_ID",
              "MEGASCALE_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert _facts(tr.TPUClusterResolver()) == _facts(jr.TPUClusterResolver())


def test_num_accelerators_counts_the_visible_cards():
    """Differs on purpose: JAX counts ``jax.local_devices()``."""
    r = tr.SimpleClusterResolver(tr.ClusterSpec({}))
    assert r.num_accelerators() == torch.cuda.device_count()
    md = tr.TPUClusterResolver().get_tpu_system_metadata()
    assert md["num_hosts"] == 1
    assert md["num_cores"] == max(1, torch.cuda.device_count())


HOSTLISTS = ["n[1-3,7],m0", "gpu[01-03]", "a,b,c", "x[9-11]y",
             "node[1-2],gpu[05-06]", "single"]


@pytest.mark.parametrize("hostlist", HOSTLISTS)
def test_expand_hostlist_matches_jax(hostlist):
    assert tpr.expand_hostlist(hostlist) == jpr.expand_hostlist(hostlist)


@pytest.mark.parametrize("spec", ["2(x3),1", "4", "1(x2),3(x1),2"])
def test_expand_tasks_per_node_matches_jax(spec):
    assert tpr.expand_tasks_per_node(spec) == \
        jpr.expand_tasks_per_node(spec)
    with pytest.raises(ValueError):
        tpr.expand_tasks_per_node("x2")


SLURM = [({"SLURM_STEP_NUM_TASKS": "4", "SLURM_PROCID": "3",
           "SLURM_STEP_NODELIST": "n[1-2]",
           "SLURM_STEP_TASKS_PER_NODE": "2(x2)"}, None),
         ({"SLURM_STEP_NUM_TASKS": "3", "SLURM_PROCID": "0",
           "SLURM_STEP_NODELIST": "a,b,c"}, {"ps": 1, "worker": 2}),
         ({"SLURM_NPROCS": "2", "SLURM_PROCID": "1",
           "SLURM_NODELIST": "gpu[07-08]"}, None)]


@pytest.mark.parametrize("env,jobs", SLURM)
def test_slurm_resolver_matches_jax(env, jobs):
    t = tpr.SlurmClusterResolver(jobs=jobs, env=env)
    j = jpr.SlurmClusterResolver(jobs=jobs, env=env)
    assert _facts(t, False) == _facts(j, False)


def test_platform_resolvers_match_jax():
    env = {"SM_HOSTS": json.dumps(["algo-2", "algo-1"]),
           "SM_CURRENT_HOST": "algo-2"}
    assert _facts(tpr.SageMakerClusterResolver(env=env)) == \
        _facts(jpr.SageMakerClusterResolver(env=env))

    def hosts(project, zone, group):
        return ["w-b", "w-a"]
    assert _facts(tpr.GCEClusterResolver("p", "z", "g",
                                         list_instances_fn=hosts)) == \
        _facts(jpr.GCEClusterResolver("p", "z", "g",
                                      list_instances_fn=hosts))

    def pods(selector):
        return [("p1", "10.0.0.2", "Running"), ("p0", "10.0.0.1", "Running")]
    mapping = {"worker": ["job-name=w"], "ps": ["job-name=p"]}
    t = tpr.KubernetesClusterResolver(mapping, list_pods_fn=pods)
    j = jpr.KubernetesClusterResolver(mapping, list_pods_fn=pods)
    assert t.cluster_spec().as_dict() == j.cluster_spec().as_dict()
    with pytest.raises(RuntimeError, match="Running"):
        tpr.KubernetesClusterResolver(list_pods_fn=lambda s: [
            ("p", "1.2.3.4", "Pending")]).cluster_spec()
    with pytest.raises(ValueError):
        tpr.SlurmClusterResolver(jobs={"worker": 5}, env=SLURM[0][0])


@pytest.fixture
def fresh_bootstrap():
    from distributed_tensorflow_tpu_torch.cluster import bootstrap
    bootstrap.shutdown()
    yield bootstrap
    bootstrap.shutdown()


def test_initialize_from_a_one_task_tf_config(monkeypatch, fresh_bootstrap):
    monkeypatch.setenv("TF_CONFIG", json.dumps(
        {"cluster": {"worker": ["127.0.0.1:1"]},
         "task": {"type": "worker", "index": 0}}))
    rt = fresh_bootstrap.initialize(device="cpu")
    assert (rt.num_processes, rt.process_id, rt.in_group, rt.backend,
            rt.task_type, rt.task_id) == (1, 0, True, "gloo", "worker", 0)
    assert rt.is_chief


def test_evaluator_is_outside_the_group(monkeypatch, fresh_bootstrap):
    """An evaluator makes no process group; its KV client is lazy (the
    store is the trainers'), so initialize returns at once."""
    import torch.distributed as dist
    from distributed_tensorflow_tpu_torch.cluster import coordination
    monkeypatch.setenv("TF_CONFIG", json.dumps(
        {"cluster": {"worker": ["127.0.0.1:1", "127.0.0.1:2"],
                     "evaluator": ["127.0.0.1:3"]},
         "task": {"type": "evaluator", "index": 0}}))
    rt = fresh_bootstrap.initialize(device="cpu")
    assert not dist.is_initialized()
    assert (rt.in_group, rt.backend, rt.task_type, rt.is_chief,
            rt.coordinator_address) == (False, None, "evaluator", False,
                                        "127.0.0.1:1")
    agent = coordination.CoordinationServiceAgent()
    assert agent.process_id == -1 and agent.num_processes == 2
    fresh_bootstrap.shutdown()
    assert coordination.CoordinationServiceAgent().process_id == 0


def test_cuda_without_a_card_raises(monkeypatch, fresh_bootstrap):
    if torch.cuda.is_available():
        pytest.skip("has a card")
    monkeypatch.delenv("TF_CONFIG", raising=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        fresh_bootstrap.initialize()
