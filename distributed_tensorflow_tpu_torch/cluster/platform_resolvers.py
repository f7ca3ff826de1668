"""Platform-specific cluster resolvers: Slurm, SageMaker, GCE, Kubernetes
— port of ``distributed_tensorflow_tpu/cluster/platform_resolvers.py``,
host logic only and the same answers on the same environment.

≙ the reference's platform resolver family (SURVEY.md §2.4, ~1,020 LoC):
tensorflow/python/distribute/cluster_resolver/slurm_cluster_resolver.py,
sagemaker_cluster_resolver.py, gce_cluster_resolver.py,
kubernetes_cluster_resolver.py. The env-variable contracts are kept
verbatim so reference launch scripts resolve identically; the cloud-API
resolvers (GCE, Kubernetes) take an injectable client so the spec-shaping
logic is testable without the optional SDKs.
"""

from __future__ import annotations

import json
import os
import re
from typing import Callable, Mapping, Sequence

from distributed_tensorflow_tpu_torch.cluster.resolver import (
    ClusterResolver,
    ClusterSpec,
)


# ---------------------------------------------------------------------------
# Slurm (≙ slurm_cluster_resolver.py, 397 LoC — env contract kept)
# ---------------------------------------------------------------------------

def expand_hostlist(hostlist: str) -> list[str]:
    """Expand a Slurm nodelist: "n[1-3,7],m0" -> [n1, n2, n3, n7, m0]
    (≙ slurm_cluster_resolver.expand_hostlist)."""
    hosts: list[str] = []

    def expand_range(prefix: str, body: str):
        for part in body.split(","):
            if "-" in part:
                lo, hi = part.split("-")
                width = len(lo)
                for i in range(int(lo), int(hi) + 1):
                    hosts.append(f"{prefix}{str(i).zfill(width)}")
            else:
                hosts.append(f"{prefix}{part}")

    # split on commas not inside brackets
    for item in re.findall(r"[^,\[]+(?:\[[^\]]*\])?", hostlist):
        m = re.match(r"(.+?)\[([^\]]*)\]$", item)
        if m:
            expand_range(m.group(1), m.group(2))
        elif item:
            hosts.append(item)
    return hosts


def expand_tasks_per_node(spec: str) -> list[int]:
    """"2(x3),1" -> [2, 2, 2, 1] (≙ _expand_tasks_per_node)."""
    out: list[int] = []
    for part in spec.split(","):
        m = re.match(r"(\d+)(?:\(x(\d+)\))?$", part)
        if not m:
            raise ValueError(f"Bad SLURM_TASKS_PER_NODE component {part!r}")
        out.extend([int(m.group(1))] * int(m.group(2) or 1))
    return out


class SlurmClusterResolver(ClusterResolver):
    """Resolve the cluster from Slurm step environment variables.

    ≙ slurm_cluster_resolver.SlurmClusterResolver: tasks are distributed
    over the expanded nodelist according to SLURM_STEP_TASKS_PER_NODE;
    ``jobs`` maps job names to task counts (default: all "worker").
    """

    def __init__(self, jobs: Mapping[str, int] | None = None,
                 port_base: int = 8888, gpus_per_node: int | None = None,
                 gpus_per_task: int | None = None,
                 auto_set_gpu: bool = False,
                 env: Mapping[str, str] | None = None):
        del gpus_per_node, gpus_per_task, auto_set_gpu  # GPU-era knobs
        self._env = dict(env if env is not None else os.environ)
        self._port_base = port_base
        nprocs = int(self._env.get("SLURM_STEP_NUM_TASKS",
                                   self._env.get("SLURM_NPROCS", "1")))
        self._jobs = dict(jobs) if jobs else {"worker": nprocs}
        if sum(self._jobs.values()) != nprocs:
            raise ValueError(
                f"jobs {self._jobs} sum to {sum(self._jobs.values())} but "
                f"Slurm step has {nprocs} tasks")
        self._proc_id = int(self._env.get("SLURM_PROCID", "0"))
        self.task_type, self.task_id = self._my_task()

    def _addresses(self) -> list[str]:
        nodelist = self._env.get("SLURM_STEP_NODELIST",
                                 self._env.get("SLURM_NODELIST", ""))
        if not nodelist:
            raise RuntimeError("Not running under a Slurm step "
                               "(SLURM_STEP_NODELIST unset)")
        nodes = expand_hostlist(nodelist)
        tpn_spec = self._env.get("SLURM_STEP_TASKS_PER_NODE",
                                 self._env.get("SLURM_TASKS_PER_NODE", ""))
        tasks_per_node = (expand_tasks_per_node(tpn_spec) if tpn_spec
                          else [1] * len(nodes))
        addrs = []
        for node, n_tasks in zip(nodes, tasks_per_node):
            for local in range(n_tasks):
                addrs.append(f"{node}:{self._port_base + local}")
        return addrs

    def _assignment(self) -> dict[str, list[str]]:
        addrs = self._addresses()
        out: dict[str, list[str]] = {}
        i = 0
        for job, count in self._jobs.items():
            out[job] = addrs[i:i + count]
            i += count
        return out

    def _my_task(self) -> tuple[str, int]:
        i = self._proc_id
        for job, count in self._jobs.items():
            if i < count:
                return job, i
            i -= count
        raise ValueError(f"SLURM_PROCID {self._proc_id} out of range")

    def cluster_spec(self) -> ClusterSpec:
        return ClusterSpec(self._assignment())

    @property
    def environment(self) -> str:
        return ""


# ---------------------------------------------------------------------------
# SageMaker (≙ sagemaker_cluster_resolver.py, 204 LoC — env contract kept)
# ---------------------------------------------------------------------------

class SageMakerClusterResolver(ClusterResolver):
    """Resolve from SageMaker training env (SM_HOSTS / SM_CURRENT_HOST)."""

    def __init__(self, port: int = 2223,
                 env: Mapping[str, str] | None = None):
        self._env = dict(env if env is not None else os.environ)
        self._port = port
        hosts = json.loads(self._env.get("SM_HOSTS", "[]"))
        if not hosts:
            raise RuntimeError("Not on SageMaker (SM_HOSTS unset/empty)")
        self._hosts = sorted(hosts)
        current = self._env.get("SM_CURRENT_HOST", self._hosts[0])
        self.task_type = "worker"
        self.task_id = self._hosts.index(current)

    def cluster_spec(self) -> ClusterSpec:
        return ClusterSpec(
            {"worker": [f"{h}:{self._port}" for h in self._hosts]})

    @property
    def environment(self) -> str:
        return ""


# ---------------------------------------------------------------------------
# GCE (≙ gce_cluster_resolver.py, 207 LoC — instance-group discovery)
# ---------------------------------------------------------------------------

class GCEClusterResolver(ClusterResolver):
    """Resolve workers from a GCE instance group.

    ``list_instances_fn(project, zone, instance_group)`` -> hostnames;
    defaults to the Compute API via googleapiclient when installed
    (injectable for tests / alternative discovery).
    """

    def __init__(self, project: str, zone: str, instance_group: str,
                 port: int = 8470, task_type: str = "worker",
                 task_id: int = 0,
                 list_instances_fn: Callable[..., Sequence[str]] | None = None):
        self._project = project
        self._zone = zone
        self._instance_group = instance_group
        self._port = port
        self.task_type = task_type
        self.task_id = task_id
        self._list_instances = list_instances_fn or self._gce_list_instances

    @staticmethod
    def _gce_list_instances(project, zone, instance_group) -> list[str]:
        try:
            from googleapiclient import discovery  # type: ignore
        except ImportError as e:
            raise ImportError(
                "GCEClusterResolver needs google-api-python-client (or an "
                "injected list_instances_fn)") from e
        service = discovery.build("compute", "v1")
        request = service.instanceGroups().listInstances(
            project=project, zone=zone, instanceGroup=instance_group,
            body={"instanceState": "RUNNING"})
        hosts = []
        while request is not None:
            response = request.execute()
            for item in response.get("items", []):
                hosts.append(item["instance"].split("/")[-1])
            request = service.instanceGroups().listInstances_next(
                request, response)
        return hosts

    def cluster_spec(self) -> ClusterSpec:
        hosts = self._list_instances(self._project, self._zone,
                                     self._instance_group)
        return ClusterSpec(
            {self.task_type or "worker":
             [f"{h}:{self._port}" for h in sorted(hosts)]})

    @property
    def environment(self) -> str:
        return "google"


# ---------------------------------------------------------------------------
# Kubernetes (≙ kubernetes_cluster_resolver.py, 214 LoC — label selectors)
# ---------------------------------------------------------------------------

class KubernetesClusterResolver(ClusterResolver):
    """Resolve tasks from pod label selectors.

    ``job_to_label_mapping``: {"worker": ["job-name=worker"]} — each
    selector's running pods (sorted by name) become that job's tasks.
    ``list_pods_fn(selector)`` -> [(pod_name, pod_ip, phase)]; defaults
    to the kubernetes client when installed.
    """

    def __init__(self,
                 job_to_label_mapping: Mapping[str, Sequence[str]] | None
                 = None,
                 tf_server_port: int = 8470,
                 override_client=None,
                 list_pods_fn: Callable[[str], Sequence[tuple]] | None
                 = None):
        self._mapping = dict(job_to_label_mapping or
                             {"worker": ["job-name=tensorflow"]})
        self._port = tf_server_port
        self._client = override_client
        self._list_pods = list_pods_fn or self._k8s_list_pods

    def _k8s_list_pods(self, selector: str) -> list[tuple]:
        if self._client is None:
            try:
                from kubernetes import client, config  # type: ignore
            except ImportError as e:
                raise ImportError(
                    "KubernetesClusterResolver needs the kubernetes "
                    "client (or an injected list_pods_fn)") from e
            config.load_kube_config()
            self._client = client.CoreV1Api()
        ret = self._client.list_pod_for_all_namespaces(
            label_selector=selector)
        return [(i.metadata.name, i.status.pod_ip, i.status.phase)
                for i in ret.items]

    def cluster_spec(self) -> ClusterSpec:
        cluster: dict[str, list[str]] = {}
        for job, selectors in self._mapping.items():
            addrs: list[str] = []
            for selector in selectors:
                pods = sorted(self._list_pods(selector))
                for name, ip, phase in pods:
                    if phase != "Running":
                        raise RuntimeError(
                            f"pod {name} matched {selector!r} but is "
                            f"{phase}, not Running")
                    addrs.append(f"{ip}:{self._port}")
            cluster[job] = addrs
        return ClusterSpec(cluster)

    @property
    def environment(self) -> str:
        return ""
