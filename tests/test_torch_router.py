"""The port's ``serving/router.py`` held exactly to the JAX package's:
the same seeded multi-tenant workload through a ``Router`` of each
package, with an in-process ``submit_fn`` and a fake clock, gives the
same routing decisions, the same journal lines and the same
``stats()``, under each policy, with stale replicas, a replica death
and ack-timeout re-routes. A journal written by either package resumes
a router of the other to the same state, which then decides as the
writer's own package would."""

import os
import shutil

import numpy as np
import pytest

from distributed_tensorflow_tpu.serving import router as jax_router
from distributed_tensorflow_tpu.serving import tenancy as jax_tenancy
from distributed_tensorflow_tpu_torch.serving import router as pt_router
from distributed_tensorflow_tpu_torch.serving import tenancy as pt_tenancy

PKGS = {"jax": (jax_router, jax_tenancy), "torch": (pt_router, pt_tenancy)}
WORKLOAD = dict(duration_s=12.0, spike=(3.0, 6.0, 4.0),
                sessions_per_tenant=4, session_prefix_blocks=3,
                block_size=8, rates={"acme": 2.5, "batchco": 1.2,
                                     "burst": 1.5})


def _tenants(tenancy):
    return (tenancy.TenantConfig("acme", pclass="interactive", weight=2.0,
                                 slo_latency_s=2.0),
            tenancy.TenantConfig("batchco", pclass="batch", weight=1.0,
                                 slo_latency_s=15.0, starvation_frac=0.15),
            tenancy.TenantConfig("burst", pclass="interactive", weight=1.0,
                                 quota_tokens_per_s=40.0, quota_burst=80.0,
                                 slo_latency_s=2.0))


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _drive(pkg: str, run_dir: str, policy: str, *, until: float = 1e9,
           start: float = 0.0):
    """Run the seeded workload through one package's router; stop at
    fake time ``until`` (a router kill). Returns the submissions, the
    router, and the fake time reached."""
    rt, tenancy = PKGS[pkg]
    clock = _Clock()
    clock.t = start
    subs = []
    router = rt.Router(
        replicas=[0, 1, 2], tenants=_tenants(tenancy),
        submit_fn=lambda r, req, meta: subs.append(
            (r, req.id, sorted(meta.items()))),
        policy=policy, block_size=8, tick_token_budget=16, seed=3,
        run_dir=run_dir, reroute_timeout_s=1.0, clock=clock)
    wl = rt.seeded_tenant_workload(7, tenants=_tenants(tenancy),
                                   **WORKLOAD)
    pending = [r for r in wl if r.arrival_s >= start]
    rng = np.random.default_rng(11)
    routed_at: dict = {}
    offers = []
    while clock.t < min(until, 30.0):
        while pending and pending[0].arrival_s <= clock.t:
            offers.append(router.offer(pending.pop(0)))
        step = int(round(clock.t / 0.05))
        stale = {2} if 60 <= step < 90 else set()
        router.observe_depths({r: int(d) for r, d in enumerate(
            rng.integers(0, 5, 3)) if r not in stale})
        for req in router.dispatch(stale=stale):
            routed_at[req.id] = clock.t
        # a request completes 0.6 fake seconds after its route, unless
        # replica 2 held it while stale
        done = [rid for rid, t0 in routed_at.items()
                if clock.t - t0 >= 0.6 and rid in router.inflight
                and not (router.inflight[rid].get("replica") == 2
                         and 60 <= step < 90)]
        router.note_completed(done)
        if step == 120:
            router.replica_died(1)
        router.tick_reroutes(stale=stale)
        clock.t = round(clock.t + 0.05, 6)
    return subs, offers, router, clock.t


def _journal(run_dir: str) -> str:
    with open(os.path.join(run_dir, pt_router.ROUTER_JOURNAL)) as f:
        return f.read()


@pytest.mark.parametrize("policy", ["affinity", "least_loaded", "random"])
def test_decisions_journal_and_stats(tmp_path, policy):
    out = {}
    for pkg in PKGS:
        d = tmp_path / pkg
        d.mkdir()
        subs, offers, router, _ = _drive(pkg, str(d), policy)
        out[pkg] = (subs, offers, router.stats(), _journal(str(d)))
        router.close()
    assert out["torch"][0] == out["jax"][0]
    assert out["torch"][1] == out["jax"][1]
    assert out["torch"][2] == out["jax"][2]
    assert out["torch"][3] == out["jax"][3]
    assert out["jax"][2]["reroutes"] > 0        # the death re-routed
    assert "rejected:quota" in out["jax"][1]


def test_workload_and_chain_keys():
    for seed in (0, 5):
        jw = jax_router.seeded_tenant_workload(
            seed, tenants=_tenants(jax_tenancy), **WORKLOAD)
        pw = pt_router.seeded_tenant_workload(
            seed, tenants=_tenants(pt_tenancy), **WORKLOAD)
        assert [(r.id, r.tokens, r.max_new_tokens, r.arrival_s, r.tenant,
                 r.pclass) for r in pw] == \
            [(r.id, r.tokens, r.max_new_tokens, r.arrival_s, r.tenant,
              r.pclass) for r in jw]
        for r in jw[:20]:
            assert pt_router.prefix_chain_keys(r.tokens, 8) == \
                jax_router.prefix_chain_keys(r.tokens, 8)


def test_parse_queue_depth(tmp_path):
    p = tmp_path / "metrics-live.prom"
    p.write_text("# dtx metrics  wall=1.0\n# TYPE dtx_serving_requests_"
                 "queued gauge\ndtx_serving_requests_queued 7\n")
    assert pt_router.parse_queue_depth(str(p)) == \
        jax_router.parse_queue_depth(str(p)) == 7
    assert pt_router.parse_queue_depth(str(tmp_path / "none")) is None


def _resume_state(router) -> tuple:
    return (sorted((k, sorted((kk, vv) for kk, vv in v.items()
                              if kk != "routed_at"))
                   for k, v in router.inflight.items()),
            sorted(router.acked), sorted(router.decided), router.resumed)


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_journal_resumes_across_packages(tmp_path, writer, reader):
    """A router of ``writer`` is killed at fake second 5 (with a torn
    tail line); routers of both packages resume from its journal to the
    same state and then take the same decisions."""
    src = tmp_path / "src"
    src.mkdir()
    _, _, router, t_kill = _drive(writer, str(src), "affinity", until=5.0)
    router.close()
    with open(src / pt_router.ROUTER_JOURNAL, "a") as f:
        f.write('{"seq": 999, "kind": "rou')          # SIGKILL mid-line
    assert pt_router.RouterJournal.replay(
        str(src / pt_router.ROUTER_JOURNAL)) == \
        jax_router.RouterJournal.replay(str(src / pt_router.ROUTER_JOURNAL))
    runs = {}
    for pkg in (writer, reader):
        d = tmp_path / f"resume_{pkg}"
        shutil.copytree(src, d)
        rt, tenancy = PKGS[pkg]
        r = rt.Router(replicas=[0, 1, 2], tenants=_tenants(tenancy),
                      submit_fn=lambda *a: None, run_dir=str(d),
                      clock=lambda: t_kill)
        state = _resume_state(r)
        r.close()
        subs, offers, r2, _ = _drive(pkg, str(d), "affinity",
                                     start=t_kill)
        runs[pkg] = (state, subs, offers, r2.stats(), _journal(str(d)))
        r2.close()
    assert runs[reader] == runs[writer]
    assert runs[reader][0][3] > 0                 # in flight at the kill
