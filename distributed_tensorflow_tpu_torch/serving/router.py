"""Multi-tenant serving frontend: cache-affinity routing over replicas.

The port's copy of ``distributed_tensorflow_tpu/serving/router.py``: the same
decisions, keys, record fields and seeded streams, held exactly
to the JAX package's by the CPU tests (``tests/test_torch_*``).

The horizontal layer over the supervised replica fleet (serving/
replica.py): a *router* admits live per-tenant request streams and
decides WHICH replica serves each one.

**Cache-affinity routing.** The prefix cache's index key is the chain
``(parent_key, block_tokens)`` — a pure function of prompt content and
``block_size`` (serving/kv_cache.py), so the router can compute every
request's chain keys WITHOUT any device state and remember which
replica last prefilled each chain (:func:`prefix_chain_keys`,
:class:`AffinityMap`). Requests sharing a prompt prefix land on the
replica already holding those KV blocks; the fallback is least-loaded
by live queue depth scraped from each replica's exported metrics
(telemetry/exporter.py ``metrics-live.prom`` — atomic-rename, never
torn), then seeded-random. ``policy="random"`` keeps the degenerate
router as a same-workload baseline: the measured hit-rate uplift of
affinity over random is a chaos-sweep gate, not a claim.

**Priority + quotas.** Admission rides serving/tenancy.py: per-tenant
token-bucket quotas (refusal = ``serve.reject`` stamped
``tenant``/``cause="quota"``), weighted-fair admission under a token
budget with batch shed (deferred) first, and batch promoted into the
interactive round once queued past its starvation deadline — batch
never starves past its own SLO.

**Crash tolerance.** Every decision appends to a line-buffered journal
(``router-journal.jsonl``) BEFORE the request is handed to a replica:
``route`` / ``reroute`` / ``reject`` / ``ack`` records. A killed
replica's routed-but-unacked requests are re-routed to a survivor
(detected by its stale metrics scrape + ack age), extending the serving replicas'
completion-log contract across replicas: zero dropped, duplicates
byte-identical under greedy decode. A killed ROUTER restarts from the
journal: decided requests are never re-offered (quota decisions are
durable), routed-but-unacked ones stay with their replica (no
double-serving) — only death re-routes them.

Transport is pluggable: the elastic example uses per-replica
line-buffered inbox files a :func:`~distributed_tensorflow_tpu_torch.serving.
replica.routed_replica` tails; ``bench.py --serving --router`` wires
``submit_fn`` straight into in-process engines.
"""

from __future__ import annotations

import json
import os
import random
import time

from distributed_tensorflow_tpu_torch import telemetry
from distributed_tensorflow_tpu_torch.serving.scheduler import Request
from distributed_tensorflow_tpu_torch.serving.tenancy import (
    TenancyController, TenantConfig)

ROUTER_JOURNAL = "router-journal.jsonl"


def prefix_chain_keys(tokens, block_size: int) -> list:
    """The PrefixCache chain keys of a prompt — the SAME
    ``(parent_key, block_tokens)`` chain serving/kv_cache.py indexes,
    computed from content alone. Only full blocks over ``tokens[:-1]``
    chain (prefill must always compute the final prompt position), so
    a router-side hit prediction never claims more than the replica's
    cache could actually serve."""
    toks = tuple(int(t) for t in tokens)
    limit = len(toks) - 1
    keys: list = []
    key = None
    n = 0
    while n + block_size <= limit:
        key = (key, toks[n:n + block_size])
        keys.append(key)
        n += block_size
    return keys


class AffinityMap:
    """chain key -> replica that last prefilled it (router-side view of
    where KV blocks live). Bounded LRU so a long run cannot grow it
    unboundedly — eviction order matches the replicas' own LRU bias."""

    def __init__(self, block_size: int, *, capacity: int = 4096):
        self.block_size = block_size
        self.capacity = capacity
        self._map: "dict[object, object]" = {}

    def observe(self, tokens, replica):
        """Record that ``replica`` (just) prefilled this prompt — its
        cache now holds every full block of the chain."""
        for k in prefix_chain_keys(tokens, self.block_size):
            self._map.pop(k, None)          # move-to-end (dict order)
            self._map[k] = replica
        while len(self._map) > self.capacity:
            self._map.pop(next(iter(self._map)))

    def forget(self, replica):
        """Drop a dead replica's entries (its cache died with it)."""
        self._map = {k: r for k, r in self._map.items() if r != replica}

    def lookup(self, tokens, live) -> "tuple[object, int] | None":
        """``(replica, depth)`` of the deepest chain hit on a live
        replica, or None. Depth = number of chained blocks matched —
        deeper means more KV served from cache."""
        best = None
        for depth, k in enumerate(
                prefix_chain_keys(tokens, self.block_size), start=1):
            r = self._map.get(k)
            if r is None:
                break
            if r in live:
                best = (r, depth)
        return best


class RoutingPolicy:
    """Pure routing decision: affinity > least-loaded > seeded random.

    ``policy`` narrows the cascade for baseline comparisons:
    ``"least_loaded"`` skips the affinity map, ``"random"`` ignores
    depth too. Queue depths come from :meth:`observe_depth` (the
    router's metrics scrape or its own outstanding counts).
    """

    def __init__(self, replicas, *, block_size: int = 8,
                 policy: str = "affinity", seed: int = 0,
                 affinity_capacity: int = 4096):
        if policy not in ("affinity", "least_loaded", "random"):
            raise ValueError(f"policy={policy!r}")
        self.policy = policy
        self.replicas = list(replicas)
        self.affinity = AffinityMap(block_size,
                                    capacity=affinity_capacity)
        self._rng = random.Random(f"dtx-router:{seed}")
        self._depth = {r: 0 for r in self.replicas}

    def set_replicas(self, replicas):
        self.replicas = list(replicas)
        for r in self.replicas:
            self._depth.setdefault(r, 0)

    def observe_depth(self, replica, depth: int):
        self._depth[replica] = int(depth)

    def observe_route(self, tokens, replica):
        if self.policy == "affinity":
            self.affinity.observe(tokens, replica)
        self._depth[replica] = self._depth.get(replica, 0) + 1

    def forget(self, replica):
        self.affinity.forget(replica)
        self._depth.pop(replica, None)

    def route(self, tokens, *, exclude=()) -> "tuple[object, str]":
        """``(replica, reason)`` with reason in
        ``{"affinity", "least_loaded", "random"}``."""
        live = [r for r in self.replicas if r not in exclude]
        if not live:
            raise RuntimeError("no live replicas to route to")
        if self.policy == "affinity":
            hit = self.affinity.lookup(tokens, set(live))
            if hit is not None:
                return hit[0], "affinity"
        if self.policy in ("affinity", "least_loaded"):
            depth = min(self._depth.get(r, 0) for r in live)
            tied = [r for r in live
                    if self._depth.get(r, 0) == depth]
            if len(tied) == 1:
                return tied[0], "least_loaded"
            return self._rng.choice(tied), "least_loaded"
        return self._rng.choice(live), "random"


class RouterJournal:
    """Line-buffered decision journal (the router's completion-log
    analogue): one JSON record per decision, appended BEFORE the
    decision takes effect, torn-tail tolerant on replay."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "a", buffering=1)
        self.seq = 0

    def record(self, kind: str, **fields):
        self.seq += 1
        self._f.write(json.dumps({"seq": self.seq, "kind": kind,
                                  **fields}) + "\n")

    def close(self):
        self._f.close()

    @staticmethod
    def replay(path: str) -> "list[dict]":
        """All intact records, in order; a torn trailing line (SIGKILL
        mid-write) is skipped — the decision it described never fully
        happened and will be re-taken."""
        out: list = []
        try:
            with open(path) as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    if isinstance(rec, dict) and "kind" in rec:
                        out.append(rec)
        except OSError:
            pass
        return out


def parse_queue_depth(prom_path: str) -> "int | None":
    """``serving/requests_queued`` from one replica's exported
    ``metrics-live.prom`` (the exporter's; atomic rename — a read never
    sees a torn file). None when absent/unreadable."""
    try:
        with open(prom_path) as f:
            for line in f:
                if line.startswith("dtx_serving_requests_queued"):
                    try:
                        return int(float(line.rsplit(None, 1)[-1]))
                    except ValueError:
                        return None
    except OSError:
        return None
    return None


class Router:
    """Tenant-aware request router over a replica set.

    ``submit_fn(replica, request, meta)`` delivers a routed request
    (in-process: ``engine.submit``; elastic: an inbox-file append).
    With ``run_dir`` set, decisions journal to
    ``run_dir/router-journal.jsonl`` and a fresh Router resumes from
    it. ``clock`` is injectable for deterministic tests.
    """

    def __init__(self, *, replicas, tenants, submit_fn,
                 policy: str = "affinity", block_size: int = 8,
                 tick_token_budget: int = 96, seed: int = 0,
                 run_dir: "str | None" = None,
                 reroute_timeout_s: float = 8.0,
                 max_inflight_per_replica: int = 6,
                 clock=time.monotonic):
        self.policy = RoutingPolicy(replicas, block_size=block_size,
                                    policy=policy, seed=seed)
        tenants = tuple(tenants)
        if not all(isinstance(t, TenantConfig) for t in tenants):
            raise TypeError("tenants must be TenantConfig instances")
        self._clock = clock
        now = clock()
        self.tenancy = TenancyController(tenants, now=now)
        self.submit_fn = submit_fn
        self.tick_token_budget = tick_token_budget
        self.reroute_timeout_s = reroute_timeout_s
        #: flow control: routed-but-unacked cap per replica. Backlog
        #: beyond it waits at the ROUTER (where priority classes order
        #: the release), not in a replica's FIFO admission queue where
        #: an interactive request would sit behind every batch request
        #: dispatched before it.
        self.max_inflight_per_replica = max_inflight_per_replica
        self.run_dir = run_dir
        self.journal: "RouterJournal | None" = None
        #: rid -> route state {replica, tenant, pclass, request,
        #: routed_at, reroutes}
        self.inflight: "dict[str, dict]" = {}
        self.acked: set = set()
        #: rids decided in a PREVIOUS incarnation (never re-offered)
        self.decided: set = set()
        self.resumed = 0
        #: per-class queued-but-not-yet-routed requests
        self._queues: "dict[str, list]" = {}     # tenant -> [(enq, req)]
        #: deficit-round-robin credit: a backlogged tenant's unused
        #: grant carries over until it covers its head-of-line request
        #: (a tick budget smaller than one request cost still makes
        #: progress); resets when the tenant's queue empties
        self._credit: "dict[str, float]" = {}
        self.routes = 0
        self.reroutes = 0
        self.route_reasons: "dict[str, int]" = {}
        reg = telemetry.get_registry()
        self._m_inflight = reg.gauge(
            "router/inflight", "routed-but-unacked requests")
        self._m_queued = reg.gauge(
            "router/queued", "admitted requests awaiting dispatch")
        self._m_reroutes = reg.counter(
            "router/reroutes_total",
            "requests re-routed off a dead/unresponsive replica")
        if run_dir:
            path = os.path.join(run_dir, ROUTER_JOURNAL)
            self._resume(path, now)
            self.journal = RouterJournal(path)

    # -- journal resume ----------------------------------------------------
    def _resume(self, path: str, now: float):
        """Rebuild decision state from a previous incarnation's
        journal. Routed-but-unacked requests stay with their replica —
        resuming must NEVER double-serve; only a replica's death (or
        ack timeout) re-routes them later."""
        if not os.path.exists(path):
            return
        for rec in RouterJournal.replay(path):
            rid = rec.get("id")
            kind = rec.get("kind")
            if kind in ("route", "reroute") and rid is not None:
                self.decided.add(rid)
                st = self.inflight.setdefault(rid, {
                    "tenant": rec.get("tenant"),
                    "pclass": rec.get("pclass"),
                    "request": None, "reroutes": 0})
                st["replica"] = rec.get("replica")
                st["routed_at"] = now
                if kind == "reroute":
                    st["reroutes"] = st.get("reroutes", 0) + 1
            elif kind == "reject" and rid is not None:
                self.decided.add(rid)
            elif kind == "ack" and rid is not None:
                self.acked.add(rid)
                self.inflight.pop(rid, None)
        self.resumed = len(self.inflight)
        if self.resumed or self.acked:
            telemetry.event("router.resume",
                            inflight=self.resumed,
                            acked=len(self.acked),
                            decided=len(self.decided))

    # -- admission ---------------------------------------------------------
    def offer(self, request: Request, *, now: "float | None" = None
              ) -> str:
        """Admit one arriving request: quota-check, then queue for the
        next dispatch tick. Returns ``"admitted"``, ``"duplicate"``
        (decided by a previous incarnation) or ``"rejected:quota"``."""
        now = self._clock() if now is None else now
        if request.id in self.decided:
            return "duplicate"
        tenant = request.tenant or "-"
        if tenant not in self.tenancy.tenants:
            raise KeyError(f"unknown tenant {tenant!r} "
                           f"(request {request.id})")
        cost = TenancyController.cost_of(request)
        if not self.tenancy.charge(tenant, cost, now):
            if self.journal:
                self.journal.record("reject", id=request.id,
                                    tenant=tenant, cause="quota")
            self.decided.add(request.id)
            telemetry.event("serve.reject", id=request.id,
                            tenant=tenant, pclass=request.pclass,
                            cause="quota", queued=self.queued)
            return "rejected:quota"
        self._queues.setdefault(tenant, []).append((now, request))
        self._m_queued.set(self.queued)
        return "admitted"

    @property
    def queued(self) -> int:
        return sum(len(q) for q in self._queues.values())

    # -- dispatch ----------------------------------------------------------
    def dispatch(self, *, now: "float | None" = None,
                 budget: "int | None" = None,
                 stale: "set | frozenset" = frozenset()
                 ) -> "list[Request]":
        """One admission tick: weighted-fair token allocation across
        tenants (batch subordinate unless aged past its starvation
        deadline), then route + journal + submit each granted request
        in FIFO order.

        Overload-safe: a ``stale`` replica (caller's scrape-staleness
        verdict) or one already at ``max_inflight_per_replica``
        routed-but-unacked requests takes no new work. With every
        replica closed the whole queue holds HERE — no credit accrues,
        nothing is shed, and when capacity returns the backlog releases
        in priority order (interactive, aged batch, batch) instead of
        landing FIFO in a dead replica's inbox. Returns the dispatched
        requests."""
        now = self._clock() if now is None else now
        budget = self.tick_token_budget if budget is None else budget
        demands = {t: sum(TenancyController.cost_of(r)
                          for _, r in q)
                   for t, q in self._queues.items() if q}
        if not demands:
            return []
        counts: "dict[object, int]" = {}
        for st in self.inflight.values():
            r = st.get("replica")
            counts[r] = counts.get(r, 0) + 1

        def _closed():
            return {r for r in self.policy.replicas
                    if r in stale
                    or counts.get(r, 0) >= self.max_inflight_per_replica}

        if len(_closed()) == len(self.policy.replicas):
            self._m_queued.set(self.queued)
            return []              # fleet down/saturated: hold the queue
        aged = {t for t, q in self._queues.items()
                if q and self.tenancy.tenant(t).pclass == "batch"
                and now - q[0][0]
                >= self.tenancy.tenant(t).starvation_deadline_s}
        alloc = self.tenancy.plan_tick(demands, budget=budget,
                                       aged=aged)
        dispatched: "list[Request]" = []
        blocked = False

        def _rank(t):
            cfg = self.tenancy.tenant(t)
            tier = 0 if cfg.pclass != "batch" else (1 if t in aged
                                                    else 2)
            return (tier, t)

        for tenant in sorted(self._queues, key=_rank):
            q = self._queues[tenant]
            grant = self._credit.get(tenant, 0.0) \
                + alloc.get(tenant, 0.0)
            while q and not blocked:
                cost = TenancyController.cost_of(q[0][1])
                if cost > grant + 1e-9:
                    break
                closed = _closed()
                if len(closed) == len(self.policy.replicas):
                    blocked = True   # filled the fleet mid-tick
                    break
                enq, req = q.pop(0)
                grant -= cost
                replica = self._route(req, tenant, now,
                                      exclude=closed)
                counts[replica] = counts.get(replica, 0) + 1
                dispatched.append(req)
            # DRR: keep the remainder only while backlogged — an idle
            # tenant must not hoard credit across quiet periods
            self._credit[tenant] = grant if q else 0.0
            if q and not blocked \
                    and self.tenancy.tenant(tenant).pclass == "batch" \
                    and tenant not in aged:
                # deferred under pressure: observable shed, once per
                # tick per tenant (the count, not the event rate, is
                # what reports render)
                self.tenancy.note_shed(tenant)
                telemetry.event("router.shed", tenant=tenant,
                                queued=len(q),
                                oldest_wait_s=round(now - q[0][0], 4))
        self._m_queued.set(self.queued)
        return dispatched

    def _route(self, req: Request, tenant: str, now: float,
               *, exclude=(), cause: "str | None" = None):
        replica, reason = self.policy.route(req.tokens,
                                            exclude=exclude)
        kind = "reroute" if cause else "route"
        if self.journal:
            self.journal.record(kind, id=req.id, tenant=tenant,
                                pclass=req.pclass, replica=replica,
                                reason=reason, cause=cause)
        st = self.inflight.setdefault(req.id, {
            "tenant": tenant, "pclass": req.pclass, "reroutes": 0})
        st.update(replica=replica, request=req, routed_at=now)
        self.decided.add(req.id)
        self.policy.observe_route(req.tokens, replica)
        span = f"req/{req.id}"
        if cause:
            st["reroutes"] += 1
            self.reroutes += 1
            self._m_reroutes.increment()
            telemetry.event("router.reroute", id=req.id, span_id=span,
                            tenant=tenant, pclass=req.pclass,
                            replica=replica, cause=cause)
        else:
            self.routes += 1
            self.route_reasons[reason] = \
                self.route_reasons.get(reason, 0) + 1
            telemetry.event("router.route", id=req.id, span_id=span,
                            tenant=tenant, pclass=req.pclass,
                            replica=replica, reason=reason)
        self._m_inflight.set(len(self.inflight))
        self.submit_fn(replica, req,
                       {"tenant": tenant, "pclass": req.pclass,
                        "reroute": bool(cause)})
        return replica

    # -- acks + failure handling ------------------------------------------
    def note_completed(self, rids) -> int:
        """Mark completions (from the replicas' completion-log union);
        journals an ``ack`` per newly-acked rid so a restarted router
        knows they are done."""
        n = 0
        for rid in rids:
            if rid in self.acked:
                continue
            self.acked.add(rid)
            if self.inflight.pop(rid, None) is not None:
                n += 1
            if self.journal:
                self.journal.record("ack", id=rid)
        if n:
            self._m_inflight.set(len(self.inflight))
        return n

    def observe_depths(self, depths: "dict"):
        for r, d in depths.items():
            if d is not None:
                self.policy.observe_depth(r, d)

    #: a request is re-routed at most this many times — beyond that its
    #: OWN replica's respawn (inbox re-read) is the recovery path
    MAX_REROUTES = 2

    def replica_died(self, replica, *, now: "float | None" = None,
                     cause: str = "replica_dead",
                     exclude=()) -> int:
        """Re-route every routed-but-unacked request owned by a dead
        replica to a survivor (never to anything in ``exclude`` — e.g.
        other stale replicas). The dead replica's affinity entries are
        forgotten (its cache died with it). Returns re-route count."""
        now = self._clock() if now is None else now
        self.policy.forget(replica)
        avoid = set(exclude) | {replica}
        if not any(r not in avoid for r in self.policy.replicas):
            return 0                     # no survivor to route to
        victims = [rid for rid, st in self.inflight.items()
                   if st.get("replica") == replica
                   and st.get("request") is not None
                   and st.get("reroutes", 0) < self.MAX_REROUTES]
        for rid in sorted(victims):
            st = self.inflight[rid]
            self._route(st["request"], st["tenant"], now,
                        exclude=avoid, cause=cause)
        return len(victims)

    def tick_reroutes(self, *, now: "float | None" = None,
                      stale: "set | frozenset" = frozenset()) -> int:
        """Ack-timeout sweep: requests unacked past
        ``reroute_timeout_s`` whose replica looks dead (``stale`` — the
        caller's scrape-staleness verdict) are re-routed to a LIVE
        survivor. With every replica stale (a gang restart in flight)
        nothing moves — the respawned fleet re-reads its inboxes
        instead; ping-ponging work between dead replicas helps no one.
        Duplicates are safe: greedy decode is deterministic, so a
        false positive costs duplicate (byte-identical) work, never
        correctness."""
        now = self._clock() if now is None else now
        stale = set(stale)
        if not any(r not in stale for r in self.policy.replicas):
            return 0
        n = 0
        for replica in sorted(stale, key=str):
            if any(st.get("replica") == replica
                   and now - st.get("routed_at", now)
                   > self.reroute_timeout_s
                   for st in self.inflight.values()):
                n += self.replica_died(replica, now=now,
                                       cause="ack_timeout",
                                       exclude=stale)
        return n

    # -- reporting ---------------------------------------------------------
    def emit_tenant_summary(self, *, now: "float | None" = None):
        """One ``router.tenant`` event per tenant — the admit/reject/
        shed + quota-utilization counters obs_report renders."""
        now = self._clock() if now is None else now
        for name, s in self.tenancy.summary(now).items():
            telemetry.event("router.tenant", tenant=name,
                            pclass=s["pclass"],
                            admitted=s["admitted"],
                            rejected_quota=s["rejected"].get("quota",
                                                             0),
                            rejected_total=sum(s["rejected"]
                                               .values()),
                            sheds=s["sheds"],
                            tokens_admitted=s["tokens_admitted"],
                            quota_utilization=s["quota_utilization"])

    def stats(self) -> dict:
        return {
            "routes": self.routes,
            "reroutes": self.reroutes,
            "route_reasons": dict(self.route_reasons),
            "inflight": len(self.inflight),
            "acked": len(self.acked),
            "queued": self.queued,
            "resumed": self.resumed,
            "tenants": self.tenancy.summary(self._clock()),
        }

    def close(self):
        if self.journal:
            self.journal.close()


# -- seeded multi-tenant workloads ------------------------------------------

def seeded_tenant_workload(seed: int, *, duration_s: float = 20.0,
                           tenants=None,
                           rates: "dict[str, float] | None" = None,
                           spike: "tuple | None" = None,
                           sessions_per_tenant: int = 4,
                           session_prefix_blocks: int = 3,
                           block_size: int = 8,
                           suffix_range: tuple = (2, 5),
                           new_tokens_range: tuple = (2, 6),
                           vocab_size: int = 256) -> "list[Request]":
    """Deterministic two-class request stream (the resilience/faults.py
    string-seeding discipline): per tenant, Poisson arrivals whose
    prompts are a per-SESSION shared prefix (``session_prefix_blocks``
    full cache blocks — the affinity material: requests of one session
    hit each other's KV) plus a short unique suffix. ``spike=(start,
    end, factor)`` multiplies every INTERACTIVE tenant's rate inside
    the window — the overload that makes batch shed first observable.
    Arrival times land in ``Request.arrival_s``; ids are
    ``<tenant>-<i:04d>``. A pure function of the seed."""
    from distributed_tensorflow_tpu_torch.serving.tenancy import \
        default_tenants
    tenants = tuple(tenants) if tenants is not None else \
        default_tenants()
    rng = random.Random(f"dtx-router-load:{seed}")
    prefix_len = session_prefix_blocks * block_size
    out: "list[Request]" = []
    for cfg in tenants:
        rate = (rates or {}).get(cfg.name,
                                 2.0 if cfg.pclass == "interactive"
                                 else 1.0)
        prefixes = [tuple(rng.randrange(vocab_size)
                          for _ in range(prefix_len))
                    for _ in range(sessions_per_tenant)]
        t, i = 0.0, 0
        while True:
            r = rate
            if spike and cfg.pclass == "interactive" \
                    and spike[0] <= t < spike[1]:
                r = rate * spike[2]
            t += rng.expovariate(r)
            if t >= duration_s:
                break
            sess = rng.randrange(sessions_per_tenant)
            toks = prefixes[sess] + tuple(
                rng.randrange(vocab_size)
                for _ in range(rng.randrange(*suffix_range)))
            out.append(Request(
                id=f"{cfg.name}-{i:04d}", tokens=toks,
                max_new_tokens=rng.randrange(*new_tokens_range),
                arrival_s=round(t, 6), tenant=cfg.name,
                pclass=cfg.pclass))
            i += 1
    out.sort(key=lambda r: (r.arrival_s, r.id))
    return out
