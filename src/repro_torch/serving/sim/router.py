"""Fleet control plane: request routers and the queue-depth autoscaler.

Routers pick which replica an arriving request lands on; the autoscaler
grows and shrinks the serving set on the same deterministic event heap the
engines run on.  Both are pure functions of fleet state — no wall clocks,
no salted hashes — so fleet runs stay bit-reproducible.

Router ducks implement ``route(request, replicas, now) -> ReplicaPool``
where ``replicas`` is the non-empty list of currently routable targets.
The spec-facing form is :class:`~repro_torch.api.spec.RouterSpec`;
:func:`make_router` turns either a spec or a bare name into an instance.
"""
from __future__ import annotations

_M64 = (1 << 64) - 1


def _mix(x: int) -> int:
    """splitmix64 finalizer: a deterministic 64-bit hash.  Session-affinity
    scores must not depend on Python's per-process str-hash salt, or fleet
    runs would stop being reproducible across processes."""
    x &= _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


class RoundRobinRouter:
    """Cycle through the routable replicas in arrival order.  With a fixed
    fleet this delivers replica ``i`` exactly ``Workload.shard(k, i)`` — the
    bit-identity the thinning-shim tests assert."""

    name = "round_robin"

    def __init__(self):
        self._i = 0

    def route(self, r, replicas, now: float):
        rep = replicas[self._i % len(replicas)]
        self._i += 1
        return rep


class LeastLoadedRouter:
    """Send each arrival to the replica with the fewest in-flight requests
    (queued + prefilling + running); ties break on replica index."""

    name = "least_loaded"

    def route(self, r, replicas, now: float):
        return min(replicas, key=lambda rep: (rep.load(), rep.index))


class SessionAffinityRouter:
    """Prefix-cache-aware routing: requests of one session always land on
    the same replica (rendezvous hashing over the routable set, so a scale
    event only remaps the sessions of the replicas it touched), keeping the
    session's shared prompt prefix warm in that replica's cache.
    Sessionless requests fall back to another policy."""

    name = "session_affinity"

    def __init__(self, fallback=None):
        self.fallback = fallback or LeastLoadedRouter()

    def route(self, r, replicas, now: float):
        if r.session < 0:
            return self.fallback.route(r, replicas, now)
        sess = (r.session & 0xFFFFFFFF) << 32
        return max(replicas,
                   key=lambda rep: (_mix(sess | (rep.index & 0xFFFFFFFF)),
                                    -rep.index))


_ROUTERS = {"round_robin": RoundRobinRouter, "least_loaded": LeastLoadedRouter,
            "session_affinity": SessionAffinityRouter}


def make_router(spec):
    """RouterSpec (or bare name) -> router instance."""
    kind = spec if isinstance(spec, str) else spec.kind
    if kind not in _ROUTERS:
        raise ValueError(f"unknown router {kind!r}; have {sorted(_ROUTERS)}")
    if kind == "session_affinity":
        fb = "least_loaded" if isinstance(spec, str) else spec.fallback
        if fb == "session_affinity":
            raise ValueError("session_affinity cannot be its own fallback")
        return SessionAffinityRouter(make_router(fb))
    return _ROUTERS[kind]()


class Autoscaler:
    """Queue-depth autoscaler with hysteresis, driven by ``AUTOSCALE`` ticks
    on the fleet's event heap.

    Every ``interval_s`` it samples the mean in-flight depth over the active
    serving replicas.  Above ``scale_up_queue`` it activates one standby
    replica, which starts taking traffic after ``provision_s`` (model boot +
    weight load); below ``scale_down_queue`` it deactivates the least-loaded
    active replica, which stops receiving routes but drains what it holds
    (so request conservation is unconditional).  ``cooldown_s`` between
    actions plus the up/down threshold gap is the hysteresis that keeps a
    flat trace from scale-thrashing — asserted in tests/test_fleet_sim.py.
    """

    def __init__(self, spec):
        self.spec = spec
        self.trace: list[dict] = []
        self._last_action_s = -float("inf")

    def tick(self, now: float, serve: list) -> None:
        sp = self.spec
        # failed replicas (fault injection) hold no load and must not
        # dilute the depth metric; getattr keeps bare test doubles working
        def up(rep) -> bool:
            return getattr(rep, "failed_until", 0.0) <= now

        active = [rep for rep in serve if rep.active and up(rep)]
        depth = sum(rep.load() for rep in active) / max(len(active), 1)
        action = None
        if now - self._last_action_s >= sp.cooldown_s:
            if depth > sp.scale_up_queue and len(active) < sp.max_replicas:
                # never provision a replica that is currently down
                standby = [rep for rep in serve
                           if not rep.active and up(rep)]
                if standby:
                    rep = min(standby, key=lambda x: x.index)
                    rep.active = True
                    rep.ready_at = now + sp.provision_s
                    action = f"scale_up:r{rep.index}"
            elif depth < sp.scale_down_queue and len(active) > sp.min_replicas:
                rep = min(active, key=lambda x: (x.load(), -x.index))
                rep.active = False
                action = f"scale_down:r{rep.index}"
        if action is not None:
            self._last_action_s = now
            self.trace.append({
                "t": round(now, 4), "action": action,
                "active": sum(1 for r in serve if r.active),
                "avg_depth": round(depth, 3)})

    @property
    def n_actions(self) -> int:
        return len(self.trace)
