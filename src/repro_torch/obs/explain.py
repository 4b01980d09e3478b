"""``explain()`` attribution: where did the predicted time go, and why.

A ranked sweep winner is only actionable with its "why" attached (the
paper's per-op breakdowns are the whole point of fine-grained simulation),
so every report can explain itself:

* :func:`explain_report` — critical-path extraction over the priced block
  timelines (when ``keep_timelines=True``), top-k ops by time and by comm
  bytes, and a compute-vs-comm-vs-exposed-overlap decomposition.  Without
  timelines it degrades gracefully to the per-kind/per-phase sums every
  report carries.
* :func:`explain_serving` — the request-level analogue for
  ``ServingReport``/``FleetReport``: the dominant SLO-violation cause
  (queueing vs prefill vs decode), utilization and step mix.

Each has a ``render_*`` plain-text form (what ``Report.explain()``
returns) and a ``compact_*`` form that rides along in
``sweep(..., manifest=)`` rows.
"""
from __future__ import annotations


def _cat(kind: str) -> str:
    from repro_torch.core.timeline import _CAT
    return _CAT.get(kind, "other")


# ---------------------------------------------------------------------------
# interval-set arithmetic (for exposed-comm on priced timelines)

def _union(segs: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, e in sorted(segs):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]

def _covered(seg: tuple[float, float], union: list[tuple[float, float]]
             ) -> float:
    """Length of ``seg`` overlapped by the (sorted, disjoint) union."""
    s, e = seg
    return sum(max(0.0, min(e, ue) - max(s, us)) for us, ue in union
               if us < e and ue > s)


def critical_path(tl, *, limit: int = 4096) -> list:
    """Extract the binding chain of a list-scheduled timeline.

    Walks back from the interval that ends last: the predecessor of an
    interval is the one whose end coincides with its start (the scheduler
    sets ``start = max(stream_free, dep_ready)``, so some interval always
    binds), preferring a same-stream predecessor on ties; if nothing ends
    exactly there, the latest-ending earlier interval binds (a dependency
    wait).  Timelines larger than ``limit`` intervals return ``[]`` rather
    than going quadratic.
    """
    ivs = tl.intervals
    if not ivs or len(ivs) > limit:
        return []
    cur = max(ivs, key=lambda iv: iv.end)
    path = [cur]
    tol = 1e-6
    while cur.start > tol:
        preds = [iv for iv in ivs if iv is not cur and iv.end <= cur.start + tol]
        if not preds:
            break
        exact = [iv for iv in preds if cur.start - iv.end <= tol]
        pool = exact or preds
        stream = cur.stream
        cur = max(pool, key=lambda iv: (iv.end, iv.stream == stream))
        path.append(cur)
    path.reverse()
    return path


# ---------------------------------------------------------------------------
def explain_report(rep, top_k: int = 8) -> dict:
    """Structured attribution for a core :class:`~repro_torch.core.simulator.Report`."""
    kind_us = dict(rep.kind_us)
    total_kind = sum(kind_us.values()) or 1.0
    by_cat = {"compute": 0.0, "comm": 0.0, "other": 0.0}
    for k, v in kind_us.items():
        by_cat[_cat(k)] += v
    top_time = sorted(kind_us.items(), key=lambda kv: -kv[1])[:top_k]

    out = {
        "mode": rep.mode,
        "step_time_us": round(rep.step_time_us, 3),
        "mfu": round(rep.mfu, 4),
        "breakdown_us": {k: round(v, 3) for k, v in rep.breakdown_us.items()},
        "dominant_phase": max(rep.breakdown_us, key=rep.breakdown_us.get)
        if rep.breakdown_us else None,
        "top_ops_by_time_us": [(k, round(v, 3)) for k, v in top_time],
        "compute_frac": round(by_cat["compute"] / total_kind, 4),
        "comm_frac": round(by_cat["comm"] / total_kind, 4),
        "other_frac": round(by_cat["other"] / total_kind, 4),
    }

    # timeline-backed sections (keep_timelines=True runs only)
    tls = getattr(rep, "block_timelines", None) or {}
    if tls:
        comm_bytes: dict[str, float] = {}
        op_time: dict[str, float] = {}
        exposed = overlapped = compute_busy = 0.0
        for tl in tls.values():
            compute_segs = [(iv.start, iv.end) for iv in tl.intervals
                            if iv.stream == "compute"]
            cover = _union(compute_segs)
            compute_busy += sum(e - s for s, e in cover)
            for iv in tl.intervals:
                op_time[iv.name] = op_time.get(iv.name, 0.0) + iv.dur
                if iv.comm_bytes:
                    comm_bytes[iv.name] = comm_bytes.get(iv.name, 0.0) \
                        + iv.comm_bytes
                if iv.stream != "compute":
                    hid = _covered((iv.start, iv.end), cover)
                    overlapped += hid
                    exposed += iv.dur - hid
        out["top_ops_by_comm_bytes"] = sorted(
            comm_bytes.items(), key=lambda kv: -kv[1])[:top_k]
        out["block_exposed_comm_us"] = round(exposed, 3)
        out["block_overlapped_comm_us"] = round(overlapped, 3)
        out["block_compute_busy_us"] = round(compute_busy, 3)
        kind, tl = max(tls.items(), key=lambda kv: kv[1].total_time)
        path = critical_path(tl)
        ctime: dict[str, float] = {}
        for iv in path:
            ctime[iv.name] = ctime.get(iv.name, 0.0) + iv.dur
        out["critical_path"] = {
            "block": kind, "n_ops": len(path),
            "total_us": round(sum(iv.dur for iv in path), 3),
            "top_contributors_us": sorted(
                ctime.items(), key=lambda kv: -kv[1])[:top_k],
        }
    return out


def compact_report(rep, top_k: int = 3) -> dict:
    """The manifest-row form: small, JSON-safe, no timelines required."""
    d = explain_report(rep, top_k=top_k)
    return {"dominant_phase": d["dominant_phase"],
            "top_ops_by_time_us": d["top_ops_by_time_us"],
            "compute_frac": d["compute_frac"],
            "comm_frac": d["comm_frac"]}


def render_report(rep, top_k: int = 8) -> str:
    d = explain_report(rep, top_k=top_k)
    lines = [f"step report · mode={d['mode']} · "
             f"step {d['step_time_us']:.1f} us · mfu {d['mfu'] * 100:.1f}%"]
    lines.append("phase breakdown:")
    total = sum(d["breakdown_us"].values()) or 1.0
    for k, v in sorted(d["breakdown_us"].items(), key=lambda kv: -kv[1]):
        lines.append(f"  {k:<18} {v:>12.1f} us  {100 * v / total:>5.1f}%")
    lines.append(f"per-block serial sums: compute {d['compute_frac']:.1%} · "
                 f"comm {d['comm_frac']:.1%} · other {d['other_frac']:.1%}")
    lines.append(f"top op kinds by time (top {top_k}):")
    for k, v in d["top_ops_by_time_us"]:
        lines.append(f"  {k:<18} {v:>12.1f} us")
    if "top_ops_by_comm_bytes" in d:
        lines.append("top ops by comm bytes:")
        for k, v in d["top_ops_by_comm_bytes"]:
            lines.append(f"  {k:<28} {v / 1e6:>10.2f} MB")
        lines.append(
            f"comm exposure (priced block timelines): "
            f"{d['block_exposed_comm_us']:.1f} us exposed · "
            f"{d['block_overlapped_comm_us']:.1f} us hidden under compute")
        cp = d["critical_path"]
        lines.append(f"critical path (block {cp['block']!r}): "
                     f"{cp['n_ops']} ops, {cp['total_us']:.1f} us")
        for k, v in cp["top_contributors_us"]:
            lines.append(f"  {k:<28} {v:>10.1f} us")
    else:
        lines.append("(run with keep_timelines=True for per-op critical "
                     "path and comm-byte attribution)")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
def explain_serving(rep, top_k: int = 8) -> dict:
    """Structured attribution for a ``ServingReport`` or ``FleetReport``.

    The SLO-violation classifier charges each violating request to the
    phase that dominated it: a TTFT miss is ``queueing`` when the queue
    delay exceeds the prefill execution time (arrival→scheduled vs
    scheduled→first token), else ``prefill``; a TPOT miss is ``decode``.
    A request can contribute to both a TTFT and a TPOT cause.
    """
    slo = rep.slo
    causes = {"queueing": 0, "prefill": 0, "decode": 0}
    n_violating = 0
    for r in rep.requests:
        if slo is None or slo.met(r):
            continue
        n_violating += 1
        if r.ttft_s > slo.ttft_s:
            qd = r.queue_delay_s
            causes["queueing" if qd >= r.ttft_s - qd else "prefill"] += 1
        if r.tpot_ms > slo.tpot_ms:
            causes["decode"] += 1
    dominant = max(causes, key=causes.get) if n_violating else None
    steps = dict(rep.steps_by_kind)
    return {
        "n_requests": rep.n_requests,
        "makespan_s": round(rep.makespan_s, 3),
        "slo_attainment": round(rep.slo_attainment, 4),
        "goodput_rps": round(rep.goodput_rps, 4),
        "n_violating": n_violating,
        "slo_violation_cause": causes,
        "dominant_violation_cause": dominant,
        "queue_delay_share_of_ttft": round(
            rep.queue_delay_s.mean / rep.ttft_s.mean, 4)
        if rep.ttft_s.mean > 0 else 0.0,
        "steps_by_kind": steps,
        "utilization": {k: dict(v) for k, v in sorted(
            rep.utilization.items(),
            key=lambda kv: -kv[1].get("busy_frac", 0.0))[:top_k]},
    }


def compact_serving(rep) -> dict:
    d = explain_serving(rep, top_k=3)
    return {"dominant_violation_cause": d["dominant_violation_cause"],
            "slo_violation_cause": d["slo_violation_cause"],
            "queue_delay_share_of_ttft": d["queue_delay_share_of_ttft"],
            "slo_attainment": d["slo_attainment"]}


def render_serving(rep, top_k: int = 8) -> str:
    d = explain_serving(rep, top_k=top_k)
    lines = [f"serving report · {d['n_requests']} requests over "
             f"{d['makespan_s']:.1f} s · SLO attainment "
             f"{d['slo_attainment']:.1%} · goodput {d['goodput_rps']:.2f} rps"]
    if d["n_violating"]:
        c = d["slo_violation_cause"]
        lines.append(
            f"SLO violations ({d['n_violating']} requests) — dominant cause: "
            f"{d['dominant_violation_cause']} "
            f"(queueing {c['queueing']} · prefill {c['prefill']} · "
            f"decode {c['decode']})")
    else:
        lines.append("no SLO violations" if rep.slo is not None
                     else "no SLO attached")
    lines.append(f"queue delay is {d['queue_delay_share_of_ttft']:.1%} of "
                 "mean TTFT")
    lines.append("steps by kind: " + (", ".join(
        f"{k}={v}" for k, v in sorted(d["steps_by_kind"].items())) or "none"))
    lines.append(f"busiest lanes (top {top_k}):")
    for name, u in d["utilization"].items():
        phases = " ".join(f"{k[:-5]}={v:.0%}" for k, v in sorted(u.items())
                          if k.endswith("_frac") and k != "busy_frac")
        lines.append(f"  {name:<20} busy {u.get('busy_frac', 0.0):>6.1%}  "
                     f"{phases}")
    return "\n".join(lines)


def compact_resilience(rep) -> dict:
    """Manifest-row attribution for a ``ResilienceReport``: which bucket ate
    the wall clock."""
    wall = rep.wall_s or 1.0
    fr = {k: round(getattr(rep, f"{k}_s") / wall, 4)
          for k in ("useful", "rework", "straggler", "checkpoint", "downtime")}
    worst = max((k for k in fr if k != "useful"), key=fr.get)
    return {"goodput": round(rep.goodput, 6), "bucket_fracs": fr,
            "dominant_loss": worst if fr[worst] > 0 else None}
