"""Mode ``serve_open``: the port's ``ServingEngine`` under an open
loop.  The traffic's requests fall due on their schedule whether or not the
engine keeps up; each is sent at the first engine step after it fell due,
with its due time as its arrival, so time to first token counts the wait.
The window closes at the first step end after ``--seconds``; requests due
after that are not sent.  The engine then runs on, for at most
``drain_s``, until every request sent has finished: a late answer is late,
not wrong.

End-to-end: time to first token of every request due in the window (a
request with no first token counts with its wait to the end of the drain,
and as failed), and every gap between consecutive output tokens within the
window.
"""
from __future__ import annotations

import time

from chipbench import traffic as tr
from chipbench.harness import percentile
from chipbench.serving import Served, controls  # noqa: F401  (the control of its check)


def window(sv: Served, reqs: list, seconds: float) -> dict:
    """One open-loop window over ``reqs`` and its drain; the times and
    counts the metrics are taken from."""
    eng = sv.engine
    t0 = time.perf_counter()
    close = t0 + seconds
    i = steps = 0
    while True:
        now = time.perf_counter()
        sv.slice_control(now, t0)
        while i < len(reqs) and t0 + reqs[i].due_s <= min(now, close):
            sv.submit(reqs[i], t0 + reqs[i].due_s)
            i += 1
        if eng.queue or eng.active:
            sv.step()
            steps += 1
        else:
            time.sleep(5e-4)
        if time.perf_counter() >= close:
            break
    t_close = time.perf_counter()
    sv.close_slice()
    sent, queued = i, len(eng.queue)
    deadline = t_close + sv.ctx.cell["drain_s"]
    while (eng.queue or eng.active) and time.perf_counter() < deadline:
        sv.step()
    t_end = time.perf_counter()

    finished = [r for r in eng.finished if r.rid >= 0 and r.rid < len(reqs)]
    done = {r.rid for r in finished}
    started = {r.rid: r for r in list(eng.active.values()) + finished}
    ttft = []
    for spec in reqs[:sent]:
        r = started.get(spec.rid)
        ttft.append(r.ttft_s if r is not None and r.ttft_s is not None
                    else t_end - (t0 + spec.due_s))
    gaps = sv.times.gaps_until(t_close)
    return {"t0": t0, "t_close": t_close, "finished": finished, "sent": sent,
            "failed": sum(1 for spec in reqs[:sent] if spec.rid not in done),
            "ttft_p90_ms": percentile(ttft, 90) * 1e3, "itl_p95_ms": percentile(gaps, 95) * 1e3,
            "numbers": {"requests_due": sent, "engine_steps": steps, "itl_gaps": len(gaps), "queue_at_close": queued,
                        "drain_s": t_end - t_close}}


def run(ctx) -> dict:
    sv = Served(ctx)
    sv.warm_up()
    reqs = tr.open_requests(ctx.traffic, ctx.seed, ctx.seconds, ctx.cfgj["vocab_size"])
    setup_s = ctx.clock.since_start()
    w = window(sv, reqs, ctx.seconds)
    ctx.read_device()
    traced = sv.traced(w["t0"], w["t_close"])
    sv.free_program()
    out = sv.check(w["finished"])
    out.update({"metrics": {"ttft_p90_ms": w["ttft_p90_ms"], "itl_p95_ms": w["itl_p95_ms"],
                            "setup_s": setup_s},
                "attempted": w["sent"], "failed": w["failed"], "traced": traced})
    out["numbers"].update(w["numbers"])
    return out
