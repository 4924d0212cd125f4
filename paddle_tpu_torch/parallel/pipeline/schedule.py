"""1F1B microbatch schedule: event order, analytic bound, simulator.

The counterpart of paddle_tpu/parallel/pipeline/schedule.py (pure Python,
the same events and bubbles).

The schedule is PipeDream-flush style 1F1B: stage s warms up with
``min(m, p-1-s)`` forwards, then alternates one-forward-one-backward
until all m backwards are done, then drains. With equal-cost stages the
bubble (idle) fraction of the steady step is exactly

    bubble = (p - 1) / (m + p - 1)

which the runner reports alongside the fraction it actually measured.
"""

__all__ = ["analytic_bubble", "schedule_1f1b", "simulate_schedule"]


def analytic_bubble(n_stages, n_microbatches):
    """Ideal 1F1B bubble fraction (p-1)/(m+p-1) for equal-cost stages."""
    p, m = int(n_stages), int(n_microbatches)
    if p <= 1:
        return 0.0
    return (p - 1) / float(m + p - 1)


def schedule_1f1b(n_stages, n_microbatches):
    """Per-stage event lists: [("F"|"B", microbatch), ...] per stage.

    Stage s runs min(m, p-1-s) warm-up forwards, then strictly
    alternates F/B (one-forward-one-backward) until every microbatch's
    backward has run."""
    p, m = int(n_stages), int(n_microbatches)
    if p < 1 or m < 1:
        raise ValueError(f"need n_stages>=1, n_microbatches>=1 "
                         f"(got {p}, {m})")
    events = []
    for s in range(p):
        warm = min(m, p - 1 - s)
        ev = [("F", mb) for mb in range(warm)]
        nf, nb = warm, 0
        while nb < m:
            if nf < m:
                ev.append(("F", nf))
                nf += 1
            ev.append(("B", nb))
            nb += 1
        events.append(ev)
    return events


def simulate_schedule(events, durations=None):
    """Earliest-start simulation of per-stage event lists.

    `durations`: {("F"|"B", stage): seconds} or None for unit costs.
    Dependencies: F(s, mb) needs F(s-1, mb); B(s, mb) needs B(s+1, mb)
    and F(s, mb); each stage runs its own events serially in list order.
    Returns {makespan, busy (per stage), bubble_fraction}."""
    p = len(events)
    if durations is None:
        durations = {}
    done = {}    # (kind, stage, mb) -> finish time
    busy = [0.0] * p
    pos = [0] * p
    prev_end = [0.0] * p
    total = sum(len(ev) for ev in events)
    ran = 0
    while ran < total:
        progressed = False
        for s in range(p):
            if pos[s] >= len(events[s]):
                continue
            kind, mb = events[s][pos[s]]
            deps = []
            if kind == "F" and s > 0:
                deps.append(("F", s - 1, mb))
            if kind == "B":
                if s < p - 1:
                    deps.append(("B", s + 1, mb))
                deps.append(("F", s, mb))
            if any(d not in done for d in deps):
                continue
            start = max([prev_end[s]] + [done[d] for d in deps])
            dur = float(durations.get((kind, s), 1.0))
            done[(kind, s, mb)] = start + dur
            prev_end[s] = start + dur
            busy[s] += dur
            pos[s] += 1
            ran += 1
            progressed = True
        if not progressed:
            stuck = [(s, events[s][pos[s]]) for s in range(p)
                     if pos[s] < len(events[s])]
            raise RuntimeError(f"schedule deadlock; waiting: {stuck}")
    makespan = max(prev_end) if p else 0.0
    bubble = 0.0
    if makespan > 0 and p:
        bubble = 1.0 - sum(busy) / (p * makespan)
    return {"makespan": makespan, "busy": busy,
            "bubble_fraction": bubble}
