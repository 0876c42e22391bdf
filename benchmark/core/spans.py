"""What the readers of the program's own spans and counters share
(``uasr_torch.profiling``: ``spans()``, each record's name, parent, call,
depth, start and end on the profiler's host clock, device ms of a CUDA
event pair, counts).

The program records only while a profiler records, and its buffer keeps
the first records. The traced run profiles its bounded calls twice, with
device activity alone first (``core/trace.py``), so the first records of
the loop's call span at depth 0 are that pass's calls, the ones the
device trace in ``ctx.trace`` holds. A program without spans (one older
than them) gives None, and so does every reader.
"""

from __future__ import annotations

# the depth-0 span of one call of each loop
CALL_SPANS = {"train": "train.step", "stream": "stream.tick", "decode": "infer.request"}


def calls(ctx) -> list[list[dict]] | None:
    """The records of the first ``len(ctx.calls)`` calls, each list its
    depth-0 record first, then its descendants in the order opened."""
    try:
        from uasr_torch import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    name = CALL_SPANS.get(ctx.loop)
    if read is None or name is None or not ctx.calls:
        return None
    recs = read()
    roots = [i for i, r in enumerate(recs)
             if r["depth"] == 0 and r["name"] == name and r["end_ns"] is not None]
    roots = roots[:len(ctx.calls)]
    if not roots:
        return None
    groups = {i: [recs[i]] for i in roots}
    for r in recs:
        if r["depth"] > 0 and r["call"] in groups:
            groups[r["call"]].append(r)
    return [groups[i] for i in roots]


def host_ms(ctx) -> float | None:
    """Host ms a call inside its depth-0 span."""
    cs = calls(ctx)
    if cs is None:
        return None
    return sum(c[0]["end_ns"] - c[0]["start_ns"] for c in cs) * 1e-6 / len(cs)


def device_ms(ctx, name: str) -> float | None:
    """Device ms a call of the spans named ``name`` (their CUDA event
    pairs); None where none has a pair."""
    cs = calls(ctx)
    if cs is None:
        return None
    got = [r["device_ms"] for c in cs for r in c
           if r["name"] == name and r["device_ms"] is not None]
    return sum(got) / len(cs) if got else None


def counted(ctx, name: str) -> int | None:
    """Counter ``name`` summed over the calls' records."""
    cs = calls(ctx)
    if cs is None:
        return None
    return sum(r["counts"].get(name, 0) for c in cs for r in c)


def program_idle_ms(ctx) -> float | None:
    """Device-idle ms a call while the host was inside a call's depth-0
    span: the gaps between the device's busy intervals, from the first
    call's start to the last device end, intersected with the calls' host
    intervals (both on the profiler's epoch clock). The rest of the idle
    time belongs to the caller."""
    cs = calls(ctx)
    busy = ctx.trace.merged()
    if cs is None or not busy:
        return None
    host = sorted((c[0]["start_ns"], c[0]["end_ns"]) for c in cs)
    lo, hi = host[0][0], busy[-1][1]
    if hi <= lo:
        return None  # the records are of calls after the device trace's
    idle, t = [], lo
    for s, e in busy:
        if s > t:
            idle.append((t, min(s, hi)))
        t = max(t, e)
    total, j = 0, 0
    for a, b in idle:
        while j < len(host) and host[j][1] <= a:
            j += 1
        k = j
        while k < len(host) and host[k][0] < b:
            total += max(0, min(b, host[k][1]) - max(a, host[k][0]))
            k += 1
    return total * 1e-6 / len(cs)


def upload_gbps(ctx) -> float | None:
    """Bytes the calls copied off the host (counter ``h2d_bytes``) over
    the device time of the host-to-device copies, in GB/s."""
    n, s = counted(ctx, "h2d_bytes"), ctx.trace.copies_s("HtoD")
    if not n or s <= 0:
        return None
    return n / s * 1e-9
