"""Host ms a traced call inside the program's outermost spans (its
``dsp.*`` host ranges that no other one holds), from the profiler's
trace: the host's work to enqueue a call, the launches' own time
included; on several cards the rank where it is largest.  None where
the trace holds no such span (a program without them)."""

PREFIX = "dsp."


def outermost(host) -> list:
    """(start_us, end_us) of the ``dsp.*`` ranges of ``host``, (name,
    start_us, end_us) each, that no other such range holds, in order."""
    spans = sorted(((s, e) for n, s, e in host if n.startswith(PREFIX)),
                   key=lambda r: (r[0], -r[1]))
    out, end = [], float("-inf")
    for s, e in spans:
        if e > end:
            out.append((s, e))
            end = e
    return out


def read(run):
    found = []
    for t in run.all_traces():
        spans = outermost(t.host)
        if spans:
            found.append(sum(e - s for s, e in spans) / 1e3 / t.calls)
    return max(found) if found else None
