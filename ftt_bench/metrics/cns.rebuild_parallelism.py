"""Host-MSA rebuild workers busy at once: the busy time the cns.rebuild
spans count (busy_us, each slice's native walk and result building timed
inside its worker) over the spans' own time, both in the window (a span
the window cuts counts the cut share of its busy time).  None where the
program records no cns.rebuild with busy_us (the DP path's spans carry
none, nor does a tree that rebuilds a batch at a time)."""
from ftt_bench import progspans


def read(run):
    busy = secs = 0.0
    for s in progspans.program_records():
        if s.name != "cns.rebuild" or "busy_us" not in s.counts or \
                s.t1 <= s.t0:
            continue
        a, b = s.t0 / 1e9, s.t1 / 1e9
        inside = min(b, run.w1) - max(a, run.w0)
        if inside > 0:
            secs += inside
            busy += s.counts["busy_us"] / 1e6 * inside / (b - a)
    return busy / secs if secs > 0 else None
