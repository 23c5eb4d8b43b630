"""Per-read overlap-end statistics (fc_ovlp_stats).

Exact reimplementation of the reference's overlap statistics scanner
(reference: falcon_kit/mains/ovlp_stats.py:16-64 filter_stats): for each
read, count overlaps touching its 5' and 3' ends (idt >= 90, both reads
>= min_len), and emit "id length left_count right_count" rows for reads
with any counted overlap.
"""


def filter_stats(readlines, min_len):
    current = None
    counts = {"5p": 0, "3p": 0}
    q_id = None
    q_l = 0
    rows = []
    for line in readlines():
        l = line.strip().split()
        q_id, t_id = l[:2]
        if q_id != current:
            if current is not None and \
                    (counts["5p"] > 0 or counts["3p"] > 0):
                rows.append((current, q_l, counts["5p"], counts["3p"]))
            counts = {"5p": 0, "3p": 0}
            current = q_id
        idt = float(l[3])
        q_s, q_e, q_l = int(l[5]), int(l[6]), int(l[7])
        t_l = int(l[11])
        if q_l < min_len or t_l < min_len:
            continue
        if idt < 90:
            continue
        if q_s == 0:
            counts["5p"] += 1
        if q_e == q_l:
            counts["3p"] += 1
    if q_id is not None and (counts["5p"] > 0 or counts["3p"] > 0):
        rows.append((q_id, q_l, counts["5p"], counts["3p"]))
    return rows


def run_ovlp_stats(out_f, block_streams, min_len):
    """Write the stats table for per-block overlap streams
    (reference: run_ovlp_stats, ovlp_stats.py:78-85)."""
    for rl in block_streams:
        for row in filter_stats(rl, min_len):
            out_f.write(" ".join(str(c) for c in row) + "\n")
