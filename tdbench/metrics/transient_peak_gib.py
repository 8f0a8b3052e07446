"""The largest ``RoundStats.transient_peak_bytes`` of the window, in
GiB."""


def read(run):
    vals = [r.transient_peak_bytes for r in run.rounds]
    return max(vals) / 2**30 if vals else None
