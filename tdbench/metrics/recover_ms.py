"""Mean ``RoundStats.t_recover`` a batch, rounds >= 1 outside the
profile."""


def read(run):
    rounds = [r for r in run.rounds if not r.profiled and r.r >= 1]
    n = sum(len(r.batches) for r in rounds)
    return 1e3 * sum(r.t_recover for r in rounds) / n if n else None
