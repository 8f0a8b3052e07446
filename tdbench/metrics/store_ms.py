"""Mean ``RoundStats.t_store`` a batch, every round outside the
profile."""


def read(run):
    rounds = [r for r in run.rounds if not r.profiled]
    n = sum(len(r.batches) for r in rounds)
    return 1e3 * sum(r.t_store for r in rounds) / n if n else None
