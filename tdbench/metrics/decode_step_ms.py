"""Sum of ``RoundStats.t_decode`` over the sum of decode steps (G - 1 a
batch), rounds outside the profile."""


def read(run):
    rounds = [r for r in run.rounds if not r.profiled]
    steps = sum(len(r.batches) * (r.G - 1) for r in rounds)
    return 1e3 * sum(r.t_decode for r in rounds) / steps if steps else None
