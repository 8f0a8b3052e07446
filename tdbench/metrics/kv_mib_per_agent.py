"""``RoundStats.persistent_bytes`` at each episode's last round, over its
agents, in MiB; the mean over the episodes completed."""


def read(run):
    last = {}
    for r in run.rounds:
        if r.r == run.traffic.rounds - 1:
            last[r.ep] = r.persistent_bytes / r.n_agents / 2**20
    return sum(last.values()) / len(last) if last else None
