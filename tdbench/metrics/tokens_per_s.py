"""Output tokens of every agent in every round of the window, over the
window's wall time (first round's start to last round's end)."""


def read(run):
    tokens = sum(r.n_agents * r.G for r in run.rounds)
    return tokens / run.window_s if run.window_s > 0 else None
