"""95th percentile, over every agent-request of the window (one agent in
one round), of the time from its round's start to its batch's first-token
logits (CUDA events)."""
import statistics


def read(run):
    vals = [b.ttft_ms for r in run.rounds for b in r.batches
            for _ in b.aids]
    if len(vals) < 20:
        return None
    return statistics.quantiles(vals, n=20, method="inclusive")[18]
