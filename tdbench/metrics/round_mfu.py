"""Model FLOPs of the rounds outside the profile (``tdbench.flops``:
2 x the non-embedding parameters a token meets in each layer it goes
through, the causal attention products and the logits rows) over their
wall time, as a share of 989 TFLOP/s (bf16, the model's dtype)."""
from tdbench.flops import PEAK_BF16


def read(run):
    rounds = [r for r in run.rounds if not r.profiled]
    wall = sum(r.wall_s for r in rounds)
    if wall <= 0:
        return None
    return 100.0 * sum(r.flops for r in rounds) / wall / PEAK_BF16
