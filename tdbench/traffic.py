"""The traffic generator: All-Gather episodes made from a traffic file and
a seed.

A frozen copy of ``repro_torch.core.rounds.generate_trace`` with one
change: history lengths do not depend on the seed. The traffic file fixes
how many agents start with each history length, in ascending order of
length; the seed picks the token ids. The serving engine runs one batch
per prompt length, in the order the lengths first appear, so a seed that
moved lengths would move the number and the order of the batches, and the
cell's throughput and latency tail with them.

An episode is one simulation of ``rounds`` rounds. Round 0's prompt is an
agent's history and its task; from round 1 the engine puts every agent's
previous output between them. Outputs are the served model's own greedy
tokens, so a trace carries the shared blocks of round 0 only (none).
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

import numpy as np

ROOT = Path(__file__).resolve().parent


@dataclass(frozen=True)
class Traffic:
    name: str
    histories: Dict[int, int]    # history length -> number of agents
    task_len: int
    gen_len: int
    rounds: int

    @property
    def n_agents(self) -> int:
        return sum(self.histories.values())

    @classmethod
    def load(cls, name: str) -> "Traffic":
        spec = json.loads((ROOT / "traffic" / f"{name}.json").read_text())
        return cls(name, {int(k): int(v) for k, v in spec["histories"].items()},
                   int(spec["task_len"]), int(spec["gen_len"]),
                   int(spec["rounds"]))


@dataclass
class Episode:
    """The inputs of one episode, as both the program and the reference
    get them: agent order, initial histories, and each round's tasks."""

    agent_ids: List[str]
    histories: Dict[str, np.ndarray]          # int32 initial histories
    tasks: List[Dict[str, np.ndarray]]        # per round, per agent
    gen_len: int
    sep_id: int


def episode_seed(seed: int, episode: int) -> np.random.Generator:
    """The generator of episode ``episode`` of a run (``-1``: its warm-up
    episode). Any whole seed, negative or past 64 bits, is taken modulo
    2**64."""
    return np.random.default_rng([seed % (1 << 64), episode + 1])


def make_episode(traffic: Traffic, vocab_size: int, seed: int,
                 episode: int) -> Episode:
    rng = episode_seed(seed, episode)
    sep = vocab_size - 1

    def toks(n):
        return rng.integers(0, vocab_size - 1, size=n).astype(np.int32)

    lengths = [h for h, n in sorted(traffic.histories.items())
               for _ in range(n)]
    agent_ids = [f"agent{i}" for i in range(len(lengths))]
    histories = {a: toks(n) for a, n in zip(agent_ids, lengths)}
    tasks = [{a: toks(traffic.task_len) for a in agent_ids}
             for _ in range(traffic.rounds)]
    return Episode(agent_ids, histories, tasks, traffic.gen_len, sep)
