"""Model configurations and weights of the benchmark.

A configuration file (``configs/<name>.json``) holds the published
``config.json`` keys of the model as it is run. Weights are made here from
the run's seed, on the device, one ``torch.randn`` call per stacked leaf,
in the served dtype. The program and the reference get the same tensors:
the program as its nested parameter dict (views), the reference as the
flat dict.
"""
from __future__ import annotations

import json
import math
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def load_config(name: str) -> dict:
    return json.loads((ROOT / "configs" / f"{name}.json").read_text())


def sizes(c: dict) -> dict:
    """The sizes the benchmark needs, from the published keys."""
    H = c["num_attention_heads"]
    return dict(L=c["num_hidden_layers"], D=c["hidden_size"], H=H,
                KV=c["num_key_value_heads"], hd=c["hidden_size"] // H,
                F=c["intermediate_size"], V=c["vocab_size"],
                theta=float(c["rope_theta"]), eps=float(c["rms_norm_eps"]),
                dtype=c["torch_dtype"])


def leaves(s: dict):
    """(name, shape, scale) of every weight; scale 0 means zeros."""
    L, D, H, KV, hd, F, V = (s[k] for k in ("L", "D", "H", "KV", "hd", "F",
                                            "V"))
    out = 0.02 / math.sqrt(2 * L)
    return [("embed", (V, D), 0.02), ("lm_head", (D, V), 0.02),
            ("final_norm", (D,), 0.0), ("ln1", (L, D), 0.0),
            ("ln2", (L, D), 0.0),
            ("wq", (L, D, H * hd), 0.02), ("bq", (L, H * hd), 0.02),
            ("wk", (L, D, KV * hd), 0.02), ("bk", (L, KV * hd), 0.02),
            ("wv", (L, D, KV * hd), 0.02), ("bv", (L, KV * hd), 0.02),
            ("wo", (L, H * hd, D), out),
            ("w_gate", (L, D, F), 0.02), ("w_up", (L, D, F), 0.02),
            ("w_down", (L, F, D), out)]


def make_weights(s: dict, seed: int, device, dtype=None) -> dict:
    dt = dtype or DTYPES[s["dtype"]]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    w = {}
    for name, shape, scale in leaves(s):
        if scale:
            t = torch.randn(shape, generator=gen, device=device, dtype=dt)
            w[name] = t.mul_(scale)
        else:
            w[name] = torch.zeros(shape, device=device, dtype=dt)
    return w


def program_params(w: dict) -> dict:
    """The flat weights as ``repro_torch.models``' parameter tree."""
    return {"embed": w["embed"], "lm_head": w["lm_head"],
            "final_norm": w["final_norm"],
            "blocks": {"ln1": w["ln1"], "ln2": w["ln2"],
                       "attn": {k: w[k] for k in ("wq", "wk", "wv", "wo",
                                                  "bq", "bk", "bv")},
                       "mlp": {k: w[k] for k in ("w_gate", "w_up",
                                                 "w_down")}}}
