"""Model configuration for the PyTorch port (a copy of ``repro.configs.base``
so the port imports nothing of the JAX package).

The registry holds every architecture of the JAX package, in its order:
one module per architecture under ``repro_torch.configs`` exposing
``CONFIG`` (the published configuration) and ``smoke_config()`` (a
reduced same-family variant for CPU tests).

The fields are JAX's, ``attn_impl`` / ``attn_chunk`` included: they are
copied so that a config equals its JAX twin field by field, but the port
has one attention path, the flash kernels of ``repro_torch.kernels``, and
reads neither.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters (a frozen pytree-free dataclass)."""

    name: str
    arch_type: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # --- attention details -------------------------------------------------
    rope_theta: float = 10_000.0
    qk_norm: bool = False          # qwen3: RMSNorm on per-head q/k
    attn_bias: bool = False        # qwen2: bias on QKV projections
    sliding_window: int = 0        # 0 = full attention on local layers
    global_layer_interval: int = 0  # gemma3: every Nth layer is global
    attn_logit_softcap: float = 0.0  # grok-style logit soft-capping
    # beyond-paper flag: window applied to *all* layers for the long_500k
    # shape so pure full-attention archs still lower a sub-quadratic decode.
    long_context_window: int = 0

    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    dense_residual: bool = False   # arctic: dense MLP residual next to MoE
    capacity_factor: float = 1.25

    # --- SSM (Mamba2 / SSD) --------------------------------------------------
    ssm_state: int = 0             # d_state; 0 = no SSM
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 64            # SSD chunk length
    hybrid: bool = False           # hymba: parallel attn + SSM heads/layer

    # --- modality frontend (stubbed per brief) -----------------------------
    frontend: str = "none"         # none | audio | vision

    # --- perf variants (beyond-paper; see EXPERIMENTS.md §Perf) -------------
    attn_impl: str = "naive"       # naive | chunked (online-softmax, O(S*c))
    attn_chunk: int = 512
    xent_chunk: int = 0            # chunk the loss over seq (0 = off)

    # --- misc ---------------------------------------------------------------
    rmsnorm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    source: str = ""               # citation for the config

    # ------------------------------------------------------------------ api
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim if self.ssm_state else 0

    @property
    def has_attention(self) -> bool:
        return self.arch_type != "ssm"

    @property
    def has_ssm(self) -> bool:
        return self.ssm_state > 0

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def layer_window_sizes(self, seq_len: int) -> Tuple[int, ...]:
        """Per-layer attention window (``seq_len`` means global/full attention).

        gemma3-style: every ``global_layer_interval``-th layer (1-indexed) is
        global, the rest use ``sliding_window``.
        """
        full = seq_len
        if not self.has_attention:
            return tuple()
        out = []
        for i in range(self.n_layers):
            if self.global_layer_interval and (i + 1) % self.global_layer_interval != 0:
                out.append(min(self.sliding_window or full, full))
            elif self.sliding_window and not self.global_layer_interval:
                out.append(min(self.sliding_window, full))
            else:
                out.append(full)
        return tuple(out)

    def param_count(self) -> int:
        """Approximate parameter count (used for 6ND model-FLOPs)."""
        hd = self.resolved_head_dim
        d = self.d_model
        n = 0
        n += self.vocab_size * d  # embed
        if not self.tie_embeddings:
            n += self.vocab_size * d  # lm head
        per_layer = 0
        if self.has_attention:
            per_layer += d * self.n_heads * hd      # wq
            per_layer += 2 * d * self.n_kv_heads * hd  # wk, wv
            per_layer += self.n_heads * hd * d      # wo
        if self.has_ssm:
            di = self.d_inner
            g = 1
            per_layer += d * (2 * di + 2 * g * self.ssm_state + self.ssm_heads)
            per_layer += di * d
        if self.is_moe:
            per_layer += d * self.n_experts  # router
            per_layer += self.n_experts * 3 * d * self.d_ff
            if self.dense_residual:
                per_layer += 3 * d * self.d_ff
        elif self.d_ff:
            per_layer += 3 * d * self.d_ff
        per_layer += 2 * d  # norms
        n += per_layer * self.n_layers
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top-k experts)."""
        if not self.is_moe:
            return self.param_count()
        full = self.param_count()
        skipped = self.n_layers * (self.n_experts - self.top_k) * 3 * self.d_model * self.d_ff
        return full - skipped

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

# arch id -> module name under repro_torch.configs (JAX's order)
ARCH_IDS = {
    "hymba-1.5b": "hymba_1_5b",
    "mamba2-2.7b": "mamba2_2_7b",
    "grok-1-314b": "grok_1_314b",
    "arctic-480b": "arctic_480b",
    "musicgen-large": "musicgen_large",
    "gemma3-12b": "gemma3_12b",
    "qwen2-72b": "qwen2_72b",
    "chameleon-34b": "chameleon_34b",
    "qwen3-4b": "qwen3_4b",
    "gemma3-1b": "gemma3_1b",
    "qwen2.5-7b": "qwen25_7b",
    "qwen2.5-14b": "qwen25_14b",
}


def _module(arch: str):
    key = arch.replace("_", "-").lower()
    if key not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; valid: {sorted(ARCH_IDS)}")
    return importlib.import_module(f"repro_torch.configs.{ARCH_IDS[key]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()


def list_archs() -> Tuple[str, ...]:
    return tuple(ARCH_IDS)
