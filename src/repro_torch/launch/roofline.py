"""Roofline terms of a traced dry-run — the JAX package's
``repro.launch.roofline`` without a compiled artifact to read.

Three terms per (arch x shape x mesh), all in seconds (H100 data-sheet
constants, ``launch.mesh``):

  compute    = FLOPs_per_device / peak_FLOP/s
  memory     = bytes_per_device / HBM_bw
  collective = collective_bytes_per_device / link_bw

JAX reads the three from XLA (``cost_analysis``, ``memory_analysis``, the
HLO text). The port has no compiler between the program and the card, so
:class:`Recorder` watches the program run, one rank's ops at a time:

  * FLOPs: each local aten op's, by ``torch.utils.flop_counter``'s
    formulas, on the LOCAL shards. ``FlopCounterMode`` wrapped around
    DTensor ops would count each global op once; the recorder steps aside
    for every op that has a DTensor argument, so it sees only the local
    ops DTensor runs on each rank's shards (per device, as JAX's
    per-device ``cost_analysis``). It also skips the ops DTensor's
    sharding propagation runs on global-shaped fake tensors to learn an
    output's shape. Ops it has no formula for (elementwise ones) count 0,
    as in ``FlopCounterMode``; the card's own kernels are not aten ops,
    so a caller adds their work by formula (``launch.dryrun``'s attention
    stand-in).
  * bytes: the input plus output bytes of every local op that is not a
    view — what an eager program moves through HBM, the port's stand-in
    for XLA's "bytes accessed" (which counts after fusion, so it is
    smaller).
  * collectives: each ``_c10d_functional`` collective DTensor issues, as
    (kind, dtype, result shape); :func:`collective_bytes` sums them.
  * memory: the bytes of live storages, counted as local ops create them
    and as they are freed; the peak is the device's high-water mark.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._sharding_prop import ShardingPropagator
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.launch.mesh import HBM_BW, ICI_BW, PEAK_FLOPS_BF16

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

#: ``_c10d_functional`` op -> JAX's collective kind. DTensor's
#: redistributions issue no send/recv, so "collective-permute" stays 0.
COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_reduce": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}

#: (kind, dtype, result shape) of one collective
Collective = Tuple[str, torch.dtype, Tuple[int, ...]]


def collective_bytes(record: Iterable[Collective]) -> Dict[str, int]:
    """Per-collective-kind result bytes summed over a record, as JAX sums
    the result shapes of the HLO's collective instructions."""
    out: Dict[str, int] = {k: 0 for k in _COLLECTIVES}
    for kind, dtype, shape in record:
        n = 1
        for d in shape:
            n *= int(d)
        out[kind] += n * dtype.itemsize
    return out


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


class Recorder(TorchDispatchMode):
    """One rank's FLOPs, bytes, collectives and live memory over the ops
    run inside it (module doc). ``flop_formulas`` adds formulas for ops
    ``torch.utils.flop_counter`` has none for (a kernel's stand-in), keyed
    by op packet, called as ``formula(*args, out_val=out, **kwargs)``.
    :meth:`track` counts storages that exist before the run (parameters,
    inputs) as live: their bytes are the run's argument bytes.

    DTensor learns an output's shape by running the op on fake tensors
    in ``ShardingPropagator._propagate_tensor_meta_non_cached``; while
    active, the recorder wraps that method to mark those ops as not the
    program's, and restores it on exit."""

    def __init__(self, flop_formulas: Optional[dict] = None):
        super().__init__()
        self.formulas = dict(flop_registry)
        self.formulas.update(flop_formulas or {})
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives: list = []
        self.argument_bytes = 0
        self.live = 0
        self.peak = 0
        self._storages: Dict[int, int] = {}
        self._propagating = 0
        self._meta = None

    def __enter__(self):
        meta = ShardingPropagator._propagate_tensor_meta_non_cached
        self._meta = meta

        def propagate(prop, op_schema):
            self._propagating += 1
            try:
                return meta(prop, op_schema)
            finally:
                self._propagating -= 1

        ShardingPropagator._propagate_tensor_meta_non_cached = propagate
        return super().__enter__()

    def __exit__(self, *exc):
        ShardingPropagator._propagate_tensor_meta_non_cached = self._meta
        return super().__exit__(*exc)

    # ------------------------------------------------------------- memory
    def _free(self, key: int) -> None:
        self.live -= self._storages.pop(key, 0)

    def _add(self, t: torch.Tensor) -> int:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return 0
        n = st.nbytes()
        self._storages[key] = n
        weakref.finalize(st, self._free, key)
        self.live += n
        self.peak = max(self.peak, self.live)
        return n

    def track(self, *trees) -> None:
        """Count the storages of every tensor (a DTensor's local shard) in
        ``trees`` as live arguments."""
        for t in _tensors(trees):
            self.argument_bytes += self._add(
                t.to_local() if isinstance(t, DTensor) else t)

    # ----------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # DTensor runs it as local ops
        out = func(*args, **kwargs)
        if self._propagating:
            return out
        outs = _tensors(out)
        packet = func._overloadpacket
        if packet in self.formulas:
            self.flops += float(self.formulas[packet](*args, **kwargs,
                                                      out_val=out))
        if not func.is_view:
            self.bytes += sum(t.nbytes for t in _tensors((args, kwargs)))
            self.bytes += sum(t.nbytes for t in outs)
        if func.namespace == "_c10d_functional":
            kind = COLLECTIVE_KINDS.get(packet.__name__)
            if kind is not None:
                self.collectives += [(kind, t.dtype, tuple(t.shape))
                                     for t in outs]
        for t in outs:
            self._add(t)
        return out

    # ----------------------------------------- JAX's memory_analysis names
    @property
    def argument_size_in_bytes(self) -> int:
        return self.argument_bytes

    @property
    def temp_size_in_bytes(self) -> int:
        """The peak above the arguments (outputs included: the run's
        results are live at its end)."""
        return self.peak - self.argument_bytes

    output_size_in_bytes = 0
    alias_size_in_bytes = 0


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    n_chips: int
    # raw per-device numbers
    hlo_flops: float
    hlo_bytes: float
    coll_bytes: float
    coll_breakdown: Dict[str, int]
    # terms (seconds)
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    # usefulness
    model_flops: float           # 6ND (train) / 2ND (prefill) / 2·N_act·B (decode)
    useful_ratio: float          # model_flops / (hlo_flops * chips)
    # memory (Recorder)
    argument_bytes: int = 0
    output_bytes: int = 0
    temp_bytes: int = 0
    notes: str = ""

    def dominant(self) -> str:
        return self.bottleneck


def model_flops_for(cfg: ModelConfig, shape: InputShape) -> float:
    n_active = cfg.active_param_count()
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * tokens
    # decode: ONE token per sequence + attention over the cache
    flops = 2.0 * n_active * shape.global_batch
    if cfg.has_attention:
        ctx = shape.seq_len
        if shape.name == "long_500k" and cfg.long_context_window:
            ctx = min(ctx, cfg.long_context_window)
        flops += (2.0 * shape.global_batch * cfg.n_layers
                  * cfg.n_heads * cfg.resolved_head_dim * 2 * ctx)
    return flops


def build_report(
    cfg: ModelConfig,
    shape: InputShape,
    mesh_name: str,
    n_chips: int,
    cost: dict,
    collectives: Iterable[Collective],
    mem=None,
    notes: str = "",
) -> RooflineReport:
    """JAX's ``build_report``: ``cost`` holds ``"flops"`` and ``"bytes
    accessed"`` per device (a :class:`Recorder`'s), ``collectives`` the
    record of issued collectives, ``mem`` JAX's ``memory_analysis`` names
    (a :class:`Recorder` has them)."""
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    coll = collective_bytes(collectives)
    cbytes = float(sum(coll.values()))
    t_c = flops / PEAK_FLOPS_BF16
    t_m = byts / HBM_BW
    t_x = cbytes / ICI_BW
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    mf = model_flops_for(cfg, shape)
    return RooflineReport(
        arch=cfg.name, shape=shape.name, mesh=mesh_name, n_chips=n_chips,
        hlo_flops=flops, hlo_bytes=byts, coll_bytes=cbytes,
        coll_breakdown=coll,
        t_compute=t_c, t_memory=t_m, t_collective=t_x,
        bottleneck=max(terms, key=terms.get),
        model_flops=mf,
        useful_ratio=mf / (flops * n_chips) if flops else 0.0,
        argument_bytes=getattr(mem, "argument_size_in_bytes", 0),
        output_bytes=getattr(mem, "output_size_in_bytes", 0),
        temp_bytes=getattr(mem, "temp_size_in_bytes", 0),
        notes=notes,
    )
