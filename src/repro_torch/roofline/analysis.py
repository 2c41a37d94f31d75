"""Three-term roofline analysis of one training or serving step on H100s:
the port of ``repro.roofline.analysis``.

    compute term    = FLOPs a rank            / peak FLOP/s
    memory term     = HBM bytes a rank        / HBM bandwidth
    collective term = collective bytes a rank / link bandwidth

The reference reads FLOPs and bytes from XLA's cost analysis and parses
collectives out of the partitioned HLO.  The port has no compiled program:
a step's FLOPs come from ``torch.utils.flop_counter.FlopCounterMode`` (plus
what the caller adds for kernels it cannot see), its HBM bytes from the
analytic model :func:`analytic_hbm_bytes`, and its collective bytes from
:class:`CollectiveTally`, a dispatch mode that sums the result of every
collective DTensor issues.

Hardware constants: one NVIDIA H100 SXM5 80GB at its 700 W power limit
(NVIDIA's H100 data sheet, dense rates without sparsity), and two stated
assumptions about a DGX H100 cluster for the collective term: NVLink 4
inside an 8-GPU node, InfiniBand NDR (400 Gb/s, one port a GPU) between
nodes.  Those two are never measured here.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..kernels.ref import CHUNKED_THRESHOLD, Q_CHUNK

HW_H100 = {
    "peak_flops_bf16": 989e12,  # dense bf16 / fp16 tensor-core FLOP/s
    "peak_ops_int8": 1979e12,  # dense int8 tensor-core OP/s
    "peak_flops_fp32": 67e12,  # fp32 outside the tensor cores
    "hbm_bw": 3.35e12,  # HBM3, bytes/s
    "hbm_bytes": 80e9,  # 80 GB of HBM
    "nvlink_bw": 450e9,  # NVLink 4, a direction, inside a node (assumed)
    "ib_bw": 50e9,  # InfiniBand NDR a GPU, between nodes (assumed)
}
GPUS_PER_NODE = 8  # a DGX H100 node (assumed)

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")


def kernel_bound(nbytes: float, ops: float, peak: float = HW_H100["peak_flops_bf16"]):
    """The least time (ms) a kernel could take on the card, and what binds
    it: ``nbytes`` (each input byte read once, each output byte written
    once) at the HBM bandwidth against ``ops`` at ``peak`` (OP/s of the
    operands' type).  Returns ``(ms, "bytes" | "operations")``."""
    t_bytes = nbytes / HW_H100["hbm_bw"] * 1e3
    t_ops = ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def link_bw(chips: int) -> float:
    """The collective term's bandwidth: NVLink inside one node, InfiniBand
    once a mesh spans nodes (a ring is as fast as its slowest link)."""
    return HW_H100["nvlink_bw"] if chips <= GPUS_PER_NODE else HW_H100["ib_bw"]


# ---------------------------------------------------------------------------
# collective bytes
# ---------------------------------------------------------------------------


def _c10d_kinds():
    """The collectives DTensor and the pipeline issue, by op overload
    packet, under the reference's five kinds: the functional ops DTensor
    redistributes by (their result is the unit) and the process group's
    in-place ops (their first argument, the output or, for a send, the
    tensors sent)."""
    fc, c10d = torch.ops._c10d_functional, torch.ops.c10d
    functional = {fc.all_reduce: "all-reduce", fc.all_reduce_: "all-reduce",
                  fc.all_gather_into_tensor: "all-gather",
                  fc.reduce_scatter_tensor: "reduce-scatter",
                  fc.all_to_all_single: "all-to-all"}
    in_place = {c10d.allreduce_: "all-reduce", c10d.allgather_: "all-gather",
                c10d._allgather_base_: "all-gather",
                c10d.reduce_scatter_: "reduce-scatter",
                c10d._reduce_scatter_base_: "reduce-scatter",
                c10d.alltoall_base_: "all-to-all", c10d.send: "collective-permute"}
    return functional, in_place


def _nbytes(t) -> int:
    if isinstance(t, torch.Tensor):
        return t.numel() * t.element_size()
    if isinstance(t, (list, tuple)):
        return sum(_nbytes(x) for x in t)
    return 0


class CollectiveTally(TorchDispatchMode):
    """Sums the size of every collective issued while it is active, keyed
    by the reference's five kinds, in the reference's unit: the gathered
    tensor of an all-gather, the shard of a reduce-scatter, the reduced
    tensor of an all-reduce, the tensors a point-to-point send moves
    ("collective-permute").  ``bytes`` and ``counts`` are one rank's."""

    def __init__(self):
        super().__init__()
        self.bytes: Dict[str, int] = {k: 0 for k in KINDS}
        self.counts: Dict[str, int] = {k: 0 for k in KINDS}
        self._functional, self._in_place = _c10d_kinds()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        packet = func.overloadpacket
        kind = self._functional.get(packet)
        sized = out
        if kind is None:
            kind, sized = self._in_place.get(packet), args[0] if args else None
        if kind is not None:
            self.bytes[kind] += _nbytes(sized)
            self.counts[kind] += 1
        return out

    @property
    def total(self) -> int:
        return sum(self.bytes.values())


# ---------------------------------------------------------------------------
# the three terms
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    flops: float  # FLOPs a rank
    hbm_bytes: float  # HBM bytes a rank (an upper bound where given raw)
    coll_bytes: float  # collective traffic a rank
    coll_breakdown: Dict[str, int]
    model_flops: float  # 6*N*D useful FLOPs (global)
    chips: int
    flop_correction: float = 0.0  # FLOPs a counter cannot see, a rank
    analytic_bytes: float = 0.0  # fusion-aware HBM estimate (0 = unavailable)
    peak_flops: float = HW_H100["peak_flops_bf16"]
    hbm_bw: float = HW_H100["hbm_bw"]
    link_bw: float = HW_H100["nvlink_bw"]

    @property
    def compute_s(self) -> float:
        return (self.flops + self.flop_correction) / self.peak_flops

    @property
    def memory_ub_s(self) -> float:
        """The bytes given raw (``hbm_bytes``) over the bandwidth."""
        return self.hbm_bytes / self.hbm_bw

    @property
    def memory_s(self) -> float:
        """Memory term: the analytic estimate when available, else the raw
        bytes."""
        if self.analytic_bytes > 0:
            return self.analytic_bytes / self.hbm_bw
        return self.memory_ub_s

    @property
    def collective_s(self) -> float:
        return self.coll_bytes / self.link_bw

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """Roofline step time: dominant term (others assumed overlapped)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_fraction(self) -> float:
        """model FLOPs / (FLOPs a rank * chips): how much of the counted
        compute is useful (catches recompute, dispatch and padding)."""
        total = (self.flops + self.flop_correction) * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilization at the roofline step time."""
        denom = self.step_s * self.peak_flops * self.chips
        return self.model_flops / denom if denom else 0.0

    def row(self) -> Dict[str, object]:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": self.mesh,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "model_flops": self.model_flops,
            "flops_per_rank": self.flops,
            "useful_fraction": self.useful_fraction,
            "mfu_at_roofline": self.mfu,
        }


def measured_mfu(model_flops: float, step_s: float, chips: int = 1,
                 peak: float = HW_H100["peak_flops_bf16"]) -> float:
    """Model FLOPs over what ``chips`` cards could do in a measured step."""
    return model_flops / (step_s * peak * chips)


def attention_flops(cfg, cell, passes: int) -> float:
    """O(S^2) attention FLOPs (qk + pv), causal halved, windows clipped."""
    if not cfg.attends:
        return 0.0
    h, hd, L = cfg.num_heads, cfg.head_dim, cfg.num_layers
    s = cell.seq
    if cfg.sliding_window:
        # all-but-3 layers see only `window` keys (hybrid global layers full)
        w = cfg.sliding_window
        per_tok = min(w, s)
        full_layers = 3 if cfg.family == "hybrid" else 0
        win_layers = L - full_layers
        att = cell.batch * h * hd * 2 * 2 * (
            win_layers * s * per_tok + full_layers * (s * s // 2)
        )
    else:
        att = cell.batch * L * h * (s * s // 2) * hd * 2 * 2
    return float(att * passes)


def model_flops(cfg, cell) -> float:
    """Useful model FLOPs for the cell: 6*N*D train, 2*N*D per forward token
    (N = active params for MoE), plus attention score/value FLOPs."""
    n_active = cfg.param_count(active_only=True)
    tokens = cell.batch * cell.seq if cell.kind in ("train", "prefill") else cell.batch
    mult = 6 if cell.kind == "train" else 2
    base = mult * n_active * tokens
    if cell.kind in ("train", "prefill"):
        base += attention_flops(cfg, cell, 3 if cell.kind == "train" else 1)
    return float(base)


def chunked_attention_correction(cfg, cell, chips: int) -> float:
    """The reference's correction of its HLO cost analysis, which counts a
    loop body once when the plain attention streams query chunks
    (``kernels/ref.py``'s ``CHUNKED_THRESHOLD``, ``Q_CHUNK``): (nq-1)/nq of
    the attention FLOPs a rank.  Kept for parity; ``FlopCounterMode`` counts
    every chunk, so the port's dry run adds none of it."""
    if cell.kind not in ("train", "prefill") or not cfg.attends:
        return 0.0
    s = cell.seq
    if s < CHUNKED_THRESHOLD or s % Q_CHUNK:
        return 0.0
    nq = s // Q_CHUNK
    passes = 3 if cell.kind == "train" else 1
    missing = attention_flops(cfg, cell, passes) * (nq - 1) / nq
    return missing / chips


# ---------------------------------------------------------------------------
# Analytic HBM traffic model (analysis.py:195-276, unchanged):
#
#   params     : read in fwd + read in bwd (+ grad write)          [train]
#   optimizer  : ZeRO-1 masters/moments, 3 reads + 3 writes f32    [train]
#   activations: ~6 residual-width + 2 ffn-width values moved per
#                token-layer in fwd; x4 for fwd+remat-recompute+bwd [train]
#   attention  : the S^2 score tensor of the plain attention spills to HBM
#                (~4 passes); the flash kernel keeps it on chip
#                — `flash_attention=True` removes this term.
#   kv/state   : decode reads the entire cache once per token.
# ---------------------------------------------------------------------------


def analytic_hbm_bytes(cfg, cell, mesh_shape: Dict[str, int],
                       flash_attention: bool = False) -> float:
    tp = mesh_shape.get("model", 1)
    dp = mesh_shape.get("data", 1) * mesh_shape.get("pod", 1)
    chips = tp * dp
    p_total = cfg.param_count()
    p_active = cfg.param_count(active_only=True)
    bytes_param = 2  # bf16
    tokens_local = cell.batch * cell.seq / dp if cell.kind in ("train", "prefill") else cell.batch / min(dp, cell.batch)

    total = 0.0
    if cell.kind == "train":
        total += 2 * p_total / tp * bytes_param * 2  # fwd + bwd weight reads
        total += p_total / tp * bytes_param  # grad write (bf16 wire)
        total += 6 * 4 * p_total / chips  # ZeRO-1: r/w master+m+v f32
    else:
        # inference touches only active params (MoE skips unrouted experts)
        total += p_active / tp * bytes_param

    d, f = cfg.d_model, cfg.d_ff or (cfg.moe.d_ff_expert * cfg.moe.experts_per_token if cfg.moe else 0)
    L = cfg.num_layers
    passes = 4 if cell.kind == "train" else 1
    # ~6 residual-width + 2 ffn-width values per token-layer, tp-sharded
    total += passes * L * tokens_local * (6 * d + 2 * f) / max(tp, 1) * bytes_param

    if cfg.attends and not flash_attention and cell.kind in ("train", "prefill"):
        s = cell.seq
        h = cfg.num_heads
        b_loc = max(cell.batch / dp, 1)
        keys = min(cfg.sliding_window or s, s)
        att_passes = 4 if cell.kind == "train" else 2
        if h % tp == 0:  # heads shard over `model`
            h_loc, s_loc = h / tp, s
        else:  # seq-shard fallback (make_hints)
            h_loc, s_loc = h, s / tp
        total += att_passes * L * b_loc * h_loc * s_loc * keys * 4  # f32 scores

    if cell.kind == "decode":
        # read the full KV/state cache once per token
        if cfg.attention == "gqa":
            per_layer = cfg.num_kv_heads * cfg.head_dim * 2 * bytes_param
            sizes = []
            for i in range(L):
                wdw = cfg.window_for_layer(i)
                if cfg.family == "hybrid" and i in (0, L // 2, L - 1):
                    wdw = None
                sizes.append(min(wdw or cell.seq, cell.seq))
            total += cell.batch * per_layer * sum(sizes) / chips * dp  # sharded over chips
        elif cfg.attention == "mla":
            m = cfg.mla
            total += cell.batch * L * cell.seq * (m.kv_lora_rank + m.qk_rope_head_dim) * bytes_param / tp
        if cfg.ssm is not None:
            nh = cfg.ssm.num_heads(d)
            total += cell.batch * L * nh * cfg.ssm.state_dim * cfg.ssm.head_dim * 4 / tp
    return float(total)


__all__ = ["HW_H100", "KINDS", "CollectiveTally", "RooflineTerms",
           "analytic_hbm_bytes", "attention_flops", "chunked_attention_correction",
           "kernel_bound", "link_bw", "measured_mfu", "model_flops"]
