"""Roofline terms of one step on a mesh, from a trace of the step on
``meta`` tensors (``launch/dryrun.py``); no card needed.

Three terms per (arch x shape x mesh), in seconds:

  compute    = FLOPs_per_device / peak_flops_per_card
  memory     = bytes_per_device / hbm_bw_per_card
  collective = sum over collectives of wire bytes / link_bw

As in the reference (``repro/launch/roofline.py``) the compute and
memory terms come from the analytic model (:func:`analytic_cost`, the
reference's, number for number), and the collective term from the
collectives the step actually issues.  The reference reads those from
XLA's compiled HLO text, multiplying each ``while`` body's collectives by
its trip count; the port's step is eager PyTorch with a Python layer
loop, so :class:`CollectiveRecorder`, a ``TorchDispatchMode``, sees each
functional (``_c10d_functional``) and c10d collective as it is issued,
with its output shape, dtype and group size, and no trip-count
correction is needed.  It records the per-rank collectives that DTensor
issues inside its ops on local shards, and so does a
``FlopCounterMode`` entered outside it: :func:`trace_counts` gives the
per-rank FLOPs of the trace, kept as the ``hlo_flops`` evidence field.
``hlo_bytes`` has no counterpart (PyTorch counts no bytes accessed) and
stays 0.

Hardware constants: NVIDIA H100 SXM, bf16 dense 989e12 FLOP/s, HBM3
3.35e12 B/s, NVLink 450e9 B/s a direction.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

H100_PEAK_FLOPS = 989e12       # bf16 dense, per card
H100_HBM_BW = 3.35e12          # bytes/s per card
H100_NVLINK_BW = 450e9         # bytes/s per direction per card


# Ring-algorithm bytes-on-wire per device, from the collective's OUTPUT
# shape and group size G (the reference's factors):
#   all-reduce      out = in  = N      -> 2 (G-1)/G * N
#   all-gather      out = G*in         -> (G-1)/G * out
#   reduce-scatter  out = in/G         -> (G-1)/G * (out*G) = (G-1)*out
#   all-to-all      out = in  = N      -> (G-1)/G * N
#   collective-permute                 -> out
def _wire_bytes(op: str, out_bytes: float, group: int) -> float:
    if group <= 1:
        return 0.0
    if op == "all-reduce":
        return 2.0 * (group - 1) / group * out_bytes
    if op == "all-gather":
        return (group - 1) / group * out_bytes
    if op == "reduce-scatter":
        return (group - 1) * out_bytes
    if op == "all-to-all":
        return (group - 1) / group * out_bytes
    if op == "collective-permute":
        return out_bytes
    return 0.0


@dataclasses.dataclass
class CollectiveStats:
    by_op: dict
    wire_bytes: float           # sum of output bytes x wire factor
    raw_bytes: float            # sum of output bytes

    def to_dict(self):
        return {"by_op": self.by_op, "wire_bytes": self.wire_bytes,
                "raw_bytes": self.raw_bytes}


# op name (without overload) -> the reference's collective kind
_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "broadcast": "broadcast", "broadcast_": "broadcast",
}


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _group_size(func, args) -> int:
    """The group size of a functional collective (its trailing
    ``group_name``) or a c10d one (its ProcessGroup argument)."""
    if func.namespace == "_c10d_functional":
        from torch.distributed.distributed_c10d import _resolve_process_group
        return _resolve_process_group(args[-1]).size()
    for a in args:
        if isinstance(a, torch.ScriptObject) and a._type().qualified_name() \
                .endswith("c10d.ProcessGroup"):
            return torch.distributed.ProcessGroup.unbox(a).size()
    return 1


class CollectiveRecorder(TorchDispatchMode):
    """Records every collective issued while it is active: its kind (the
    reference's names), output bytes and group size, and so its wire
    bytes (:func:`_wire_bytes`).  An op on ``DTensor``s is passed
    through to DTensor, so the collectives it issues on local shards
    inside the op are seen too."""

    def __init__(self):
        super().__init__()
        self.calls: list[dict] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        kind = _KINDS.get(func.__name__.split(".")[0]) \
            if func.namespace in ("_c10d_functional", "c10d") else None
        if kind is not None:
            # in-place c10d ops write into their first argument
            ts = _tensors(out) if func.namespace == "_c10d_functional" \
                else _tensors(args[0])
            g = _group_size(func, args)
            b = _nbytes(ts)
            self.calls.append({"op": kind, "bytes": b, "group": g,
                               "wire_bytes": _wire_bytes(kind, b, g),
                               "name": str(func)})
        return out

    def stats(self) -> CollectiveStats:
        by_op: dict = {}
        for c in self.calls:
            d = by_op.setdefault(c["op"], {"count": 0, "bytes": 0.0,
                                           "wire_bytes": 0.0})
            d["count"] += 1
            d["bytes"] += c["bytes"]
            d["wire_bytes"] += c["wire_bytes"]
        return CollectiveStats(by_op, sum(c["wire_bytes"] for c in
                                          self.calls),
                               float(sum(c["bytes"] for c in self.calls)))


def trace_counts(fn, *args):
    """``fn(*args)`` under a ``FlopCounterMode`` and, inside it, a
    :class:`CollectiveRecorder`: ``(output, per-rank flops,
    CollectiveStats)``."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc, CollectiveRecorder() as rec:
        out = fn(*args)
    return out, float(fc.get_total_flops()), rec.stats()


# --------------------------------------------------------- analytic model

def _per_layer_matmul_params(cfg) -> float:
    """Matmul parameters per (average) layer: fwd flops = 2*P*tokens."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    if cfg.family == "ssm":
        s = cfg.ssm
        dtr = s.dt_rank or max(1, -(-d // 16))
        return (d * 2 * s.d_inner + s.d_inner * (dtr + 2 * s.state_dim)
                + dtr * s.d_inner + s.d_inner * d)
    attn = d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd \
        + cfg.n_heads * hd * d
    glu = 3 if cfg.activation in ("swiglu", "geglu") else 2
    if cfg.family == "moe":
        m = cfg.moe
        # capacity-factor waste included: E*C slots ~ cf*k*Sc tokens compute
        expert = m.capacity_factor * m.top_k * glu * d * m.expert_d_ff
        router = d * m.n_experts
        return attn + expert + router
    mlp = glu * d * cfg.d_ff
    if cfg.family == "hybrid":
        h = cfg.hybrid
        w = h.lru_width or d
        n_attn = sum(1 for p in h.pattern if p == "attn")
        n_rec = len(h.pattern) - n_attn
        rec = d * 2 * w + w * d
        return (n_attn * (attn + mlp) + n_rec * (rec + mlp)) / len(h.pattern)
    if cfg.family == "encdec":
        e = cfg.encdec
        enc = attn + mlp
        dec = 2 * attn + mlp
        return (e.n_enc_layers * enc + e.n_dec_layers * dec) \
            / (e.n_enc_layers + e.n_dec_layers)
    return attn + mlp


def _moe_dispatch_flops_per_token(cfg) -> float:
    """One-hot dispatch+combine einsum overhead (moe.py capacity path)."""
    if cfg.family != "moe":
        return 0.0
    m = cfg.moe
    from repro_torch.models.moe import MOE_CHUNK
    chunk = MOE_CHUNK
    cap = max(int(m.capacity_factor * chunk * m.top_k / m.n_experts), 1)
    return 2 * 2.0 * m.n_experts * cap * cfg.d_model


def _n_layers_eff(cfg) -> float:
    if cfg.family == "encdec":
        return cfg.encdec.n_enc_layers + cfg.encdec.n_dec_layers
    return cfg.n_layers


def analytic_cost(cfg, shape, *, remat: str = "full",
                  causal_skip: bool = False, n_chips: int = 256,
                  data_shards: int = 16, window=None) -> dict:
    """Analytic FLOPs / HBM bytes for one step of this (arch x shape), the
    reference's model: ideal minimum traffic for the configured
    sharding."""
    kind = shape.kind
    B = shape.global_batch
    S = 1 if kind == "decode" else shape.seq_len
    ctx = shape.seq_len                     # decode context = cache length
    win = window if window is not None else cfg.sliding_window
    T = B * S
    d, hd = cfg.d_model, cfg.resolved_head_dim
    L = _n_layers_eff(cfg)
    b_par = 2 if cfg.dtype == "bfloat16" else 4

    # ---- flops
    p_layer = _per_layer_matmul_params(cfg)
    mm = 2.0 * p_layer * T * L
    if cfg.family == "moe":
        m = cfg.moe
        glu = 3 if cfg.activation in ("swiglu", "geglu") else 2
        if kind == "decode":
            # dispatch-einsum decode computes every expert slot (B x E)
            mm += 2.0 * T * L * (m.n_experts - m.capacity_factor * m.top_k) \
                * glu * cfg.d_model * m.expert_d_ff
        else:
            mm += T * _moe_dispatch_flops_per_token(cfg) * cfg.n_layers
    # attention scores+values: 4 * T * ctx_eff * H * hd per layer
    attn_fl = 0.0
    if cfg.n_heads:
        if kind == "decode":
            ctx_eff = min(ctx, win) if win else ctx
        else:
            ctx_eff = S / 2 if causal_skip else S
        frac_attn = 1.0
        if cfg.family == "hybrid":
            frac_attn = sum(1 for p in cfg.hybrid.pattern if p == "attn") \
                / len(cfg.hybrid.pattern)
        attn_fl = 4.0 * T * ctx_eff * cfg.n_heads * hd * L * frac_attn
        if cfg.family == "encdec" and kind != "decode":
            F = cfg.encdec.n_frames
            attn_fl += 4.0 * B * F * F * cfg.n_heads * hd \
                * cfg.encdec.n_enc_layers
            attn_fl += 4.0 * T * F * cfg.n_heads * hd * cfg.encdec.n_dec_layers
    # recurrences (ssm / rglru): elementwise, ~flops per token
    rec_fl = 0.0
    if cfg.family == "ssm":
        s = cfg.ssm
        rec_fl = T * L * (12.0 * s.d_inner * s.state_dim
                          + 2 * s.conv_width * s.d_inner
                          + 2 * s.d_inner * s.state_dim)
    if cfg.family == "hybrid":
        w = cfg.hybrid.lru_width or d
        frac_rec = sum(1 for p in cfg.hybrid.pattern if p == "rglru") \
            / len(cfg.hybrid.pattern)
        rec_fl = T * L * frac_rec * (20.0 * w + 8.0 * w)
    head_fl = 2.0 * T * d * cfg.vocab_size
    fwd = mm + attn_fl + rec_fl + head_fl
    if kind == "train":
        mult = {"none": 3.0, "dots": 3.4, "full": 4.0}[remat]
        flops = mult * fwd
    else:
        flops = fwd

    # ---- bytes (per component, with its real sharding divisor)
    n_params = cfg.n_params()
    if kind == "train":
        par_bytes = n_params * (2 * b_par + b_par + 4 * 4)
        act_factor = {"none": 2.0, "dots": 3.0, "full": 3.0}[remat]
        act_bytes = act_factor * L * T * d * b_par
        head_bytes = 3.0 * T * cfg.vocab_size * 4.0
        per_dev = (par_bytes / n_chips + act_bytes / n_chips
                   + head_bytes / n_chips)
    elif kind == "prefill":
        par_bytes = n_params * b_par
        act_bytes = L * T * d * b_par
        kv_bytes = 2.0 * L * T * cfg.n_kv_heads * hd * b_par \
            if cfg.n_heads else 0.0
        head_bytes = 2.0 * T * cfg.vocab_size * 4.0
        per_dev = (par_bytes + act_bytes + head_bytes) / n_chips \
            + kv_bytes / n_chips
    else:  # decode
        par_bytes = n_params * b_par
        if cfg.family == "ssm":
            s = cfg.ssm
            cache = B * L * (s.d_inner * s.state_dim * 4
                             + s.conv_width * s.d_inner * b_par)
            cache_dev = cache / n_chips
        elif cfg.family == "hybrid":
            w = cfg.hybrid.lru_width or d
            eff = min(ctx, cfg.hybrid.attn_window)
            n_attn = cfg.n_layers * sum(
                1 for p in cfg.hybrid.pattern if p == "attn") \
                / len(cfg.hybrid.pattern)
            cache = B * (cfg.n_layers * w * 4
                         + n_attn * 2 * eff * cfg.n_kv_heads * hd * b_par)
            cache_dev = cache / max(data_shards, 1)
        else:
            eff = min(ctx, win) if win else ctx
            kv_l = L if cfg.family != "encdec" else cfg.encdec.n_dec_layers
            cache = B * kv_l * 2 * eff * cfg.n_kv_heads * hd * b_par
            if cfg.family == "encdec":
                cache += B * cfg.encdec.n_dec_layers * 2 \
                    * cfg.encdec.n_frames * cfg.n_kv_heads * hd * b_par
            cache_dev = cache / max(data_shards, 1)
        head_bytes = T * cfg.vocab_size * 4.0
        per_dev = par_bytes / n_chips + cache_dev + head_bytes / n_chips

    return {"flops_total": flops, "flops_per_device": flops / n_chips,
            "bytes_per_device": per_dev,
            "breakdown": {"matmul_flops": mm, "attn_flops": attn_fl,
                          "recurrence_flops": rec_fl,
                          "head_flops": head_fl}}


@dataclasses.dataclass
class Roofline:
    flops: float                 # per-device flops (analytic model)
    hbm_bytes: float             # per-device HBM bytes (analytic model)
    collective_wire_bytes: float  # recorded collectives
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_flops: float           # 6*N_active*D useful flops per device
    useful_ratio: float
    hlo_flops: float = 0.0       # the trace's per-rank FlopCounterMode total
    hlo_bytes: float = 0.0       # no counterpart: always 0

    def to_dict(self):
        return dataclasses.asdict(self)


def derive(cost: dict, coll: CollectiveStats, *, n_chips: int,
           model_flops_total: float, analytic: Optional[dict] = None
           ) -> Roofline:
    """The roofline terms on the H100 constants.  ``cost`` holds the
    trace's ``flops`` (and ``bytes accessed``, which the port never
    has)."""
    hlo_flops = float(cost.get("flops", 0.0) or 0.0)
    hlo_bytes = float(cost.get("bytes accessed", 0.0) or 0.0)
    if analytic is not None:
        flops = analytic["flops_per_device"]
        hbm = analytic["bytes_per_device"]
    else:
        flops, hbm = hlo_flops, hlo_bytes
    t_c = flops / H100_PEAK_FLOPS
    t_m = hbm / H100_HBM_BW
    t_x = coll.wire_bytes / H100_NVLINK_BW
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    bottleneck = max(terms, key=terms.get)
    mf = model_flops_total / n_chips
    return Roofline(flops=flops, hbm_bytes=hbm,
                    collective_wire_bytes=coll.wire_bytes,
                    t_compute=t_c, t_memory=t_m, t_collective=t_x,
                    bottleneck=bottleneck, model_flops=mf,
                    useful_ratio=(mf / flops) if flops else 0.0,
                    hlo_flops=hlo_flops, hlo_bytes=hlo_bytes)


def model_flops(cfg, shape) -> float:
    """Useful-work model: 6*N_active*D train, 2*N_active*D inference."""
    n = cfg.n_active_params()
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n * tokens
