"""Roofline of one rank's step on the H100, from the port's own counts
(the counterpart of ``repro/analysis/roofline.py``, whose terms come from
a compiled TPU module).

Per (arch x shape x mesh) cell, from ``hlo_cost.CostTotals``:
    compute term    = sum over FLOP classes of FLOPs / that class's peak
    memory term     = bytes / HBM bandwidth
    collective term = sum over mesh axes of the collectives' result bytes
                      / that axis' link bandwidth (the reference's
                      convention: result bytes over one link's rate)

Hardware constants: the H100 SXM data sheet (dense), at its 700 W limit.
The port runs with TF32 off, so its f32 matmuls get no tensor cores, and
elementwise work runs on the CUDA cores whatever its type (``"vector"``).
A mesh axis whose ranks lie within one 8-card node talks over NVLink;
one that crosses nodes over the node's network, one 400 Gb/s NDR port a
card. The collectives come counted by axis (``hlo_cost``), so the
reference's ``parse_collectives`` of HLO text has no counterpart.
"""
from __future__ import annotations

import dataclasses

# H100 SXM, 700 W: dense bf16 tensor-core FLOP/s
PEAK_FLOPS_BF16 = 989e12
# H100 SXM, 700 W: f32 FLOP/s on the CUDA cores (no TF32)
PEAK_FLOPS_F32 = 67e12
# peak FLOP/s by FLOP class (hlo_cost's flops_by_dtype keys); a class not
# named here runs at the CUDA cores' f32 rate
PEAK_FLOPS = {"bfloat16": PEAK_FLOPS_BF16, "float16": PEAK_FLOPS_BF16,
              "float32": PEAK_FLOPS_F32, "vector": PEAK_FLOPS_F32}
# H100 SXM, 700 W: HBM3 bytes/s
HBM_BW = 3.35e12
# H100 SXM: NVLink 4 bytes/s a direction, between cards of one node
NVLINK_BW = 450e9
# one 400 Gb/s NDR InfiniBand port a card: bytes/s a direction across nodes
NETWORK_BW = 50e9
CARDS_PER_NODE = 8              # an HGX H100 node


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: dict
    count_by_kind: dict

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())


@dataclasses.dataclass
class Roofline:
    flops: float                 # per device
    hbm_bytes: float             # per device
    collective_bytes: float      # per device
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float           # 6*N*D useful flops (global)
    model_flops_per_device: float
    useful_ratio: float          # model_flops_per_device / counted flops
    mfu_bound: float             # model flops / (chips*peak*dominant_term)
    collectives: CollectiveStats
    flops_by_dtype: dict = dataclasses.field(default_factory=dict)
    collective_s_by_axis: dict = dataclasses.field(default_factory=dict)
    link_bw_by_axis: dict = dataclasses.field(default_factory=dict)

    def terms(self):
        return dict(compute_s=self.compute_s, memory_s=self.memory_s,
                    collective_s=self.collective_s,
                    bottleneck=self.bottleneck)


def _axis_ranks(mesh, axis: str) -> list:
    """The ranks of rank 0's group along ``axis``: a DeviceMesh's, else
    (a stand-in with ``.shape``) the row-major layout's."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        grid = mesh.mesh
        i = names.index(axis)
        return grid[tuple(slice(None) if j == i else 0
                          for j in range(grid.dim()))].tolist()
    sizes = list(dict(mesh.shape).items())
    stride = 1
    for name, n in reversed(sizes):
        if name == axis:
            return [k * stride for k in range(n)]
        stride *= n
    raise KeyError(axis)


def link_bandwidth(mesh, axis: str) -> float:
    """Bytes/s a direction for ``axis``' collectives: NVLink where its
    ranks lie within one CARDS_PER_NODE node, else the network."""
    nodes = {r // CARDS_PER_NODE for r in _axis_ranks(mesh, axis)}
    return NVLINK_BW if len(nodes) == 1 else NETWORK_BW


def analyze(totals, *, n_devices: int, model_flops: float,
            mesh=None) -> Roofline:
    """The roofline of ``totals`` (one rank's ``hlo_cost.CostTotals``) on
    ``n_devices`` cards; ``mesh`` places each axis' links (without it
    every axis takes the network's rate)."""
    by_dtype = dict(totals.flops_by_dtype)
    compute_s = sum(n / PEAK_FLOPS.get(k, PEAK_FLOPS_F32)
                    for k, n in by_dtype.items())
    memory_s = totals.bytes / HBM_BW
    link, coll_s = {}, {}
    for axis, kinds in totals.collectives_by_axis.items():
        link[axis] = NETWORK_BW if mesh is None else link_bandwidth(mesh,
                                                                    axis)
        coll_s[axis] = sum(b for _, b in kinds.values()) / link[axis]
    collective_s = sum(coll_s.values())
    colls = CollectiveStats(dict(totals.bytes_by_kind),
                            dict(totals.count_by_kind))
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)

    mf_dev = model_flops / n_devices
    dominant = max(compute_s, memory_s, collective_s)
    mfu_bound = (mf_dev / PEAK_FLOPS_BF16) / dominant if dominant > 0 else 0.0
    return Roofline(
        flops=totals.flops, hbm_bytes=totals.bytes,
        collective_bytes=float(colls.total_bytes), compute_s=compute_s,
        memory_s=memory_s, collective_s=collective_s, bottleneck=bottleneck,
        model_flops=model_flops, model_flops_per_device=mf_dev,
        useful_ratio=(mf_dev / totals.flops) if totals.flops else 0.0,
        mfu_bound=mfu_bound, collectives=colls, flops_by_dtype=by_dtype,
        collective_s_by_axis=coll_s, link_bw_by_axis=link)


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS: 6*N*D for training, 2*N*D forward-only, with N =
    active params (MoE) and D = processed tokens for the cell."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence; attention reads of the cache are the
    # real cost but 2*N*D is the convention for useful work
    tokens = shape.global_batch * 1
    return 2.0 * n_active * tokens
