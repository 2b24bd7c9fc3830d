"""Eyexam (paper Appendix A): the analytic performance bound, and the rates
of the device the serving plan divides by.

The port's counterpart of the analytic half of ``repro.core.eyexam``:

* :class:`DeviceRates` names a device's peak rates. :data:`TPU_V5E` holds
  the reference's constants, :data:`H100_SXM` the H100's data-sheet rates;
  every reader of a rate (``Roofline``, ``core.plan.mlp_roofline``,
  ``serve.kvcache``) defaults to :data:`H100_SXM`, and passing
  :data:`TPU_V5E` reproduces the reference's numbers;
* :class:`Roofline`, the three-term roofline over a :class:`DeviceRates`;
* ``seven_steps`` (the paper's step-by-step tightening of the bound:
  workload, dataflow, PEs, array shape, storage, average bandwidth),
  ``layer_cycles`` and ``network_performance``: the Fig. 14 / Fig. 27
  model, with the reference's arithmetic.

The reference's HLO half (``collective_bytes``, ``roofline_from_compiled``
and ``core/hloparse.py``) reads XLA's HLO text, which has no meaning for a
PyTorch program: it stays in the JAX package only.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List


@dataclasses.dataclass(frozen=True)
class DeviceRates:
    """A device's peak rates: bf16 FLOP/s, device-memory bytes/s, bytes/s
    of one inter-device link, device-memory bytes, and the dispatch cost of
    one kernel launch in seconds."""
    name: str
    peak_flops: float
    hbm_bw: float
    link_bw: float
    hbm_cap: float
    launch_s: float


# the reference's constants (repro.core.eyexam and repro.core.plan's
# KERNEL_LAUNCH_S): a TPU v5e chip
TPU_V5E = DeviceRates("tpu-v5e", peak_flops=197e12, hbm_bw=819e9,
                      link_bw=50e9, hbm_cap=16e9, launch_s=2e-6)
# NVIDIA H100 SXM, data sheet (dense bf16, HBM3, NVLink); launch_s is the
# reference's estimate, not measured on the card
H100_SXM = DeviceRates("h100-sxm", peak_flops=989e12, hbm_bw=3.35e12,
                       link_bw=900e9, hbm_cap=80e9, launch_s=2e-6)
RATES = {r.name: r for r in (H100_SXM, TPU_V5E)}


@dataclasses.dataclass
class Roofline:
    """compute = flops / peak FLOP/s, memory = bytes / memory rate,
    collective = collective bytes / link rate, all per device."""
    flops: float
    hbm_bytes: float
    coll_bytes: float
    per_op_coll: Dict[str, int]
    chips: int
    rates: DeviceRates = H100_SXM

    @property
    def t_compute(self) -> float:
        return self.flops / self.rates.peak_flops

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / self.rates.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / self.rates.link_bw

    @property
    def bound(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_total(self) -> float:
        """Optimistic fully-overlapped step time."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    def fraction_of_roofline(self, useful_flops: float) -> float:
        """useful_flops (per device) / peak over the bound-implied time."""
        if self.t_total <= 0:
            return 0.0
        return (useful_flops / self.t_total) / self.rates.peak_flops

    def summary(self) -> Dict[str, float]:
        return {
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bound": self.bound,
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes,
        }


# =============================================================== seven steps
@dataclasses.dataclass
class AcceleratorModel:
    """Abstract accelerator for the analytical model (paper Fig. 23).

    noc: 'broadcast' (Eyeriss v1: one value/cycle/type from GLB regardless of
    scale) or 'hmnoc' (Eyeriss v2: one value/cycle/type *per cluster*).
    """
    n_pes: int
    array_h: int
    array_w: int
    noc: str = "hmnoc"
    cluster_size: int = 16        # PEs per cluster (v2: 4×4 in §III-D)
    macs_per_pe: int = 1
    spad_weights: int = 192       # max weights resident per PE (§IV)
    glb_bw_words: float = 1.0     # words/cycle/data-type from GLB source

    @property
    def n_clusters(self) -> int:
        return max(self.n_pes // self.cluster_size, 1)


def seven_steps(shape, acc: AcceleratorModel) -> List[Dict]:
    """Performance bound (MACs/cycle) after each Eyexam step for one layer.

    Row-stationary-flavored mapping: spatial dims are (C·R groups) × (M, E·F).
    Returns a list of dicts with the bound after steps 1..6.
    """
    steps = []
    macs = shape.macs
    # Step 1: layer size — all-parallel bound
    b1 = macs
    steps.append({"step": 1, "name": "layer shape", "bound": b1})
    # Step 2: dataflow (RS): parallelism across M·E·F·G·C·R (row-level)
    dataflow_par = shape.G * shape.M * shape.E * shape.F * shape.C * shape.R
    b2 = min(b1, dataflow_par)
    steps.append({"step": 2, "name": "dataflow", "bound": b2})
    # Step 3: finite PEs
    b3 = min(b2, acc.n_pes * acc.macs_per_pe)
    steps.append({"step": 3, "name": "#PEs", "bound": b3})
    # Step 4: physical array shape — fold (G·E·F) onto width, (M·C·R) onto
    # height
    w_par = shape.G * shape.E * shape.F
    h_par = shape.M * shape.C * shape.R
    active_w = min(acc.array_w, w_par)
    active_h = min(acc.array_h, h_par)
    b4 = min(b3, active_w * active_h * acc.macs_per_pe)
    steps.append({"step": 4, "name": "array dims", "bound": b4,
                  "active_pes": active_w * active_h})
    # Step 5: storage — weights resident per PE (paper Table III). Weights
    # past the cap need temporal passes: the bound is unchanged, the
    # utilization is not
    b5 = b4
    steps.append({"step": 5, "name": "storage", "bound": b5})
    # Step 6: average NoC bandwidth
    r = {"weight": macs / max(shape.weight_count, 1),
         "iact": macs / max(shape.iact_count, 1)}
    if acc.noc == "broadcast":
        src_bw = acc.glb_bw_words                   # does NOT scale (v1)
    else:
        src_bw = acc.glb_bw_words * acc.n_clusters  # scales with clusters (v2)
    # deliverable MACs/cycle limited by each data type: bw · reuse
    bw_bound = min(src_bw * r["weight"], src_bw * r["iact"])
    b6 = min(b5, bw_bound)
    steps.append({"step": 6, "name": "NoC bandwidth", "bound": b6})
    return steps


def layer_cycles(shape, acc: AcceleratorModel) -> float:
    """Cycles for one layer under the step-6 bound (the Fig. 14 model)."""
    bound = seven_steps(shape, acc)[-1]["bound"]
    return shape.macs / max(bound, 1e-9)


def network_performance(layers_: List, acc: AcceleratorModel) -> float:
    """End-to-end MACs/cycle over a whole network (batch already in
    shapes)."""
    total_macs = sum(s.macs for s in layers_)
    total_cycles = sum(layer_cycles(s, acc) for s in layers_)
    return total_macs / max(total_cycles, 1e-9)
