"""Analytical hardware resource model + feasibility testing (paper §3.2.1;
a copy of ``repro.core.resources``).

Target-specific constants model a Tofino1-class switch (Table 3 caption:
6.4 Mbit TCAM, 12 stages).  Constants are calibrated so that the paper's
anchor points hold: with 32-bit features, a k=4 one-shot model supports
~100K flows and k=6 ~65K (paper footnote 1); SpliDT reaches 1M flows
with small k / few partitions.

The model answers two questions for a candidate (model, target):
  * ``capacity``: max concurrent flows supportable, and
  * ``feasible(flows)``: does the design fit TCAM / stages / registers /
    recirculation bandwidth at the requested flow count.
"""
from __future__ import annotations

import dataclasses


from repro_torch.core.partition import EXIT, PartitionedDT
from repro_torch.core.rangemark import SubtreeRules, build_subtree_rules


@dataclasses.dataclass(frozen=True)
class Target:
    """Switch/SmartNIC resource envelope.

    ``reg_bits_per_stage`` ~ Tofino1's 80 x 128 Kb SRAM blocks per stage;
    §2.1's anchor ("four registers per flow exhausts a stage at 65K
    flows": 4 x 65K x 32b = 8.3 Mb) lands in the same range.
    """
    name: str = "tofino1"
    n_stages: int = 12
    tcam_bits: float = 6.4e6
    reg_bits_per_stage: float = 12.0e6
    recirc_gbps: float = 100.0
    sid_bits: int = 8
    counter_bits: int = 16
    dep_reg_bits: int = 32
    # fixed pipeline overhead for SpliDT: parser/hash + operator-selection
    # MATs + range-mark tables + model table + bookkeeping.  CONSTANT in
    # total tree depth: the same SID-keyed MATs serve every partition via
    # recirculation -- the paper's architectural win (§2.3).
    logic_stages: int = 4
    # one-shot baselines chain depth-ordered MATs spatially; ~4 tree
    # levels of range-marked matching fit one stage
    levels_per_stage: int = 4


TOFINO1 = Target()
PENSANDO = Target(name="pensando-dpu", n_stages=8, tcam_bits=4.0e6,
                  reg_bits_per_stage=5.5e6, recirc_gbps=50.0)


@dataclasses.dataclass
class ResourceReport:
    tcam_entries: int
    tcam_bits: float
    register_bits_per_flow: int
    stages_logic: int
    stages_register: int
    flow_capacity: int
    recirc_mbps: float
    feasible: bool
    reasons: list[str]


def model_rules(pdt: PartitionedDT, *, bits: int = 32,
                feature_ranges: dict[int, tuple[float, float]] | None = None,
                ) -> list[SubtreeRules]:
    """Range-marking rules for every subtree (class actions offset by the
    subtree count so exits and transitions share one action space)."""
    S = len(pdt.subtrees)
    rules = []
    for st in pdt.subtrees:
        action = {}
        for leaf, nxt in st.leaf_next_sid.items():
            if nxt == EXIT:
                action[leaf] = S + st.leaf_label[leaf]   # class actions
            else:
                action[leaf] = nxt                       # transition actions
        rules.append(build_subtree_rules(
            st.tree, action, bits=bits, feature_ranges=feature_ranges))
    return rules


def estimate(
    pdt: PartitionedDT,
    *,
    target: Target = TOFINO1,
    bits: int = 32,
    flows: int | None = None,
    recirc_mbps: float = 0.0,
    rules: list[SubtreeRules] | None = None,
    feature_ranges: dict[int, tuple[float, float]] | None = None,
) -> ResourceReport:
    """Resource usage + feasibility for a partitioned DT (paper §3.2.1)."""
    if rules is None:
        rules = model_rules(pdt, bits=bits, feature_ranges=feature_ranges)
    tcam_entries = int(sum(r.total_entries for r in rules))
    # feature-table entries match a register value (bits wide) + SID;
    # model-table entries match SID + range marks
    tcam_bits = float(sum(
        r.feature_entries * (bits + target.sid_bits) + r.model_entries * r.key_bits
        for r in rules))

    dep = pdt.dep_depth()
    # dependency-chain registers store intermediate values at the same
    # precision as the features (paper Fig. 12: 16/8-bit models support
    # ~2x/4x the flows -- total per-flow state scales with feature width)
    reg_bits = (pdt.k * bits + target.sid_bits + target.counter_bits
                + dep * min(target.dep_reg_bits, bits))
    stages_logic = target.logic_stages + dep
    stages_register = max(target.n_stages - stages_logic, 0)
    capacity = int(stages_register * target.reg_bits_per_stage // max(reg_bits, 1))

    reasons = []
    if tcam_bits > target.tcam_bits:
        reasons.append(f"TCAM {tcam_bits / 1e6:.2f}Mb > {target.tcam_bits / 1e6:.1f}Mb")
    if stages_register <= 0:
        reasons.append("no stages left for registers")
    if flows is not None and capacity < flows:
        reasons.append(f"capacity {capacity} < target flows {flows}")
    if recirc_mbps > target.recirc_gbps * 1e3:
        reasons.append("recirculation exceeds budget")
    return ResourceReport(
        tcam_entries=tcam_entries, tcam_bits=tcam_bits,
        register_bits_per_flow=int(reg_bits), stages_logic=stages_logic,
        stages_register=stages_register, flow_capacity=capacity,
        recirc_mbps=recirc_mbps, feasible=not reasons, reasons=reasons,
    )


def estimate_oneshot(
    n_features_used: int,
    tcam_entries: int,
    key_bits: int,
    *,
    target: Target = TOFINO1,
    bits: int = 32,
    dep_depth: int = 2,
    depth: int = 8,
    flows: int | None = None,
) -> ResourceReport:
    """Resource model for one-shot top-k baselines (NetBeacon/Leo style).

    All ``n_features_used`` stateful features must be resident for the
    whole flow (no SID register, no recirculation), and the single-pass
    DT consumes pipeline stages proportional to its depth -- the spatial
    execution model SpliDT's time-sharing removes.
    """
    reg_bits = (n_features_used * bits + target.counter_bits
                + dep_depth * target.dep_reg_bits)
    stages_model = -(-int(depth) // target.levels_per_stage)
    stages_logic = 3 + dep_depth + stages_model
    stages_register = max(target.n_stages - stages_logic, 0)
    capacity = int(stages_register * target.reg_bits_per_stage // max(reg_bits, 1))
    tcam_bits = float(tcam_entries * (bits + key_bits))
    reasons = []
    if tcam_bits > target.tcam_bits:
        reasons.append("TCAM over budget")
    if flows is not None and capacity < flows:
        reasons.append(f"capacity {capacity} < target flows {flows}")
    return ResourceReport(
        tcam_entries=tcam_entries, tcam_bits=tcam_bits,
        register_bits_per_flow=int(reg_bits), stages_logic=stages_logic,
        stages_register=stages_register, flow_capacity=capacity,
        recirc_mbps=0.0, feasible=not reasons, reasons=reasons,
    )
