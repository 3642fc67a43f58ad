"""repro_torch.fit -- batched tree induction and batched DSE evaluation
on the device (port of ``repro.fit``).

The training half of SpliDT on the card: a level-synchronous histogram
grower (``hist``: binning -> per-node class histograms -> a Python loop
over depth on a fixed node arena), the k-distinct-feature register
budget (``kbudget``, one host pass a level), and the fleets
(``batched``: whole-partition subtree fleets for
``train_partitioned_dt(trainer="torch")``, and whole-candidate-batch
scoring for ``core.dse.bayes_search``).

The grower's ops are PyTorch tensor ops (a scatter-add, cumulative sums,
argmin, gathers), as the JAX package's are XLA array ops: no Pallas
kernel is behind them.  The fleet walk of :func:`fleet_predict` is the
hop kernel on the card (``csrc/engine_hop.cu``, one launch a hop and
model), its plain version on the CPU.

Structurally identical to the numpy oracle (``core.tree.train_tree``)
node-for-node -- the shared contract (binning, f32 split scores,
tie-breaks, level-order greedy budget) is stated in ``core/tree.py``
and held at zero tolerance by ``tests/test_torch_fit.py``.
"""
from repro_torch.fit.batched import (
    fleet_predict, pack_model_fleet, train_forest, train_tree_torch,
)
from repro_torch.fit.hist import (
    arena_to_tree, grow_arena, grow_forest_arenas,
)
from repro_torch.fit.kbudget import budget_level, distinct_feature_count

__all__ = [
    "arena_to_tree", "budget_level", "distinct_feature_count",
    "fleet_predict", "grow_arena", "grow_forest_arenas",
    "pack_model_fleet", "train_forest", "train_tree_torch",
]
