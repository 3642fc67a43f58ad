"""The system under test, and all the benchmark takes from it: the
port's ``Engine`` over the configuration's model, its ``EngineOptions``
and its ``obs`` spans.  Nothing else here imports the program."""
from __future__ import annotations

import numpy as np

from .ref.trainer import Model
from .ref.windows import N_FEATURES


def engine(model: Model, device):
    """``Engine.from_model`` of the model, handed over as the port's
    ``PartitionedDT``."""
    from repro_torch.core.inference import Engine
    from repro_torch.core.partition import PartitionedDT, SubTree
    from repro_torch.core.tree import Tree
    subtrees = []
    for sid, st in enumerate(model.subtrees):
        t = st.tree
        tree = Tree(feature=t.feature.copy(), threshold=t.threshold.copy(),
                    left=t.left.copy(), right=t.right.copy(),
                    value=t.value.copy(), n_classes=model.n_classes)
        leaves = [int(i) for i in np.nonzero(t.feature < 0)[0]]
        subtrees.append(SubTree(
            sid=sid, partition=st.partition, tree=tree,
            leaf_next_sid={i: int(st.next_sid[i]) for i in leaves},
            leaf_label={i: int(t.value[i].argmax()) for i in leaves}))
    pdt = PartitionedDT(subtrees=subtrees,
                        partition_sizes=list(model.partition_sizes),
                        k=model.k, n_classes=model.n_classes,
                        n_features=N_FEATURES)
    return Engine.from_model(pdt, device=device)


def options(traffic: dict):
    from repro_torch.core.inference import EngineOptions
    return EngineOptions(**traffic.get("options", {}))


def set_spans(on: bool) -> None:
    """The program's own spans (``SPLIDT_OBS``): off in a timed run, on in
    a traced one; the recorded spans start empty."""
    from repro_torch import obs
    obs.set_enabled(on)
    obs.reset_spans()


def span_totals() -> dict:
    from repro_torch import obs
    return obs.span_totals()
