"""Design-space exploration on the PyTorch/CUDA port (paper §3.2.1, Fig.
5-7): Bayesian-optimisation search over (k, partition sizes) producing
the F1-vs-flows Pareto frontier for a flow target.

    PYTHONPATH=src python examples/splidt_dse_torch.py [--iterations 10]
    PYTHONPATH=src python examples/splidt_dse_torch.py --device cpu

The windows come from the feature kernel on the card; each proposal
batch is trained by the ``torch`` trainer there (the host trainer on the
CPU: the same trees) and scored in one ``fleet_predict`` walk on the hop
kernel.  The printed search is ``examples/splidt_dse.py``'s.
``--device`` defaults to the card; without one it raises.
"""
import argparse

from repro_torch.core.dse import SearchSpace, bayes_search, make_splidt_evaluator
from repro_torch.device import resolve_device
from repro_torch.flows.synthetic import make_dataset
from repro_torch.flows.windows import window_features, window_packets


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="d1")
    ap.add_argument("--flows", type=int, default=500_000)
    ap.add_argument("--iterations", type=int, default=8)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    # the grower on the card; on the CPU the host trainer (the same trees,
    # faster there than the tensor grower)
    trainer = "torch" if dev.type == "cuda" else "numpy"

    ds = make_dataset(args.dataset, n_flows=3000)
    tr, te = ds.split()
    P = 5
    Xw_tr = window_features(tr, P, device=dev)
    Xw_te = window_features(te, P, device=dev)
    ev = make_splidt_evaluator(Xw_tr, tr.labels, Xw_te, te.labels,
                               n_classes=ds.n_classes, flows=args.flows,
                               trainer=trainer,
                               win_pkts_te=window_packets(te, P), device=dev)
    res = bayes_search(
        ev, SearchSpace(max_partitions=P, k_max=6, depth_max=8),
        n_iterations=args.iterations, batch=4, n_init=8, seed=0)

    print(f"\n=== BO search on {args.dataset} @ {args.flows:,} flows "
          f"({len(res.history)} evaluations) ===")
    print(f"best feasible: F1={res.best.f1:.3f} cfg={res.best.config} "
          f"(found at evaluation {res.iterations_to_best})")
    print("\nPareto frontier (F1 vs flow capacity):")
    for e in res.pareto():
        print(f"  F1={e.f1:.3f} capacity={e.flow_capacity:>9,} "
              f"k={e.config.k} partitions={e.config.partition_sizes} "
              f"feats={e.unique_features} tcam={e.tcam_entries} "
              f"recirc={e.recirc_mbps:.1f}Mbps")
    return {"device": str(dev), "evaluations": len(res.history),
            "best_f1": res.best.f1, "best_config": res.best.config,
            "iterations_to_best": res.iterations_to_best,
            "pareto": [(e.f1, e.flow_capacity, e.config)
                       for e in res.pareto()],
            "history": res.history}


if __name__ == "__main__":
    main()
