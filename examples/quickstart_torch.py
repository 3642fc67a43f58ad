"""Quickstart on the PyTorch/CUDA port: the complete SpliDT pipeline in
one script.

    PYTHONPATH=src python examples/quickstart_torch.py                # the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu   # the CPU

Synthetic flows -> windowed features (the feature kernel on the card)
-> Algorithm-1 partitioned training -> range-marking rules -> the
data-plane engine (one hop-kernel launch a partition on the card; the
plain PyTorch walk with ``--device cpu``) -> resource and recirculation
reports.  The numbers printed are those of ``examples/quickstart.py``.
``--device`` defaults to the card; without one it raises.
"""
import argparse

from repro_torch.core.inference import Engine
from repro_torch.core.partition import train_partitioned_dt
from repro_torch.core.recirc import HADOOP, WEBSERVER, recirc_bandwidth
from repro_torch.core.resources import estimate
from repro_torch.core.tree import macro_f1
from repro_torch.device import resolve_device
from repro_torch.flows.synthetic import make_dataset
from repro_torch.flows.windows import window_features, window_packets


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print("=== SpliDT quickstart ===")
    ds = make_dataset("d2", n_flows=3000)
    train, test = ds.split()
    P, K = 3, 4
    print(f"dataset: {ds.name}, {ds.n_flows} flows, {ds.n_classes} classes; "
          f"partitions={P}, k={K} feature registers/flow")

    Xw = window_features(train, P, device=dev)
    pdt = train_partitioned_dt(Xw, train.labels,
                               partition_sizes=[3, 3, 3], k=K)
    per_part, per_sub = pdt.feature_density()
    print(f"trained {len(pdt.subtrees)} subtrees, total depth "
          f"{pdt.total_depth}; unique features "
          f"{len(pdt.unique_features())} (vs k={K} registers); "
          f"density/subtree {per_sub:.1f}%")

    # the data-plane engine, on the device's own route
    wp = window_packets(test, P)
    res = Engine.from_model(pdt, device=dev).run(wp)
    f1 = macro_f1(test.labels, res.labels, ds.n_classes)
    print(f"engine F1 = {f1:.3f}; mean recirculations/flow = "
          f"{res.recircs.mean():.2f}")

    rep = estimate(pdt, flows=500_000)
    print(f"resources: {rep.tcam_entries} TCAM entries "
          f"({rep.tcam_bits / 1e6:.2f} Mb), "
          f"{rep.register_bits_per_flow} register bits/flow, "
          f"capacity {rep.flow_capacity:,} flows, "
          f"feasible@500K={rep.feasible}")
    recirc = {}
    for env in (WEBSERVER, HADOOP):
        bw = recirc_bandwidth(res.recircs, 1_000_000, env)
        recirc[env.name] = bw.fraction_of_budget
        print(f"recirculation @1M flows [{env.name}]: "
              f"{bw.mean_mbps:.1f} Mbps "
              f"({bw.fraction_of_budget * 100:.4f}% of the 100G path)")
    return {"device": str(dev), "n_subtrees": len(pdt.subtrees),
            "total_depth": pdt.total_depth,
            "unique_features": len(pdt.unique_features()),
            "density_per_partition": per_part,
            "density_per_subtree": per_sub, "f1": f1,
            "mean_recircs": float(res.recircs.mean()),
            "tcam_entries": rep.tcam_entries, "feasible": rep.feasible,
            "recirc_fraction": recirc, "pdt": pdt, "test": test,
            "windows": wp,
            "labels": res.labels, "recircs": res.recircs,
            "exit_partition": res.exit_partition}


if __name__ == "__main__":
    main()
