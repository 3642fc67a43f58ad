"""Command-line launchers and the flow mesh (port of ``repro.launch``):
serving, training and ``make_flow_mesh`` so far."""
