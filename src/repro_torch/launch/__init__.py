"""Command-line launchers and the flow mesh (port of ``repro.launch``):
serving and ``make_flow_mesh`` so far."""
