"""Command-line launchers (port of ``repro.launch``): serving so far."""
