"""Command-line launchers and meshes (port of ``repro.launch``): serving,
training, the dry run, and the flow, abstract and runtime meshes."""
