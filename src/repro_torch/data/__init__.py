"""Token data for LM training (port of ``repro.data``)."""
