"""Parameter declarations (port of the parameter half of
``repro.distributed``)."""
