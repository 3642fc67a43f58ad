"""Parameter declarations and flow-batch sharding (port of the parameter
half and the flow half of ``repro.distributed``)."""
