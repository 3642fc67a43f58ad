"""The multi-device half and the parameter declarations (port of
``repro.distributed``): sharding rules as DTensor placements, the process
group, ``compressed_psum`` and the GPipe pipeline over
``torch.distributed``, and flow-batch sharding."""
