"""The dry run's analysis (port of ``repro.analysis``): the memory budget,
the roofline terms with the port's own op counts, and the report tables."""
