"""Trees, tables and the partition-walk engine."""
