"""Logical-axis sharding for the port (the counterpart of `repro.parallel`):
the rule tables, the thread-local (mesh, rules) context and `shard`."""
