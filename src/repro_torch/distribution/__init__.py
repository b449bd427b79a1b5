"""Distribution of the port (counterpart of ``repro.distribution``; only
the simulator's replication split, :mod:`.sim_shard`, is ported)."""
