"""Distribution of the port (counterpart of ``repro.distribution``): the
logical-axis sharding context on DTensor (:mod:`.sharding`) and the
simulator's replication split (:mod:`.sim_shard`)."""
