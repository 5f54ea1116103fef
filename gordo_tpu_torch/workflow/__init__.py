"""Config normalization: a project config's globals merged into its
machines, and the machine shard a fleet build reads."""
