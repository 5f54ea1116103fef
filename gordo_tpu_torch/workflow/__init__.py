"""The deploy's config half: a project config's globals merged into its
machines, the machine shard a fleet build reads, and ``workflow
generate``'s template, slice geometry and manifest validation."""
