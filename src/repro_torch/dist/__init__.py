"""Distribution layer: distributed search (and, later, mesh context,
sharding rules and collectives).

Submodules (imported explicitly; keep this package root import-light):

  search_shard distributed IDList keyword search (model-axis segmented lists)

Not ported yet (they shard model activations, parameters and gradients, and
come with the training slice):

  ctx          ambient mesh context + activation sharding constraints
  sharding     PartitionSpec rules for param/data/cache trees
  collectives  gradient compression for cross-host reduction
"""
