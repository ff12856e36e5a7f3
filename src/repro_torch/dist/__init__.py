"""Distribution layer: mesh context, sharding rules, collectives, search.

Submodules (imported explicitly; keep this package root import-light):

  ctx          ambient mesh context + activation sharding constraints
  sharding     DTensor placements for param/data/cache trees
  search_shard distributed IDList keyword search (model-axis segmented lists)
  collectives  gradient compression for cross-host reduction
"""
