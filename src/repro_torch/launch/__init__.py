"""Step functions and the batched server on one card (port of
``repro.launch``; the mesh, sharding and training parts are later
slices)."""
