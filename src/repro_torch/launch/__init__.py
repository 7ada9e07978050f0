"""Step functions, the batched server, the trainer, meshes, the sharding
plan and the dry-run (port of ``repro.launch``)."""
