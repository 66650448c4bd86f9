"""The rounds path: one process drives every shard of a round
(mesh.run_mesh), with spec preparation streamed on background threads
(pipeline.PrepPipeline)."""
