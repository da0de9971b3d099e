"""Device meshes, sharded pipeline steps and multi-process runs (torch)."""
