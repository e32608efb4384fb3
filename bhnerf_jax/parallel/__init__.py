from bhnerf_jax.parallel.mesh import (create_hybrid_mesh, create_mesh,
                                      frame_sharding, initialize_distributed,
                                      make_global_frames, ray_sharding_spec,
                                      replicate, replicated, shard_frames)
