"""Reference-API compatibility facade for the training-orchestration layer.

Mirrors `bhnerf.optimization` (reference bhnerf/optimization.py);
implementations live in `bhnerf_jax.train`.
"""
from bhnerf_jax.train.logging import SummaryWriter, StepTimer, profile_trace
from bhnerf_jax.train.optimizer import (LogFn, Optimizer,
                                        TemporalBatchedArgs, TrainStep,
                                        total_movie_loss)
from bhnerf_jax.parallel.mesh import shard_frames


def shard(xs, mesh=None):
    """Reference-signature shard (optimization.py:360-362): reshape each
    array's leading dim to (device_count, -1, ...). With a mesh, places
    via NamedSharding instead (the mesh path, shard_frames)."""
    if mesh is not None:
        return shard_frames(xs, mesh)
    import jax
    import numpy as np
    n = jax.local_device_count()
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x).reshape((n, -1) + np.shape(x)[1:]), xs)
