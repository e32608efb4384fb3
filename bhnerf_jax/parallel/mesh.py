"""Device-mesh and sharding policies.

The reference's only parallelism is frame-data-parallel jax.pmap with
pmean gradient sync (reference bhnerf/optimization.py:209-216,
network.py:620; SURVEY.md §2.4). The equivalent here is a single
jax.sharding.Mesh with two logical axes:

* 'data' — movie frames (the reference's pmap axis), and
* 'ray'  — image-plane rows (num_alpha), the structural analog of
  sequence parallelism for this workload: rays are embarrassingly
  parallel until the per-pixel reduction / image->visibility matmul,
  where XLA inserts the collective automatically.

Training steps are plain `jit`; sharding propagates from NamedSharding'd
inputs, and gradient all-reduce over replicated params is inserted by the
partitioner (no hand-written collectives).
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def create_mesh(shape=None, axis_names=('data', 'ray'), devices=None):
    """Create a ('data', 'ray') mesh over the available devices.

    shape=None puts every device on the data axis (frame-DP, the
    reference's strategy); pass e.g. (4, 2) to also shard rays.
    """
    devices = jax.devices() if devices is None else devices
    n = len(devices)
    if shape is None:
        shape = (n, 1)
    if int(np.prod(shape)) != n:
        raise ValueError(f'mesh shape {shape} != #devices {n}')
    dev_array = np.asarray(devices).reshape(shape)
    return Mesh(dev_array, axis_names)


def frame_sharding(mesh):
    """Sharding for per-frame batched tensors: leading axis over 'data'."""
    return NamedSharding(mesh, P('data'))


def replicated(mesh):
    return NamedSharding(mesh, P())


def shard_frames(tree, mesh):
    """Place per-frame arrays (leading axis = frames) on the mesh."""
    sh = frame_sharding(mesh)
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, sh), tree)


def replicate(tree, mesh):
    sh = replicated(mesh)
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, sh), tree)


def ray_sharding_spec(ndim, mesh, ray_axis):
    """PartitionSpec sharding array axis `ray_axis` over the 'ray' mesh
    axis, everything else replicated."""
    spec = [None] * ndim
    spec[ray_axis] = 'ray'
    return NamedSharding(mesh, P(*spec))


# ---------------------------------------------------------------------------
# Multi-host support — beyond the reference, whose only parallelism is
# single-host jax.pmap (reference bhnerf/optimization.py:209-216; device
# selection via CUDA_VISIBLE_DEVICES, Fit_ALMA...py:53). Across GPU hosts
# the same ('data', 'ray') mesh spans processes: frames (the gradient-sync
# axis, one small psum of ~67k-param grads per step) ride the slower links
# between hosts, while the chatty 'ray' axis (per-step psum of image-sized
# partials in the sample-parallel shard_map path) stays inside one host on
# NVLink.
# ---------------------------------------------------------------------------


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, **kw):
    """Bootstrap `jax.distributed` for multi-host training.

    Safe to call unconditionally at the top of a fitting script:
    a no-op when the runtime is single-process (no coordinator configured
    and no cluster env detected) or when already initialized. Under a
    cluster manager jax detects (e.g. Slurm) all three arguments may be
    omitted; elsewhere pass them explicitly.

    Returns True if the distributed runtime is (now) initialized.
    """
    import logging
    log = logging.getLogger(__name__)
    if jax.distributed.is_initialized():
        return True
    if coordinator_address is not None:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id, **kw)
        log.info('jax.distributed initialized (explicit coordinator): '
                 'process %d/%d', jax.process_index(), jax.process_count())
        return True
    # No explicit coordinator: let jax's own cluster detectors (Slurm,
    # GKE JobSet, ...) fill in the parameters. When no
    # cluster is detected initialize() raises ValueError
    # ("coordinator_address should be defined") — the single-process case.
    try:
        jax.distributed.initialize(num_processes=num_processes,
                                   process_id=process_id, **kw)
    except ValueError as e:
        # ONLY the no-cluster-detected signature may fall back silently;
        # argument-validation errors (process_id/num_processes
        # mismatches) are real misconfigurations and must propagate.
        if 'coordinator_address should be defined' not in str(e):
            raise
        log.info('jax.distributed not initialized: no cluster detected '
                 '(single-process run)')
        return False
    except RuntimeError as e:
        # The XLA backend is already initialized (jax.devices() etc. was
        # called first) — too late for initialize() to run detection. If
        # the environment still looks like a cluster, refuse to fall back
        # silently; otherwise this is an ordinary single-process run.
        # Anything else under RuntimeError — notably JaxRuntimeError
        # coordinator-connection failures (grpc deadline exceeded) on a
        # REAL cluster — must propagate, not degrade into N independent
        # single-process runs.
        if 'must be called before' not in str(e):
            raise
        import os
        cluster_env = any(os.environ.get(k) for k in (
            'JAX_COORDINATOR_ADDRESS', 'COORDINATOR_ADDRESS'))
        if cluster_env:
            raise RuntimeError(
                'initialize_distributed() was called after the XLA '
                'backend was initialized, but the environment indicates '
                'a multi-host cluster. Call initialize_distributed() '
                'before any other JAX API (jax.devices, device_put, ...).')
        log.info('jax.distributed not initialized: XLA backend already '
                 'up, no cluster env detected (single-process run)')
        return False
    log.info('jax.distributed initialized (cluster auto-detected): '
             'process %d/%d', jax.process_index(), jax.process_count())
    return True


def _process_count(devices):
    """Number of distinct processes (hosts) owning `devices`."""
    return max(len({d.process_index for d in devices}), 1)


def create_hybrid_mesh(local_shape=None, axis_names=('data', 'ray'),
                       devices=None):
    """('data', 'ray') mesh spanning one or more GPU hosts.

    Single process (the common case, incl. the virtual CPU mesh):
    identical to `create_mesh(local_shape)`. Several processes: each
    process (host) is one granule and the process axis folds into 'data'
    — `mesh_utils.create_hybrid_device_mesh(process_is_granule=True)`
    orders devices so 'ray' stays inside one host on NVLink while the
    leading 'data' axis crosses hosts, which is the right layout for this
    workload (per-step 'ray' collective = image-sized psum every
    dispatch; 'data' collective = one grad psum).

    local_shape is the per-process (data, ray) factorization; None puts
    every local device on 'data' (frame-DP).
    """
    devices = jax.devices() if devices is None else devices
    n_proc = _process_count(devices)
    if n_proc == 1:
        return create_mesh(local_shape, axis_names, devices)
    per_proc = len(devices) // n_proc
    if local_shape is None:
        local_shape = (per_proc, 1)
    if int(np.prod(local_shape)) != per_proc:
        raise ValueError(f'local_shape {local_shape} != devices/process '
                         f'{per_proc}')
    from jax.experimental import mesh_utils
    dev_array = mesh_utils.create_hybrid_device_mesh(
        local_shape, dcn_mesh_shape=(n_proc, 1), devices=devices,
        process_is_granule=True)
    return Mesh(dev_array, axis_names)


def make_global_frames(tree, mesh):
    """Multi-host-safe variant of `shard_frames`.

    Each process passes its PROCESS-LOCAL span of the frame axis (frames
    whose global shard lands on this host's devices, in mesh order);
    returns fully-addressable global jax.Arrays sharded P('data').
    Single-process meshes accept the full array and reduce exactly to
    `shard_frames` (tested equal), so scripts can use this
    unconditionally.
    """
    sh = frame_sharding(mesh)
    # Gate on the process count, not a device-count coincidence: a
    # multi-host mesh over a device subset equal in size to this host's
    # local device count must still take the process-local assembly path
    # (device_put onto non-addressable devices would fail).
    if jax.process_count() == 1:
        return shard_frames(tree, mesh)
    return jax.tree_util.tree_map(
        lambda x: jax.make_array_from_process_local_data(sh, np.asarray(x)),
        tree)


