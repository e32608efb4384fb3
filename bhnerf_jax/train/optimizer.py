"""Training orchestration: Optimizer loop, TrainStep containers, batching.

Rebuild of reference bhnerf/optimization.py:1-363. The pmap/shard plumbing
of the reference (optimization.py:209-216, 360-362) is replaced by a
jax.sharding.Mesh: `TemporalBatchedArgs` places sampled frame batches with
a 'data'-axis NamedSharding and the jitted steps parallelize from there.
"""
from __future__ import annotations

import numpy as np
import jax

from bhnerf_jax import units
from bhnerf_jax.parallel import mesh as mesh_lib
from bhnerf_jax.train import state as state_lib
from bhnerf_jax.train import step as step_lib


def total_movie_loss(batchsize, state, train_step, raytracing_args,
                     return_frames=False):
    """Aggregate test loss over all movie frames in batchsize chunks
    (reference optimization.py:14-66)."""
    nt = train_step.args[0].num_frames
    nt_tilde = nt - nt % batchsize
    indices = list(np.array_split(np.arange(0, nt_tilde),
                                  max(nt_tilde // batchsize, 1)))
    if nt_tilde < nt:
        # evaluate the tail with its exact frame set: a wrap-padded chunk
        # would need a per-frame loss correction that is only valid when
        # all frames contribute equally (one extra jit shape, cached)
        indices.append(np.arange(nt_tilde, nt))

    frames, total_loss = [], 0.0
    for inds in indices:
        if inds.size == 0:
            continue
        loss, _, images = train_step(state, raytracing_args, inds,
                                     update_state=False)
        total_loss += float(np.sum(np.asarray(loss)))
        if return_frames:
            frames.append(np.asarray(images))

    output = total_loss / nt
    if return_frames:
        output = (output, np.concatenate(frames)[:nt])
    return output


class _GracefulShutdown:
    """SIGTERM-aware scope: preempted workers get a SIGTERM + grace
    period; the training loops poll `requested` at step/chunk boundaries
    and checkpoint-and-return instead of dying mid-step. The reference
    only catches KeyboardInterrupt (optimization.py:138-139). No-op when
    not on the main thread (signal registration would raise)."""

    def __init__(self):
        self.requested = False
        self._prev = None
        self._registered = False

    def __enter__(self):
        import signal

        def handler(signum, frame):
            self.requested = True

        try:
            # _prev may legitimately be None (handler installed outside
            # Python, which signal.signal CANNOT restore — passing None
            # back raises TypeError); _registered, not _prev, records
            # whether our handler was installed and must be removed.
            self._prev = signal.signal(signal.SIGTERM, handler)
            self._registered = True
        except ValueError:      # not the main thread
            self._registered = False
        return self

    def __exit__(self, *exc):
        import signal
        if self._registered:
            # A None _prev (non-Python handler) is unrestorable; fall
            # back to SIG_DFL so later SIGTERMs still terminate the
            # process instead of being swallowed by our stale flag-setter.
            signal.signal(signal.SIGTERM,
                          self._prev if self._prev is not None
                          else signal.SIG_DFL)
        return False


class Optimizer:
    """Gradient-descent driver (reference optimization.py:68-143)."""

    def __init__(self, hparams, predictor, raytracing_args, save_period=-1,
                 checkpoint_dir='', keep=5):
        self.step = 0
        self.init_step = 0
        self.num_iters = hparams['num_iters']
        self.checkpoint_dir = checkpoint_dir
        self.save_period = self.num_iters if save_period < 0 else save_period
        self.loss = np.inf
        self.keep = keep
        self.seed = hparams.get('seed', 1)
        self.predictor = predictor

        params = predictor.init_params(seed=self.seed)
        tx = state_lib.make_optimizer(
            num_iters=self.num_iters,
            lr_init=hparams.get('lr_init', 1e-4),
            lr_final=hparams.get('lr_final', 1e-6),
            lr_inject=hparams.get('lr_inject', None))
        self.state = state_lib.TrainState.create(params, tx)
        if checkpoint_dir:
            self.state = state_lib.restore_checkpoint(checkpoint_dir,
                                                      self.state)
            predictor.save_params(checkpoint_dir)

    def log(self):
        for log_fn in self.log_fns:
            log_fn(self)

    def save_checkpoint(self, force=False):
        if self.checkpoint_dir and (
                force or self.step % self.save_period == 0
                or self.step == self.final_step - 1):
            state_lib.save_checkpoint(self.checkpoint_dir, self.state,
                                      int(self.step), keep=self.keep)

    def run(self, batchsize, train_step, raytracing_args, log_fns=(),
            verbose=True, nan_check_period=1000, scan_chunk=0):
        """Training loop (reference optimization.py:123-139), plus a
        periodic non-finite-loss guard (the reference trains blindly
        through NaNs; checking every step would force a host sync).
        SIGTERM (preemption) checkpoints the current step and
        returns cleanly; a rerun resumes from it via restore_checkpoint.

        scan_chunk > 0 runs up to `scan_chunk` steps per dispatch via
        lax.scan (step.make_scan_step, or make_composed_scan_step for
        `+`-composed multi-loss steps; sub-pixel-ray ensembles ride
        along via in-scan variant draws; mesh or not — the jitted scan
        propagates input shardings): removes the per-step dispatch
        round-trip. Chunk boundaries align to
        every save_period / LogFn.log_period multiple, so checkpoints
        and log callbacks fire at exactly the steps the per-step loop
        would have. Frame batches are sampled with jax PRNG (seeded by
        hparams['seed'] folded with the starting step); the non-finite
        guard checks each chunk's final loss.
        """
        self.init_step = int(np.asarray(jax.device_get(self.state.step))) + 1
        self.final_step = self.init_step + self.num_iters
        self.log_fns = np.atleast_1d(log_fns) if log_fns else []
        self.train_step = train_step
        self.raytracing_args = raytracing_args

        rt_list = np.atleast_1d(raytracing_args)
        scannable = bool(scan_chunk) and train_step.scan_metas is not None
        if scannable and len(rt_list) > 1:
            # sub-pixel-ray ensembles ride the scan path too: stack the
            # variants and let the scan body draw one per step
            try:
                rt_scan = step_lib.stack_ensemble(list(rt_list))
            except ValueError as e:
                import warnings
                warnings.warn(
                    f'ensemble not scannable ({e}); falling back to the '
                    f'per-step loop')
                scannable = False
        elif scannable:
            rt_scan = rt_list[0]
        if scannable:
            return self._run_scan(batchsize, train_step, rt_scan,
                                  scan_chunk, verbose,
                                  num_variants=len(rt_list))

        iterator = range(self.init_step, self.final_step)
        if verbose:
            from tqdm.auto import tqdm
            iterator = tqdm(iterator, desc='iteration')
        try:
            with _GracefulShutdown() as shutdown:
                for self.step in iterator:
                    batch = train_step.args[0].sample(batchsize)
                    self.loss, self.state, images = train_step(
                        self.state, raytracing_args, indices=batch)
                    if (nan_check_period and
                            self.step % nan_check_period == 0 and
                            not np.isfinite(np.asarray(self.loss)).all()):
                        import warnings
                        warnings.warn(
                            f'non-finite loss at step {self.step}; stopping '
                            f'(last checkpoint is recoverable)')
                        return
                    self.log()
                    self.save_checkpoint()
                    if shutdown.requested:
                        # preemption (SIGTERM): persist progress and end
                        # the run cleanly; restore_checkpoint resumes it
                        self.save_checkpoint(force=True)
                        return
        except KeyboardInterrupt:
            return

    def _run_scan(self, batchsize, train_step, rt, scan_chunk, verbose,
                  num_variants=1):
        rt_mesh = getattr(rt, 'mesh', None)
        for args in train_step.args:
            if rt_mesh is not None and args.mesh is None:
                args.ensure_placed(rt_mesh)
        # python float, not np.float64: a weak-typed scalar matches any
        # pre-compiled executable; an f64 scalar forces a fresh compile
        scale = float(train_step.scale[0])
        # fold the starting step into the key so a resumed/extended run
        # draws fresh frame batches instead of replaying the first run's
        key = jax.random.fold_in(jax.random.PRNGKey(self.seed),
                                 self.init_step)
        step = self.init_step - 1
        # Per-step scalar LogFns (log_period == 1, the LogFn default —
        # e.g. the train-loss tensorboard scalar every fit script
        # installs) must NOT enter the boundary alignment below: a
        # period of 1 clamps every chunk to ONE step, silently restoring
        # the per-step dispatch cadence scan chunking exists to remove. The
        # scan body already returns every step's loss, so these are
        # replayed host-side from each chunk's loss vector instead —
        # identical (step, loss) series, one dispatch per chunk. They
        # observe END-OF-CHUNK params/opt-state, which pure scalar-loss
        # loggers never read; param-reading callbacks should use
        # log_period > 1 (boundary-aligned, exact params at their step).
        per_step_fns = [f for f in self.log_fns
                        if getattr(f, 'log_period', None) == 1]
        chunk_fns = [f for f in self.log_fns if f not in per_step_fns]
        # chunk boundaries align to every save/log period so modulo-gated
        # checkpoints and LogFns fire exactly as in the per-step loop
        # (distinct chunk sizes are few and lru-cached)
        periods = [int(f.log_period) for f in chunk_fns
                   if getattr(f, 'log_period', 0) and f.log_period > 0]
        if self.checkpoint_dir:  # save gate is moot without a directory
            periods.append(self.save_period)
        periods = [p for p in periods if p > 0]

        def next_boundary(s):
            bounds = [(s // p + 1) * p for p in periods]
            return min(bounds) if bounds else self.final_step - 1

        pbar = None
        if verbose:
            from tqdm.auto import tqdm
            pbar = tqdm(total=self.num_iters, desc='iteration')
        try:
            with _GracefulShutdown() as shutdown:
                self._scan_loop(shutdown, batchsize, train_step, rt,
                                scan_chunk, num_variants, scale, key,
                                step, next_boundary, pbar,
                                per_step_fns, chunk_fns)
        except KeyboardInterrupt:
            return
        finally:
            if pbar is not None:
                pbar.close()

    def _scan_loop(self, shutdown, batchsize, train_step, rt, scan_chunk,
                   num_variants, scale, key, step, next_boundary, pbar,
                   per_step_fns=(), chunk_fns=None):
        if chunk_fns is None:
            chunk_fns = self.log_fns
        while step < self.final_step - 1:
            chunk = min(scan_chunk, self.final_step - 1 - step,
                        next_boundary(step) - step)
            key, sub = jax.random.split(key)
            if train_step.num_losses == 1:
                scan_fn = step_lib.make_scan_step(
                    batchsize=batchsize, chunk=int(chunk),
                    num_variants=num_variants, **train_step.scan_meta)
                self.state, losses = scan_fn(
                    self.state, *train_step.args[0].device_args,
                    sub, rt, scale)
            else:
                scan_fn = step_lib.make_composed_scan_step(
                    batchsize=batchsize, chunk=int(chunk),
                    num_variants=num_variants,
                    metas=tuple(tuple(sorted(m.items()))
                                for m in train_step.scan_metas),
                    scales=tuple(float(s) for s in train_step.scale))
                flat = [t for a in train_step.args
                        for t in a.device_args]
                self.state, losses = scan_fn(self.state, *flat, sub,
                                             rt)
            step += chunk
            self.step = step
            self.loss = losses[-1]
            if not np.isfinite(np.asarray(self.loss)).all():
                import warnings
                warnings.warn(
                    f'non-finite loss at step {self.step}; stopping '
                    f'(last checkpoint is recoverable)')
                return
            if pbar is not None:
                pbar.update(int(chunk))
            if per_step_fns:
                # replay the chunk's exact per-step loss series for
                # log_period==1 callbacks (see _run_scan)
                losses_np = np.asarray(losses)
                for i in range(int(chunk)):
                    self.step = step - int(chunk) + i + 1
                    self.loss = losses_np[i]
                    for f in per_step_fns:
                        f(self)
                self.step = step
                self.loss = losses_np[-1]
            for f in chunk_fns:
                f(self)
            self.save_checkpoint()
            if shutdown.requested:
                # preemption (SIGTERM): persist progress and end the run
                # cleanly; restore_checkpoint resumes it
                self.save_checkpoint(force=True)
                return

    @property
    def params(self):
        return jax.device_get(self.state.params)


class TrainStep:
    """Composable container of (dtype, args, grad/test fns, scale)
    (reference optimization.py:145-268)."""

    def __init__(self, dtype, args, grad_fn, test_fn, scale,
                 scan_meta=None):
        self.dtype = list(np.atleast_1d(dtype))
        self.args = list(np.atleast_1d(args))
        self.grad_fn = list(np.atleast_1d(grad_fn))
        self.test_fn = list(np.atleast_1d(test_fn))
        self.scale = list(np.atleast_1d(scale))
        # per-loss kwargs for step.make_scan_step /
        # make_composed_scan_step (chunked lax.scan training); None
        # disables the scan path (falls back to the per-step loop)
        if isinstance(scan_meta, dict):
            scan_meta = [scan_meta]
        self.scan_metas = list(scan_meta) if scan_meta is not None \
            else None
        if any(arg.t_units != units.hr for arg in self.args):
            raise ValueError('only hr units supported')
        sizes = {len(self.dtype), len(self.args), len(self.grad_fn),
                 len(self.test_fn), len(self.scale)}
        assert sizes == {len(self.dtype)}, 'input list sizes are not equal'
        self.num_losses = len(self.dtype)
        if len({a.num_frames for a in self.args}) > 1:
            # batch indices are shared across losses (reference
            # optimization.py:176 indexes every args[i] with one draw),
            # so differing frame counts would index out of bounds —
            # silently (clamped) under jit. Refuse loudly instead.
            raise ValueError(
                'composed losses must share the frame count: got '
                f'{[a.num_frames for a in self.args]} frames per loss '
                '(frame-batch indices are drawn once per step and '
                'applied to every loss)')

    def __call__(self, state, raytracing_args, indices, update_state=True):
        total_loss, total_images = 0.0, 0.0
        raytracing_args = np.atleast_1d(raytracing_args)
        if update_state:
            fns = self.grad_fn
            # stochastic sub-pixel-ray ensemble selection (reference
            # optimization.py:167-169)
            raytracing_args = [
                raytracing_args[np.random.choice(len(raytracing_args))]]
        else:
            fns = self.test_fn

        for rt in raytracing_args:
            # a raw numpy argument forces the pjit SLOW dispatch path
            # when the executable carries mesh shardings (sample-
            # parallel crt), a large per-step host overhead. Commit the
            # indices on the mesh.
            rt_mesh = getattr(rt, 'mesh', None)
            idx = np.asarray(indices, np.int32)
            if rt_mesh is not None:
                import jax
                from jax.sharding import NamedSharding, PartitionSpec as P
                idx = jax.device_put(idx, NamedSharding(rt_mesh, P()))
            for i in range(self.num_losses):
                if self.args[i].mesh is None:
                    # gather-in-jit path: full device-resident tensors +
                    # indices; one dispatch, no per-step H2D upload
                    if rt_mesh is not None:
                        self.args[i].ensure_placed(rt_mesh)
                    batch = (*self.args[i].device_args, idx)
                else:
                    batch = self.args[i][indices]
                loss, state, images = fns[i](state, *batch, rt,
                                             self.scale[i])
                # device-side accumulation: no host sync per step (the
                # reference's pmap outputs forced one; log fns pull
                # values only at their log_period)
                total_loss = total_loss + loss / len(raytracing_args)
                total_images = total_images + images / len(raytracing_args)
        return total_loss, state, total_images

    @property
    def scan_meta(self):
        """make_scan_step kwargs when this is a single scannable loss
        (the public single-loss surface used by bench/driver scripts);
        None for composed or non-scannable steps."""
        if self.scan_metas is not None and len(self.scan_metas) == 1:
            return self.scan_metas[0]
        return None

    def __add__(self, other):
        metas = (self.scan_metas + other.scan_metas
                 if self.scan_metas is not None
                 and other.scan_metas is not None else None)
        return TrainStep(self.dtype + other.dtype, self.args + other.args,
                         self.grad_fn + other.grad_fn,
                         self.test_fn + other.test_fn,
                         self.scale + other.scale, scan_meta=metas)

    @classmethod
    def image(cls, t_frames, target, predictor, sigma=1.0, offset=0.0,
              scale=1.0, dtype='full', mesh=None,
              tv_scale=0.0, tv_fov=None, tv_resolution=32):
        """Image-plane / lightcurve training step
        (reference optimization.py:189-217). tv_scale > 0 adds a
        total-variation smoothness penalty on the canonical-frame volume
        (step.tv_loss — the working form of the reference's broken
        tv_reg, network.py:931)."""
        target = np.asarray(target)
        sigma = sigma * np.ones_like(target)
        offset = offset * np.ones_like(target)
        args = TemporalBatchedArgs(t_frames, [target, sigma, offset],
                                   mesh=mesh)
        grad_fn, test_fn = step_lib.make_step_fns(
            predictor, kind='image', dtype=dtype,
            gather=mesh is None, tv_scale=tv_scale, tv_fov=tv_fov,
            tv_resolution=tv_resolution)
        # scan-chunked training is mesh-agnostic (the jitted scan
        # propagates input shardings), so meta is set with or without a
        # mesh; composed steps concatenate these per-loss metas
        meta = dict(
            predictor=predictor, kind='image', dtype=dtype,
            tv_scale=tv_scale, tv_fov=tv_fov, tv_resolution=tv_resolution)
        return cls(dtype, args, grad_fn, test_fn, scale, scan_meta=meta)

    @classmethod
    def eht(cls, t_frames, obs, image_fov, image_size, predictor,
            chisqdata=None, dtype='vis', pol='I', scale=1.0, mesh=None,
            operator='dense'):
        """EHT measurement training step (reference optimization.py:219-268).

        obs: bhnerf_jax.observation.Observation (or anything with
        chisqdata(dtype, image_fov, image_size, pol) -> (target, sigma, A)
        stacked per frame).

        operator='factored' builds the separable measurement operator
        (npix-fold smaller; chisq equal to dense within f32 roundoff) —
        use it at production image sizes (npix >= 64), where the dense
        per-frame DFT matrix stops fitting (npix=128 ngEHT: ~320 MB).
        """
        if chisqdata is not None:
            dtype = getattr(chisqdata, 'dtype', dtype)
        # only pass operator= when non-default: duck-typed observation
        # objects need implement only the documented
        # chisqdata(t, dtype, fov, size, pol) surface
        op_kw = {} if operator == 'dense' else {'operator': operator}
        target, sigma, A = obs.chisqdata(
            t_frames, dtype, image_fov, image_size, pol=pol, **op_kw)
        # split complex operators into a real/imag layout (real matmuls;
        # whether complex64 pays on the GPU is not measured yet)
        target, sigma, A = step_lib.to_real_measurements(
            dtype, target, sigma, A)
        args = TemporalBatchedArgs(t_frames, [target, sigma, A], mesh=mesh)
        grad_fn, test_fn = step_lib.make_step_fns(predictor, kind='eht',
                                                  dtype=dtype,
                                                  gather=mesh is None)
        meta = dict(
            predictor=predictor, kind='eht', dtype=dtype)
        return cls(dtype, args, grad_fn, test_fn, scale, scan_meta=meta)

    @property
    def t_units(self):
        return self.args[0].t_units


class TemporalBatchedArgs:
    """Frame-indexed args with mesh-aware batch placement
    (reference optimization.py:274-302)."""

    def __init__(self, t_frames, args=(), mesh=None):
        self.t_frames = t_frames
        args = list(args) if isinstance(args, (list, tuple)) else [args]
        self.num_frames = len(t_frames)
        assert all(self.num_frames == arg.shape[0] for arg in args)
        t_vals, self._t_unit = units.strip_time(t_frames, units.hr)
        args.append(np.asarray(t_vals, np.float32))
        self.args = args
        self.mesh = mesh
        self._device_args = None
        self._placed_on = None

    @property
    def device_args(self):
        """Full frame tensors resident on device (lazy, uploaded once).

        Used by the gather-in-jit step path: the per-step batch selection
        happens inside the jitted step, so one step = ONE dispatch with
        no per-step host-to-device upload.

        Under a mesh every frame tensor (frame times included) is placed
        sharded over the 'data' axis, so the scan-chunked path runs
        multi-chip with one dispatch per chunk as well. If the frame
        count does not divide the 'data' axis size the tensors fall back
        to full replication (with a warning — a multi-chip performance
        cliff, not an error)."""
        if self._device_args is None:
            import jax.numpy as jnp
            arrays = [jnp.asarray(np.asarray(a, np.float32))
                      for a in self.args]
            if self.mesh is not None:
                import jax
                from jax.sharding import NamedSharding, PartitionSpec as P
                ndata = self.mesh.shape.get('data', 1)
                if self.num_frames % ndata == 0:
                    spec = P('data')
                else:
                    import warnings
                    warnings.warn(
                        f'num_frames={self.num_frames} does not divide '
                        f"the 'data' mesh axis ({ndata}); frame tensors "
                        f'fall back to full replication (every device '
                        f'holds and processes all frames)')
                    spec = P()
                sh = NamedSharding(self.mesh, spec)
                arrays = [jax.device_put(a, sh) for a in arrays]
            self._device_args = arrays
        return self._device_args

    def ensure_placed(self, mesh):
        """Commit the device-resident frame tensors (replicated) on
        `mesh` once. Used when the RAY args are mesh-sharded but this
        container has no mesh of its own: inputs whose committed
        sharding differs from what the sharded executable expects are
        re-sharded on every call (a per-step re-upload).

        Must NOT set self.mesh: that flag records the frame-DP mesh the
        step fns were built against (TrainStep.__call__ keys its
        batching branch on it — flipping it after the first call would
        hand the gather-in-jit grad_fn a per-step frame batch with no
        indices argument)."""
        if self.mesh is None and self._placed_on is not mesh:
            import jax
            from jax.sharding import NamedSharding, PartitionSpec as P
            sh = NamedSharding(mesh, P())
            self._device_args = [jax.device_put(a, sh)
                                 for a in self.device_args]
            self._placed_on = mesh

    def sample(self, batchsize, replace=False):
        return np.random.choice(range(self.num_frames), batchsize,
                                replace=replace)

    def __getitem__(self, key):
        batch = [arg[key, ...] for arg in self.args]
        if self.mesh is not None:
            batch = mesh_lib.shard_frames(batch, self.mesh)
        return batch

    @property
    def t_units(self):
        return self._t_unit

    @property
    def t_start_obs(self):
        return self.t_frames[0]


class LogFn:
    """Periodic logging callback wrapper (reference optimization.py:349-357)."""

    def __init__(self, log_fn, log_period=1):
        self.log_period = log_period
        self.log_fn = log_fn

    def __call__(self, optimizer):
        if self.log_period > 0:
            if (optimizer.step == 1
                    or optimizer.step % self.log_period == 0):
                self.log_fn(optimizer)
