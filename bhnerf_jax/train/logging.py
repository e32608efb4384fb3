"""Tensorboard logging + profiling hooks.

Rebuild of the reference SummaryWriter layer (optimization.py:304-347) on
tensorboardX, plus the jax.profiler tracing the reference lacks
(SURVEY.md §5 'tracing: none — new build should add jax.profiler').
"""
from __future__ import annotations

import contextlib

import numpy as np

try:
    import tensorboardX
    _HAS_TBX = True
except Exception:  # pragma: no cover
    _HAS_TBX = False


class SummaryWriter(tensorboardX.SummaryWriter if _HAS_TBX else object):
    """tensorboardX writer with recovery/datafit log-closure factories
    (reference optimization.py:304-347)."""

    def __init__(self, *args, **kwargs):
        if not _HAS_TBX:
            raise ImportError(
                'tensorboardX is required for SummaryWriter (failing '
                'fast here beats an AttributeError hours into training)')
        super().__init__(*args, **kwargs)

    def recovery_3d(self, fov, vis_res=64, emission_true=None):
        from bhnerf_jax import utils
        from bhnerf_jax.models import fields as fields_lib

        if emission_true is not None:
            vis_coords = np.stack(np.meshgrid(
                emission_true.x, emission_true.y, emission_true.z,
                indexing='ij'))
        else:
            grid_1d = np.linspace(-fov / 2, fov / 2, vis_res)
            vis_coords = np.stack(np.meshgrid(grid_1d, grid_1d, grid_1d,
                                              indexing='ij'))

        def log_fn(opt):
            emission_grid = fields_lib.sample_3d_grid(
                opt.predictor, opt.params, coords=vis_coords)
            volume_slices = utils.intensity_to_nchw(emission_grid)
            self.add_images('emission/estimate', volume_slices,
                            dataformats='NCWH', global_step=opt.step)
            if emission_true is not None:
                true = np.asarray(emission_true.data)
                self.add_scalar('emission/mse',
                                utils.mse(true, emission_grid),
                                global_step=opt.step)
                self.add_scalar('emission/psnr',
                                utils.psnr(true, emission_grid),
                                global_step=opt.step)

        return log_fn

    def plot_lc_datafit(self, opt, name, train_step, target, stokes,
                        t_frames=None, batchsize=20):
        import matplotlib.pyplot as plt
        from bhnerf_jax import visualization
        from bhnerf_jax.train import optimizer as opt_lib

        raytracing_args = np.atleast_1d(opt.raytracing_args)
        rt = raytracing_args[np.random.choice(len(raytracing_args))]
        loss, movie = opt_lib.total_movie_loss(
            batchsize, opt.state, train_step, rt, return_frames=True)
        lc_est = movie.sum(axis=(-1, -2))
        axes = visualization.plot_stokes_lc(target, stokes, t_frames,
                                            label='True')
        axes = visualization.plot_stokes_lc(lc_est, stokes, t_frames,
                                            axes=axes, fmt='x', color='r',
                                            label='Estimate')
        for ax in np.atleast_1d(axes):
            ax.legend()
        self.add_figure(f'lightcurve/{name}', plt.gcf(),
                        global_step=opt.step)
        self.add_scalar(f'datafit/{name}', np.log10(np.mean(loss)),
                        global_step=opt.step)


@contextlib.contextmanager
def profile_trace(logdir):
    """jax.profiler trace context for device timeline capture."""
    import jax
    jax.profiler.start_trace(str(logdir))
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class StepTimer:
    """Lightweight steps/sec tracker usable as a LogFn target."""

    def __init__(self):
        import time
        self._time = time
        self.last_t = None
        self.last_step = None
        self.steps_per_sec = float('nan')

    def __call__(self, opt):
        now = self._time.perf_counter()
        if opt.step == self.last_step:
            return  # same-step re-entry must not reset the clock
        if self.last_t is not None:
            self.steps_per_sec = (opt.step - self.last_step) / (
                now - self.last_t)
        self.last_t = now
        self.last_step = opt.step
