"""Config-5 idealized: recover 3D emission from Q/U lightcurves alone.

The "Synthetic lightcurves 1 - Recovery idealized" workflow of the
reference: fit the NeRF to polarized (Q, U) lightcurves of a hotspot at
the true inclination through the optimized compact path.
Lightcurve-only tomography is strongly ill-posed (1D data -> 3D volume);
the reference attacks it with 50k-iteration runs over inclination grids
and random seeds (scripts/fit_synthetic_lp_flares.py) — this example is
the single-seed, few-thousand-iteration core of that loop and reports
the data fit + volume correlation.

Run:  python examples/polarized_lightcurve_recovery.py [--small]
"""
import sys
sys.path.insert(0, __import__('os').path.join(__import__('os').path.dirname(__file__), '..'))
import time
import numpy as np
import jax
from bhnerf_jax.utils import enable_compilation_cache
enable_compilation_cache()
from bhnerf_jax import alma, constants, emission, units, utils
from bhnerf_jax.models import NeRFPredictor, sample_3d_grid
from bhnerf_jax.train import TrainState, TrainStep, make_optimizer, raytracing_args
from bhnerf_jax.train.step import compact_raytracing_args

SMALL = '--small' in sys.argv
NUM = 16 if SMALL else 64
NT = 16 if SMALL else 64
ITERS = 200 if SMALL else 3000
RES = 32 if SMALL else 64

inc_true = np.deg2rad(60.0)
model_params = {
    'spin': 0.0, 'fov_M': 30.0, 'z_width': 3.0, 'rmin': 'ISCO',
    'Q_frac': 0.85, 'b_consts': {'arad': 0, 'avert': 1, 'ator': 0},
    'Omega_dir': 'cw', 'Omega_frac': 1.0,
    'num_alpha': NUM, 'num_beta': NUM, 't_start_obs': 9.34,
}
geos, Omega, J = alma.image_plane_model(inc_true, 0.0, model_params)
hotspot = emission.generate_hotspot((RES,)*3, [0,0,1], 0.0, 8.0, 1.0, 6.0, 30.0)
t_frames = units.Quantity(np.linspace(9.34, 10.4, NT), 'hr')
t_injection = -float(geos.r_o + 7.5)
movie = np.asarray(emission.image_plane_dynamics(hotspot, geos, Omega, t_frames,
        t_injection, J=J, t_start_obs=t_frames[0]))
lc = movie.sum(axis=(-1,-2))  # (nt, 3)
print('lc ranges:', lc.min(0), lc.max(0), flush=True)

predictor = NeRFPredictor(scale=15.0, rmin=6.0, rmax=15.0, z_width=3.0)
rt = raytracing_args(geos, Omega, t_injection, t_frames[0], J=J)
crt = compact_raytracing_args(rt, predictor)
# fit Q,U only (stokes 1:2) like the synthetic flares script
step = TrainStep.image(t_frames, lc[:, 1:3], predictor,
                       sigma=0.01, dtype='lc')
# restrict J to Q,U for the fit
rtQU = raytracing_args(geos, Omega, t_injection, t_frames[0], J=J[1:3])
crtQU = compact_raytracing_args(rtQU, predictor)
state = TrainState.create(predictor.init_params(seed=1), make_optimizer(ITERS, lr_init=1e-3, lr_final=1e-5))
np.random.seed(0)
t0 = time.perf_counter()
for i in range(ITERS):
    inds = step.args[0].sample(6)
    loss, state, _ = step(state, crtQU, inds)
print(f'{ITERS} iters in {time.perf_counter()-t0:.1f}s, final loss {float(np.asarray(loss)):.1f}', flush=True)
vol = sample_3d_grid(predictor, jax.device_get(state.params), fov=30.0, resolution=RES)
truth = np.asarray(hotspot.data)
corr = np.corrcoef(vol.ravel(), truth.ravel())[0,1]
print(f'3D recovery from Q/U lightcurves alone: corr {corr:.3f}, PSNR {utils.psnr(truth, vol):.1f} dB', flush=True)
