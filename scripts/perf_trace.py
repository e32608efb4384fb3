"""Profile the compact scan step and print the device-op time breakdown.

Writes a jax.profiler trace of REPS scanned train steps, then parses the
perfetto JSON to aggregate the durations of the ops that ran on the GPU.
Run on a GPU machine:  python scripts/perf_trace.py [--alma | --eht]
"""
import glob
import gzip
import json
import os
import sys
import time
from collections import defaultdict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

REPS = 50
TRACE_DIR = os.path.join(REPO, 'chiprun_out', 'perf_trace')


def _bench_geos(fov):
    """The bench's 64x64x100 geodesic table (host f64 trace)."""
    from bhnerf_jax.geodesics import image_plane_geos
    return image_plane_geos(
        spin=0.2, inclination=np.deg2rad(60.0),
        alpha_range=(-fov / 2, fov / 2), beta_range=(-fov / 2, fov / 2),
        ngeo=100, num_alpha=64, num_beta=64, n_fine=4096)


def main():
    import jax
    import jax.numpy as jnp

    from bhnerf_jax.utils import enable_compilation_cache
    enable_compilation_cache()

    from bhnerf_jax import constants, units
    from bhnerf_jax.geodesics import image_plane_geos
    from bhnerf_jax.models import NeRFPredictor
    from bhnerf_jax.train import TrainState, make_optimizer, raytracing_args
    from bhnerf_jax.train.step import (compact_raytracing_args,
                                       make_scan_step)

    fov = 16.0
    alma = '--alma' in sys.argv
    eht = '--eht' in sys.argv
    predictor = NeRFPredictor(scale=fov / 2, rmin=3.0, rmax=fov / 2,
                              z_width=2.0, compute_dtype='bfloat16')
    GM_hr = constants.GM_c3(constants.sgra_mass).to('hr').value
    nt = 64
    rng = np.random.default_rng(0)
    if eht:
        # visibility-loss north-star step (bench_recovery --eht shape):
        # ngEHT thermal-noise synthesis -> complex-vis chi^2, compact
        from bhnerf_jax import observation
        from bhnerf_jax.train import TrainStep
        geos = _bench_geos(fov)
        Omega = geos.keplerian_omega()
        t_frames = units.Quantity(
            np.linspace(4.0, 15.5, nt).astype(np.float32), 'hr')
        rt = raytracing_args(geos, Omega, -float(geos.r_o + 4),
                             t_frames[0])
        crt = compact_raytracing_args(rt, predictor)
        movie = rng.random((nt, 64, 64), dtype=np.float32)
        array = observation.load_txt(os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            'eht_arrays', 'ngEHT.txt'))
        obs_empty = observation.empty_eht_obs(array, nt=nt, tint=30.0)
        fov_rad = float(fov * constants.GM_c2(constants.sgra_mass).value
                        / constants.sgra_distance.to('m').value)
        obs = observation.observe_same(movie, np.asarray(t_frames.value),
                                       fov_rad / 64, obs_empty,
                                       thermal_noise=True, seed=0)
        train_step = TrainStep.eht(t_frames, obs, fov_rad, 64, predictor,
                                   dtype='vis')
        num_variants = 1
        import jax
        scan_fn = make_scan_step(batchsize=6, chunk=REPS,
                                 **train_step.scan_meta)
        from bhnerf_jax.train import TrainState, make_optimizer
        state = TrainState.create(predictor.init_params(seed=0),
                                  make_optimizer(50000))
        dev_args = train_step.args[0].device_args
        state, losses = scan_fn(state, *dev_args,
                                jax.random.PRNGKey(0), crt, 1.0)
        jax.block_until_ready(losses)
        with jax.profiler.trace(TRACE_DIR):
            t0 = time.perf_counter()
            state, losses = scan_fn(state, *dev_args,
                                    jax.random.PRNGKey(1), crt, 1.0)
            jax.block_until_ready(losses)
            wall = time.perf_counter() - t0
        print(f'wall: {1e3 * wall / REPS:.3f} ms/step', flush=True)
        report()
        return
    if alma:
        # polarized flagship shape with the in-scan ensemble
        # (same synthetic workload as bench.bench_alma_shape)
        import bench as bench_lib
        from bhnerf_jax.train.step import (compact_ensemble_args,
                                           stack_ensemble)
        num_variants = 10
        if '--variants' in sys.argv:
            num_variants = int(sys.argv[sys.argv.index('--variants') + 1])
        layout = 'gather' if '--packed' in sys.argv else 'auto'
        rt_list = [bench_lib.synthetic_polarized_rt(128, 100, fov,
                                                    predictor, seed=s)
                   for s in range(num_variants)]
        built = compact_ensemble_args(rt_list, predictor, layout=layout)
        crt = built[0] if num_variants == 1 else stack_ensemble(built)
        target = jnp.asarray(rng.random((nt, 3), dtype=np.float32))
        t_all = jnp.asarray(np.linspace(0.0, 1.0, nt, dtype=np.float32))
        kind_kwargs = dict(kind='image', dtype='lc')
    else:
        geos = _bench_geos(fov)
        Omega = geos.keplerian_omega()
        rt = raytracing_args(geos, Omega, -float(geos.r_o + 4),
                             units.Quantity(0.0, 'hr'))
        crt = compact_raytracing_args(rt, predictor)
        num_variants = 1
        target = jnp.asarray(rng.random((nt, 64, 64), dtype=np.float32))
        t_all = jnp.asarray(np.linspace(0.0, 200.0 * GM_hr, nt,
                                        dtype=np.float32))
        kind_kwargs = dict(kind='image', dtype='full')

    sigma = jnp.ones_like(target)
    offset = jnp.zeros_like(target)
    scan_fn = make_scan_step(predictor=predictor, batchsize=6,
                             chunk=REPS, num_variants=num_variants,
                             **kind_kwargs)
    state = TrainState.create(predictor.init_params(seed=0),
                              make_optimizer(50000))
    state, losses = scan_fn(state, target, sigma, offset, t_all,
                            jax.random.PRNGKey(0), crt, 1.0)
    jax.block_until_ready(losses)

    with jax.profiler.trace(TRACE_DIR):
        t0 = time.perf_counter()
        state, losses = scan_fn(state, target, sigma, offset, t_all,
                                jax.random.PRNGKey(1), crt, 1.0)
        jax.block_until_ready(losses)
        wall = time.perf_counter() - t0
    print(f'wall: {1e3 * wall / REPS:.3f} ms/step', flush=True)
    report()


def report():
    """Parse the newest perfetto trace and print device-op aggregates."""
    traces = sorted(glob.glob(
        TRACE_DIR + '/**/*.trace.json.gz', recursive=True))
    if not traces:
        print('no trace file found'); return
    with gzip.open(traces[-1], 'rt') as f:
        data = json.load(f)

    # GPU device processes (/device:GPU:N); the host threads are skipped
    events = data['traceEvents']
    pid_names = {e['pid']: e['args'].get('name', '') for e in events
                 if e.get('ph') == 'M' and e.get('name') == 'process_name'
                 and 'args' in e}
    device_pids = {p for p, n in pid_names.items()
                   if n.startswith('/device:GPU')}
    agg = defaultdict(float)
    total = 0.0
    for e in events:
        if e.get('ph') == 'X' and e.get('pid') in device_pids:
            name = e.get('name', '?')
            dur = e.get('dur', 0) / 1e3  # us -> ms
            agg[name] += dur
            total += dur
    print(f'total device op time: {total:.1f} ms over {REPS} steps '
          f'({total / REPS:.3f} ms/step)')
    for name, dur in sorted(agg.items(), key=lambda kv: -kv[1])[:25]:
        print(f'{dur / REPS:8.4f} ms/step  {dur / max(total, 1e-9):6.1%}  '
              f'{name[:90]}')


if __name__ == '__main__':
    main()
