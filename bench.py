"""Benchmark: training-step throughput of the flagship recovery workload.

Workload matches the reference's production configuration (SURVEY.md §6):
64x64 image-plane rays x ngeo=100 samples, NeRF 4x128 + posenc deg 3,
batch of 6 frames per step, full-image chi^2 loss — forward + backward +
adam update per step.

Prints ONE JSON line, naming the device it ran on. Without a GPU the run
fails; a failing section fails the run. Headline metric:
  train_ray_samples_per_sec — workload throughput counting every ray
  sample of the 64x64x100 grid (including the ~83% that the static
  domain compaction removes before the MLP).
Extra keys make the number honest:
  steps_per_sec, mlp_samples_per_sec (samples that actually hit the MLP),
  model_tflops (analytic matmul FLOPs, fwd+bwd, unpadded dims),
  mfu (model_tflops / the device's bf16 peak), compute_dtype, and
  vs_baseline = speedup over the MEASURED dense pure-XLA path on the same
  device — i.e. a faithful port of the reference's semantics without the
  domain compaction (reference network.py:566-682
  evaluates the MLP on every ray sample through stock XLA).
"""
import json
import os
import sys
import time

import numpy as np

# Dense bf16 tensor-core peak by jax device_kind (FLOP/s). Source: NVIDIA
# H100 data sheet, SXM part, dense (no sparsity), at the 700 W limit. A
# device missing here reports mfu null; nothing is assumed for it.
PEAK_BF16_FLOPS = {
    'NVIDIA H100 80GB HBM3': 989e12,
}


def require_gpu():
    """The device this bench measures; exits non-zero without a GPU (a
    CPU number is never reported under a device metric)."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != 'gpu':
        raise SystemExit(f'bench measures a GPU; JAX found '
                         f'{dev.platform!r} devices')
    return dev


def card_info():
    """The card's name and power limit, as nvidia-smi reports them (a
    card below its 700 W maximum runs slower under load)."""
    import subprocess
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def peak_flops(device_kind):
    peak = PEAK_BF16_FLOPS.get(device_kind)
    if peak is None:
        print(f'# no peak FLOP/s on record for {device_kind!r}: mfu is '
              f'null', file=sys.stderr)
    return peak


def mlp_flops_per_sample(predictor):
    """Analytic fwd matmul FLOPs per sample (2*K*N per layer, true dims)."""
    from bhnerf_jax.models.fields import posenc_feature_dim
    in_dim = posenc_feature_dim(3, predictor.posenc_deg)
    skip = predictor.net_depth // 2 if predictor.do_skip else None
    dims, d = [], in_dim
    for i in range(predictor.net_depth):
        dims.append((d, predictor.net_width))
        d = predictor.net_width
        if predictor.do_skip and i > 0 and i % skip == 0:
            d += in_dim
    dims.append((d, predictor.out_channel))
    return 2 * sum(k * n for k, n in dims)


def time_steps(grad_step, state, batch_args, rt, n_steps):
    import jax
    loss, state, _ = grad_step(state, *batch_args, rt, 1.0)
    jax.block_until_ready(loss)  # compile + warmup
    t0 = time.perf_counter()
    for _ in range(n_steps):
        loss, state, _ = grad_step(state, *batch_args, rt, 1.0)
    jax.block_until_ready(loss)
    return n_steps / (time.perf_counter() - t0), float(np.asarray(loss))


def timed_reps(run_chunk, n_chunks, chunk_steps):
    """Median-of-reps timing methodology (single-sourced: a point
    estimate hides the run-to-run spread). Runs `run_chunk(seq)` n_chunks times per rep — seq is a
    monotone counter for PRNG-key derivation; the callable must return
    the last device value to block on — and times each rep.
    BENCH_REPS (default 5) repeats in one process.
    Returns (median_steps_per_sec, per_rep_rates)."""
    import jax
    reps = max(int(os.environ.get('BENCH_REPS', 5)), 1)
    rates, seq = [], 0
    for _ in range(reps):
        t0 = time.perf_counter()
        last = None
        for _ in range(n_chunks):
            seq += 1
            last = run_chunk(seq)
        jax.block_until_ready(last)
        rates.append(n_chunks * chunk_steps / (time.perf_counter() - t0))
    return float(np.median(rates)), rates


def rand_indices(rng, nt, batch, n_steps):
    return [np.asarray(rng.choice(nt, batch, replace=False), np.int32)
            for _ in range(n_steps + 1)]


def synthetic_polarized_rt(num, ngeo, fov, predictor, seed=0):
    """ALMA-flagship-SHAPED ray constants without the f64 geodesic trace.

    Training-step cost depends on shapes and the in-domain fraction, not
    on the physical values; sampling coords uniformly in the fov ball
    reproduces the production compaction ratio (~20%) at 128x128x100
    with a 3-Stokes J, so the polarized lightcurve throughput measured
    here tracks the real `fit_alma_lp_apr11_sgra_flare` workload
    (reference scripts/Fit_ALMA_LP_Apr11_SgrA_Flare.yaml: 128x128 rays,
    Stokes I/Q/U, lc loss) round-over-round without a ~10-minute
    geodesic precompute inside the bench.
    """
    from bhnerf_jax.train.step import RayTracingArgs
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    shape = (num, num, ngeo)
    coords = rng.uniform(-fov / 2, fov / 2,
                         size=(3, *shape)).astype(np.float32)
    J = rng.uniform(0.2, 1.0, size=(3, *shape)).astype(np.float32)
    pos = lambda: rng.uniform(0.5, 1.0, size=shape).astype(np.float32)
    return RayTracingArgs(
        coords=jnp.asarray(coords), Omega=jnp.asarray(0.05, jnp.float32),
        J=jnp.asarray(J), g=jnp.asarray(pos()), dtau=jnp.asarray(pos()),
        Sigma=jnp.asarray(pos()),
        t_geos_rel=jnp.asarray(
            rng.uniform(900.0, 1100.0, size=shape).astype(np.float32)),
        t_injection=jnp.zeros((), jnp.float32),
        t_start_obs=0.0, t_to_M=500.0, t_units=None)


def bench_alma_shape(predictor_base, mark, num_variants=10, chunk=100):
    """Polarized flagship workload: 128x128x100 rays, 3 Stokes, lc loss,
    sub-pixel ensemble riding the scan path (in-scan variant draw)."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from bhnerf_jax.train import TrainState, make_optimizer
    from bhnerf_jax.train.step import (compact_ensemble_args,
                                       make_scan_step, stack_ensemble)

    num, ngeo, fov, nt, batch = 128, 100, 16.0, 64, 6
    predictor = dataclasses.replace(predictor_base, rmin=3.0)
    rt_list = [synthetic_polarized_rt(num, ngeo, fov, predictor, seed=s)
               for s in range(num_variants)]
    # lc losses never materialize per-pixel images (train.step routes
    # them through the em @ W^T matmul), so the packed 'gather' layout
    # (no group-slot filler through the MLP) is the fast one here
    crt_list = compact_ensemble_args(rt_list, predictor, layout='gather')
    n_eff = crt_list[0].coords.shape[-1]
    stacked = stack_ensemble(crt_list)

    rng = np.random.default_rng(1)
    target = jnp.asarray(rng.random((nt, 3), dtype=np.float32))
    sigma = jnp.ones_like(target)
    offset = jnp.zeros_like(target)
    t_all = jnp.asarray(np.linspace(0.0, 1.0, nt, dtype=np.float32))

    scan_fn = make_scan_step(predictor=predictor, kind='image',
                             dtype='lc', batchsize=batch,
                             chunk=chunk, num_variants=num_variants)
    state = TrainState.create(predictor.init_params(seed=0),
                              make_optimizer(50000))
    state, losses = scan_fn(state, target, sigma, offset, t_all,
                            jax.random.PRNGKey(0), stacked, 1.0)
    jax.block_until_ready(losses)
    n_chunks = max(600 // chunk, 1)

    def run_chunk(seq):
        nonlocal state
        state, losses = scan_fn(state, target, sigma, offset, t_all,
                                jax.random.PRNGKey(seq), stacked, 1.0)
        return losses

    steps_per_sec, rates = timed_reps(run_chunk, n_chunks, chunk)
    mark(f'alma-shape ensemble({num_variants}) path: '
         f'{steps_per_sec:.2f} steps/s median of {len(rates)} '
         f'[{min(rates):.1f}, {max(rates):.1f}]')
    # same convention as the headline mfu: useful matmul FLOPs (fwd +
    # 2x bwd) over the device's bf16 peak
    peak = peak_flops(jax.devices()[0].device_kind)
    alma_flops = (3 * mlp_flops_per_sample(predictor) * n_eff * batch
                  * steps_per_sec)
    return {
        'alma_steps_per_sec': round(steps_per_sec, 2),
        'alma_steps_per_sec_spread': [round(min(rates), 2),
                                      round(max(rates), 2)],
        'alma_ray_samples_per_sec': round(
            steps_per_sec * batch * num * num * ngeo),
        'alma_mlp_samples_per_sec': round(steps_per_sec * batch * n_eff),
        'alma_mfu': round(alma_flops / peak, 4) if peak else None,
        'alma_num_variants': num_variants,
        'alma_shape': [num, num, ngeo, 3],
    }


def bench_eht_step(predictor, geos, rt, crt, t_frames_hr, mark,
                   chunk=250):
    """Visibility-loss (north-star) training-step throughput: ngEHT
    thermal-noise synthesis -> complex-vis chi^2, compact, scanned.
    Same geometry/predictor as the headline image workload so the two
    steps/s are directly comparable."""
    import jax

    from bhnerf_jax import constants, observation, units
    from bhnerf_jax.train import TrainState, TrainStep, make_optimizer
    from bhnerf_jax.train.step import make_scan_step

    nt = len(t_frames_hr)
    num = geos.num_alpha
    rng = np.random.default_rng(0)
    movie = rng.random((nt, num, num), dtype=np.float32)
    array = observation.load_txt(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), 'eht_arrays',
        'ngEHT.txt'))
    obs_empty = observation.empty_eht_obs(array, nt=nt, tint=30.0)
    fov_M = float(geos.alpha.max() - geos.alpha.min())
    fov_rad = float(fov_M * constants.GM_c2(constants.sgra_mass).value
                    / constants.sgra_distance.to('m').value)
    obs = observation.observe_same(movie, np.asarray(t_frames_hr),
                                   fov_rad / num, obs_empty,
                                   thermal_noise=True, seed=0)
    out = {}
    for op in ('dense', 'factored'):
        train_step = TrainStep.eht(
            units.Quantity(np.asarray(t_frames_hr, np.float32), 'hr'),
            obs, fov_rad, num, predictor, dtype='vis', operator=op)
        scan_fn = make_scan_step(batchsize=6, chunk=chunk,
                                 **train_step.scan_meta)
        state = TrainState.create(predictor.init_params(seed=0),
                                  make_optimizer(50000))
        dev_args = train_step.args[0].device_args
        state, losses = scan_fn(state, *dev_args, jax.random.PRNGKey(0),
                                crt, 1.0)
        jax.block_until_ready(losses)

        def run_chunk(seq):
            nonlocal state
            state, losses = scan_fn(state, *dev_args,
                                    jax.random.PRNGKey(seq), crt, 1.0)
            return losses

        steps_per_sec, rates = timed_reps(run_chunk, 2, chunk)
        mark(f'eht (vis-loss, {op} operator) path: '
             f'{steps_per_sec:.2f} steps/s median of {len(rates)} '
             f'[{min(rates):.1f}, {max(rates):.1f}]')
        key = ('eht_steps_per_sec' if op == 'dense'
               else 'eht_factored_steps_per_sec')
        out[key] = round(steps_per_sec, 2)
        if op == 'dense':
            out['eht_nvis_per_frame'] = int(dev_args[2].shape[-2])
    return out


def bench_device_geos(mark, n=64, ngeo=100):
    """On-device f32 geodesic trace (warm-executable): the chi^2 grid
    scans re-trace one table per grid point and sub-pixel variant, so
    tables/s is the scan-throughput currency."""
    import time as time_lib

    from bhnerf_jax.geodesics import image_plane_geos
    kw = dict(spin=0.94, inclination=np.deg2rad(60), alpha_range=(-8, 8),
              beta_range=(-8, 8), ngeo=ngeo, num_alpha=n, num_beta=n,
              backend='device')
    image_plane_geos(**kw)                        # compile
    t0 = time_lib.perf_counter()
    image_plane_geos(**kw)
    dt = time_lib.perf_counter() - t0
    mark(f'device f32 geodesic trace ({n}x{n}x{ngeo}): {dt:.2f} s/table')
    return {'geos_device_trace_s': round(dt, 3)}


def image_setup(compute_dtype, num=64, ngeo=100, nt=64, fov=16.0):
    """The headline image workload: geodesics, ray args, predictor."""
    from bhnerf_jax import constants, units
    from bhnerf_jax.geodesics import image_plane_geos
    from bhnerf_jax.models import NeRFPredictor
    from bhnerf_jax.train import raytracing_args

    geos = image_plane_geos(
        spin=0.2, inclination=np.deg2rad(60.0),
        alpha_range=(-fov / 2, fov / 2), beta_range=(-fov / 2, fov / 2),
        ngeo=ngeo, num_alpha=num, num_beta=num, n_fine=4096)
    Omega = geos.keplerian_omega()
    t_injection = -float(geos.r_o + fov / 4)
    GM_hr = constants.GM_c3(constants.sgra_mass).to('hr').value
    t_frames = np.linspace(0.0, 200.0 * GM_hr, nt).astype(np.float32)
    rt = raytracing_args(geos, Omega, t_injection,
                         units.Quantity(t_frames[0], 'hr'))
    predictor = NeRFPredictor(scale=fov / 2, rmin=3.0, rmax=fov / 2,
                              z_width=2.0, net_depth=4, net_width=128,
                              posenc_deg=3, compute_dtype=compute_dtype)
    return geos, rt, t_frames, predictor


def bench_image_scan(predictor, crt, frame_args, mark, batch=6):
    """Scan-chunked image step (Optimizer.run(scan_chunk=N)): median
    steps/s of BENCH_REPS repetitions."""
    import jax
    from bhnerf_jax.train import TrainState, make_optimizer
    from bhnerf_jax.train.step import make_scan_step

    scan_chunk = int(os.environ.get('BENCH_SCAN_CHUNK', 500))
    scan_fn = make_scan_step(predictor=predictor, kind='image',
                             dtype='full', batchsize=batch,
                             chunk=scan_chunk)
    state = TrainState.create(predictor.init_params(seed=0),
                              make_optimizer(50000))
    state, losses = scan_fn(state, *frame_args, jax.random.PRNGKey(0),
                            crt, 1.0)
    jax.block_until_ready(losses)

    def run_chunk(seq):
        nonlocal state
        state, losses = scan_fn(state, *frame_args,
                                jax.random.PRNGKey(seq), crt, 1.0)
        return losses

    rate, rates = timed_reps(run_chunk, max(1000 // scan_chunk, 1),
                             scan_chunk)
    mark(f'image scan path: {rate:.2f} steps/s median of '
         f'{len(rates)} [{min(rates):.1f}, {max(rates):.1f}]')
    return rate, rates


def main():
    import dataclasses

    import jax
    import jax.numpy as jnp

    from bhnerf_jax.utils import enable_compilation_cache
    enable_compilation_cache()
    dev = require_gpu()

    def mark(msg):
        print(f'# [{time.strftime("%H:%M:%S")}] {msg}', file=sys.stderr,
              flush=True)

    from bhnerf_jax import emission
    from bhnerf_jax.train import TrainState, make_optimizer
    from bhnerf_jax.train.step import compact_raytracing_args, make_step_fns

    num_alpha = num_beta = 64
    ngeo = 100
    batch = 6
    nt = 64
    compute_dtype = os.environ.get('BENCH_COMPUTE_DTYPE', 'bfloat16')

    mark(f'backend={jax.default_backend()} tracing geodesics')
    geos, rt, t_frames, predictor = image_setup(compute_dtype, num_alpha,
                                                ngeo, nt)
    # domain compaction: the optimized path
    crt = compact_raytracing_args(rt, predictor)
    n_eff = int(np.asarray(emission.domain_mask(
        rt.coords, predictor.rmin, predictor.rmax,
        predictor.z_width)).sum())

    # production step path: full frame tensors device-resident, the
    # frame-batch gather inside the jitted step (one dispatch per step —
    # what train.Optimizer runs)
    rng = np.random.default_rng(0)
    target = jnp.asarray(rng.random((nt, num_alpha, num_beta),
                                    dtype=np.float32))
    sigma = jnp.ones_like(target)
    offset = jnp.zeros_like(target)
    t_all = jnp.asarray(t_frames)
    inds = np.asarray(rng.choice(nt, batch, replace=False), np.int32)
    batch_args = (target, sigma, offset, t_all, inds)

    mark('geodesics done, compiling compact train step')
    state = TrainState.create(predictor.init_params(seed=0),
                              make_optimizer(50000))
    grad_step, _ = make_step_fns(predictor, kind='image', dtype='full',
                                 donate_state=True, gather=True)
    steps_per_sec, loss = time_steps(grad_step, state, batch_args, crt,
                                     n_steps=50)

    mark(f'compact path: {steps_per_sec:.2f} steps/s; compiling scan '
         'step')
    scan_steps_per_sec, scan_rates = bench_image_scan(
        predictor, crt, (target, sigma, offset, t_all), mark)
    scan_spread = [round(min(scan_rates), 2), round(max(scan_rates), 2)]

    # polarized flagship shape (ALMA 128x128, 3-Stokes, lc loss) with a
    # 10-variant sub-pixel ensemble riding the scan path
    alma_keys = bench_alma_shape(predictor, mark)
    # north-star EHT (visibility-loss) step on the same geometry
    eht_keys = bench_eht_step(
        predictor, geos, rt, crt,
        np.linspace(4.0, 15.5, nt).astype(np.float32), mark)
    # on-device f32 geodesic tracing (chi^2-scan table generation)
    geos_keys = bench_device_geos(mark)

    # measured baseline: dense pure-XLA path, reference semantics (every
    # ray sample through the MLP, stock XLA fusion, f32)
    mark('compiling dense XLA baseline')
    base_pred = dataclasses.replace(predictor, compute_dtype='float32')
    base_state = TrainState.create(base_pred.init_params(seed=0),
                                   make_optimizer(50000))
    base_step, _ = make_step_fns(base_pred, kind='image', dtype='full',
                                 donate_state=True, gather=True)
    base_steps_per_sec, _ = time_steps(base_step, base_state, batch_args,
                                       rt, n_steps=10)

    best = max(steps_per_sec, scan_steps_per_sec)
    flops_fwd = mlp_flops_per_sample(predictor)
    model_flops_per_step = 3 * flops_fwd * n_eff * batch  # fwd + bwd(2x)
    model_tflops = model_flops_per_step * best / 1e12
    peak = peak_flops(dev.device_kind)
    mfu = model_tflops * 1e12 / peak if peak else None

    ray_samples_per_sec = best * batch * num_alpha * num_beta * ngeo
    print(json.dumps({
        'metric': 'train_ray_samples_per_sec',
        'value': round(ray_samples_per_sec),
        'unit': 'samples/s',
        'device': {'platform': dev.platform, 'kind': dev.device_kind,
                   'count': len(jax.devices())},
        'nvidia_smi': card_info(),
        'vs_baseline': round(best / base_steps_per_sec, 3),
        'steps_per_sec': round(best, 2),
        'per_dispatch_steps_per_sec': round(steps_per_sec, 2),
        'scan_steps_per_sec': round(scan_steps_per_sec, 2),
        'scan_steps_per_sec_spread': scan_spread,
        'baseline_dense_xla_steps_per_sec': round(base_steps_per_sec, 2),
        'mlp_samples_per_sec': round(best * batch * n_eff),
        'model_tflops': round(model_tflops, 2),
        'mfu': round(mfu, 4) if mfu is not None else None,
        'peak_tflops': peak / 1e12 if peak else None,
        'compute_dtype': compute_dtype,
        **alma_keys,
        **eht_keys,
        **geos_keys,
    }))
    print(f'# steps/sec: {best:.2f} (per-dispatch {steps_per_sec:.2f}, '
          f'dense XLA baseline {base_steps_per_sec:.2f})  loss: '
          f'{loss:.3f}', file=sys.stderr)


if __name__ == '__main__':
    main()
