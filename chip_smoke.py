"""Smoke test of the training path on an NVIDIA GPU.

Drives the flagship trainer (NeRF 4x128, posenc degree 3, ~67k params)
through the normal entry points (image_plane_geos, raytracing_args,
compact_raytracing_args, TrainStep, Optimizer.run(scan_chunk=...),
make_scan_step) with random weights from a fixed seed:

  0. device: a GPU is required (platform, kind, count, JAX version,
     XLA_FLAGS, and the card's name and power limit from nvidia-smi);
  1. the compact training path against the dense reference path at
     float32 / matmul precision "highest": forward images (lightcurve),
     every parameter gradient and the t_injection gradient, at
     compute_dtype float32 and bfloat16, on the 64x64x100 image problem
     (batch 6) and the 128x128x100 3-Stokes ALMA 'gather' layout;
  2. image trainer (Tutorial-3 shape): device-traced 64x64x100
     geodesics, Optimizer.run over 64 frames, batch 6, bf16,
     scan-chunked, ~200 steps; plus the device f32 geodesic trace
     against the host f64 trace at 32x32x100;
  3. ALMA polarized lightcurve step: 128x128x100, 3 Stokes, 10-variant
     sub-pixel ensemble on the scan path;
  4. EHT visibility step: ngEHT, npix 64, dense and factored operators;
     both give the same chi^2 at one parameter set.

With --multi it runs only phase 5 on four GPUs: the frame-data-parallel
scan step on a ('data',) mesh and the sample-parallel shard_map step on
ray=4, each compared with the same step on one GPU.

Every phase prints one line with its wall time and numbers; any failure
exits non-zero. The last stdout line is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
One process drives the card(s).

Run:  python chip_smoke.py            (one GPU)
      python chip_smoke.py --multi    (four GPUs)
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Problem sizes; FULL is what the card runs, TINY the CPU test."""
    npix: int = 64           # image-plane rays per side (image/EHT)
    ngeo: int = 100
    nt: int = 64             # movie frames
    batch: int = 6
    alma_npix: int = 128
    alma_variants: int = 10
    geos_check_npix: int = 32
    train_steps: int = 200
    scan_chunk: int = 100
    width: int = 128
    eht_steps: int = 20
    multi_steps: int = 10
    # bf16 gradient-cosine bar: a statistical bound, met when tens of
    # thousands of samples average the bf16 rounding (a few hundred do not)
    bf16_cos_min: float = 0.999
    # the image trainer's movie loss must fall below this fraction
    loss_drop: float = 0.5


FULL = Sizes()
TINY = Sizes(npix=8, ngeo=16, nt=8, batch=2, alma_npix=8, alma_variants=2,
             geos_check_npix=8, train_steps=4, scan_chunk=2, width=32,
             eht_steps=2, multi_steps=2, bf16_cos_min=0.99, loss_drop=1.0)

FOV = 16.0


def _log(phase, t0, msg):
    print(f'[phase {phase}] {time.perf_counter() - t0:7.1f} s  {msg}',
          flush=True)


def _check(ok, msg):
    if not ok:
        raise AssertionError(msg)


# ---------------------------------------------------------------------------
# phase 0
# ---------------------------------------------------------------------------
def phase_device(require_gpu=True):
    import jax
    t0 = time.perf_counter()
    devs = jax.devices()
    dev = devs[0]
    if require_gpu and dev.platform != 'gpu':
        raise SystemExit(f'chip_smoke needs a GPU; JAX found '
                         f'{dev.platform!r} devices')
    _log(0, t0, f'platform={dev.platform} kind={dev.device_kind!r} '
         f'count={len(devs)} jax={jax.__version__} '
         f'XLA_FLAGS={os.environ.get("XLA_FLAGS", "")!r}')
    if dev.platform == 'gpu':
        smi = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            check=True, timeout=60)
        # the card's name and power limit, exactly as nvidia-smi gives them
        for line in smi.stdout.strip().splitlines():
            print(line.strip(), flush=True)
    return dev


# ---------------------------------------------------------------------------
# shared problem
# ---------------------------------------------------------------------------
def _predictor(sz, **kw):
    from bhnerf_jax.models import NeRFPredictor
    base = dict(scale=FOV / 2, rmin=3.0, rmax=FOV / 2, z_width=2.0,
                net_depth=4, net_width=sz.width, posenc_deg=3)
    base.update(kw)
    return NeRFPredictor(**base)


def _image_problem(sz, backend='device'):
    """Tutorial-3 geometry: spin 0.2, inclination 60 deg, fov 16 M."""
    from bhnerf_jax import constants, units
    from bhnerf_jax.geodesics import image_plane_geos
    from bhnerf_jax.train import raytracing_args
    geos = image_plane_geos(
        spin=0.2, inclination=np.deg2rad(60.0),
        alpha_range=(-FOV / 2, FOV / 2), beta_range=(-FOV / 2, FOV / 2),
        ngeo=sz.ngeo, num_alpha=sz.npix, num_beta=sz.npix, backend=backend)
    Omega = geos.keplerian_omega()
    t_injection = -float(geos.r_o + FOV / 4)
    GM_hr = constants.GM_c3(constants.sgra_mass).to('hr').value
    t_frames = units.Quantity(
        np.linspace(0.0, 100.0 * GM_hr, sz.nt).astype(np.float32), 'hr')
    rt = raytracing_args(geos, Omega, t_injection, t_frames[0])
    return geos, rt, t_frames, Omega, t_injection


# ---------------------------------------------------------------------------
# phase 1: the compact training path against the dense reference
# ---------------------------------------------------------------------------
# The optimized path (domain-compacted samples, per-pixel segment sums,
# the lightcurve as one matmul) against the plain dense path (every ray
# sample through the MLP, images summed by XLA), both at float32 and
# matmul precision "highest". Tolerances:
# * float32: max image error <= 1e-5 of the image peak, gradient error
#   <= 1e-4 of each leaf's largest entry, t_injection gradient within
#   1e-3 relative: the same arithmetic in another summation order.
# * bfloat16 MLP operands (compact) vs the float32 reference: per-matrix
#   gradient cosine > Sizes.bf16_cos_min (0.999) and loss within 1%
#   (bf16 keeps 8 bits of mantissa; accumulation is float32).
F32_FWD_RTOL = 1e-5
F32_GRAD_TOL = 1e-4
F32_TINJ_RTOL = 1e-3
BF16_LOSS_RTOL = 0.01


def _compare_case(name, rt, crt, predictor, t_frames_M, seed, cos_min,
                  lightcurve=False):
    """Loss, forward and every gradient: compact path vs dense path."""
    import jax
    import jax.numpy as jnp
    from bhnerf_jax.train.step import (compact_lightcurve,
                                       image_plane_prediction)

    t0 = time.perf_counter()
    ref_pred = dataclasses.replace(predictor, compute_dtype='float32',
                                   learn_injection=True)
    params = ref_pred.init_params(seed=seed)
    out_key = f'dense_{ref_pred.net_depth}'
    # lift the output bias so emission has structure (sigmoid(x - 10)
    # is ~5e-5 at init) and make the injection offset non-trivial
    params[out_key]['bias'] = params[out_key]['bias'] + 9.0
    params['t_injection'] = jnp.float32(3.0)

    def dense(p, pred):
        out = image_plane_prediction(p, pred, t_frames_M, rt)
        return out.sum(axis=(-1, -2)) if lightcurve else out

    def compact(p, pred):
        if lightcurve:
            return compact_lightcurve(p, pred, t_frames_M, crt)
        return image_plane_prediction(p, pred, t_frames_M, crt)

    shape = jax.eval_shape(lambda p: dense(p, ref_pred), params).shape
    target = jax.random.uniform(jax.random.PRNGKey(seed), shape)

    def loss_fn(predict, pred):
        def loss(p):
            out = predict(p, pred)
            return jnp.sum((out - target) ** 2), out
        return jax.jit(jax.value_and_grad(loss, has_aux=True))

    with jax.default_matmul_precision('highest'):
        (l_ref, out_ref), g_ref = loss_fn(dense, ref_pred)(params)
        out_ref = np.asarray(out_ref)
    l_ref = float(l_ref)
    lines = []
    for dtype in ('float32', 'bfloat16'):
        pred = dataclasses.replace(ref_pred, compute_dtype=dtype)
        with jax.default_matmul_precision('highest'):
            (l_c, out_c), g_c = loss_fn(compact, pred)(params)
        out_c = np.asarray(out_c)
        _check(np.isfinite(out_c).all(), f'{name} {dtype}: non-finite')
        fwd = float(np.abs(out_c - out_ref).max() / np.abs(out_ref).max())
        tinj_ref = float(g_ref['t_injection'])
        tinj_c = float(g_c['t_injection'])
        tinj_rel = abs(tinj_c - tinj_ref) / max(abs(tinj_ref), 1e-30)
        loss_rel = abs(float(l_c) - l_ref) / abs(l_ref)
        errs, coss = [], []
        for layer in g_ref:
            if layer == 't_injection':
                continue
            for leaf in ('kernel', 'bias'):
                a = np.asarray(g_ref[layer][leaf]).ravel()
                b = np.asarray(g_c[layer][leaf]).ravel()
                errs.append(float(np.abs(a - b).max()
                                  / max(np.abs(a).max(), 1e-30)))
                if leaf == 'kernel':
                    coss.append(float(a @ b / max(
                        np.linalg.norm(a) * np.linalg.norm(b), 1e-30)))
        lines.append(f'{dtype}: fwd_rel={fwd:.2e} '
                     f'grad_max_norm_err={max(errs):.2e} '
                     f'min_cos={min(coss):.6f} loss_rel={loss_rel:.2e} '
                     f't_inj_grad={tinj_c:.4e}/{tinj_ref:.4e}')
        if dtype == 'float32':
            _check(fwd <= F32_FWD_RTOL, f'{name} f32 forward {fwd:.2e}')
            _check(max(errs) <= F32_GRAD_TOL,
                   f'{name} f32 gradient {max(errs):.2e}')
            _check(tinj_rel <= F32_TINJ_RTOL,
                   f'{name} f32 t_injection gradient {tinj_rel:.2e}')
        else:
            _check(min(coss) > cos_min,
                   f'{name} bf16 gradient cosine {min(coss):.6f}')
            _check(loss_rel < BF16_LOSS_RTOL,
                   f'{name} bf16 loss {loss_rel:.2e}')
    _log(1, t0, f'{name}: {crt.coords.shape[-1]} compact of '
         f'{int(np.prod(rt.coords.shape[1:]))} samples, '
         f'{t_frames_M.shape[0]} frames | ' + ' | '.join(lines))


def phase_reference(sz, rt):
    import jax.numpy as jnp
    import bench
    from bhnerf_jax.train.step import compact_raytracing_args

    pred = _predictor(sz)
    crt = compact_raytracing_args(rt, pred)
    t_m = jnp.asarray(np.linspace(0.0, 90.0, sz.batch), jnp.float32)
    _compare_case(f'image {sz.npix}x{sz.npix}x{sz.ngeo}', rt, crt, pred,
                  t_m, 0, sz.bf16_cos_min)
    alma_rt = bench.synthetic_polarized_rt(sz.alma_npix, sz.ngeo, FOV,
                                           pred, seed=0)
    alma_crt = compact_raytracing_args(alma_rt, pred, layout='gather')
    _compare_case(f'alma lightcurve {sz.alma_npix}x{sz.alma_npix}x'
                  f'{sz.ngeo} gather', alma_rt, alma_crt, pred, t_m, 1,
                  sz.bf16_cos_min, lightcurve=True)


# ---------------------------------------------------------------------------
# phase 2: image trainer + device geodesics
# ---------------------------------------------------------------------------
# device f32 trace vs host f64 trace: quantile bars over all samples
# (near-critical rays may exceed any max bound; judged on quantiles)
GEOS_P90_R_REL = 1e-4
GEOS_P90_THETA = 1e-3
GEOS_P90_T = 1e-3


def phase_image_trainer(sz, geos, rt, t_frames, Omega, t_injection):
    import jax
    from bhnerf_jax import constants, emission
    from bhnerf_jax.geodesics import image_plane_geos
    from bhnerf_jax.train import Optimizer, TrainStep, total_movie_loss
    from bhnerf_jax.train.step import compact_raytracing_args

    t0 = time.perf_counter()
    r_isco = float(constants.isco_pro(0.2))
    hotspot = emission.generate_hotspot(
        resolution=(64, 64, 64), rot_axis=[0, 0, 1], rot_angle=0.0,
        orbit_radius=6.0, std=0.7, r_isco=r_isco, fov=FOV)
    movie = np.asarray(emission.image_plane_dynamics(
        hotspot, geos, Omega, t_frames, t_injection))
    _check(np.isfinite(movie).all() and movie.max() > 0,
           'ground-truth movie is empty or non-finite')
    pred = _predictor(sz, rmin=2.0, compute_dtype='bfloat16')
    crt = compact_raytracing_args(rt, pred)
    train_step = TrainStep.image(t_frames, movie, pred, dtype='full')
    opt = Optimizer({'num_iters': sz.train_steps, 'lr_init': 5e-3,
                     'lr_final': 5e-4}, pred, crt)
    loss0 = total_movie_loss(sz.batch, opt.state, train_step, crt)
    t1 = time.perf_counter()
    opt.run(batchsize=sz.batch, train_step=train_step, raytracing_args=crt,
            verbose=False, scan_chunk=sz.scan_chunk)
    jax.block_until_ready(opt.state.params)
    t_train = time.perf_counter() - t1
    loss1 = total_movie_loss(sz.batch, opt.state, train_step, crt)
    _check(np.isfinite(loss1), f'final loss {loss1} not finite')
    _check(loss1 < sz.loss_drop * loss0,
           f'loss did not drop: {loss0} -> {loss1}')
    _log(2, t0, f'image trainer {sz.npix}x{sz.npix}x{sz.ngeo}, '
         f'{sz.nt} frames, batch {sz.batch}, bf16, {sz.train_steps} steps '
         f'in chunks of {sz.scan_chunk} ({t_train:.1f} s incl. compile): '
         f'movie loss {loss0:.4e} -> {loss1:.4e}; samples in domain '
         f'{crt.coords.shape[-1]}')

    t0 = time.perf_counter()
    kw = dict(spin=0.2, inclination=np.deg2rad(60.0),
              alpha_range=(-FOV / 2, FOV / 2),
              beta_range=(-FOV / 2, FOV / 2), ngeo=sz.ngeo,
              num_alpha=sz.geos_check_npix, num_beta=sz.geos_check_npix)
    g64 = image_plane_geos(**kw, backend='cpu')
    g32 = image_plane_geos(**kw, backend='device')
    dr = np.abs(g32.r - g64.r) / np.maximum(g64.r, 1.0)
    dth = np.abs(g32.theta - g64.theta)
    dt = np.abs(g32.t - g64.t)
    q = {k: float(np.quantile(v, 0.9))
         for k, v in (('r_rel', dr), ('theta', dth), ('t', dt))}
    _log(2, t0, f'device f32 vs host f64 geodesics '
         f'{sz.geos_check_npix}x{sz.geos_check_npix}x{sz.ngeo}: p90 '
         + ' '.join(f'{k}={v:.2e}' for k, v in q.items()))
    _check(q['r_rel'] < GEOS_P90_R_REL and q['theta'] < GEOS_P90_THETA
           and q['t'] < GEOS_P90_T, f'device geodesics off: {q}')


# ---------------------------------------------------------------------------
# phase 3: ALMA polarized lightcurve ensemble step
# ---------------------------------------------------------------------------
def phase_alma(sz):
    import jax
    import jax.numpy as jnp
    import bench
    from bhnerf_jax.train import TrainState, make_optimizer
    from bhnerf_jax.train.step import (compact_ensemble_args,
                                       make_scan_step, stack_ensemble)

    t0 = time.perf_counter()
    pred = _predictor(sz, compute_dtype='bfloat16')
    rt_list = [bench.synthetic_polarized_rt(sz.alma_npix, sz.ngeo, FOV,
                                            pred, seed=s)
               for s in range(sz.alma_variants)]
    crt_list = compact_ensemble_args(rt_list, pred, layout='gather')
    stacked = stack_ensemble(crt_list)
    rng = np.random.default_rng(1)
    target = jnp.asarray(rng.random((sz.nt, 3), dtype=np.float32))
    sigma = jnp.ones_like(target)
    offset = jnp.zeros_like(target)
    t_all = jnp.asarray(np.linspace(0.0, 1.0, sz.nt, dtype=np.float32))
    scan_fn = make_scan_step(predictor=pred, kind='image', dtype='lc',
                             batchsize=sz.batch,
                             chunk=sz.scan_chunk,
                             num_variants=sz.alma_variants)
    state = TrainState.create(pred.init_params(seed=0),
                              make_optimizer(50000))
    losses = []
    for i in range(3):
        state, ls = scan_fn(state, target, sigma, offset, t_all,
                            jax.random.PRNGKey(i), stacked, 1.0)
        losses.append(np.asarray(ls))
    losses = np.concatenate(losses)
    _check(np.isfinite(losses).all(), 'ALMA losses not finite')
    _log(3, t0, f'alma {sz.alma_npix}x{sz.alma_npix}x{sz.ngeo}, 3 Stokes, '
         f'{sz.alma_variants} variants, {losses.size} scan steps: loss '
         f'{losses[0]:.4e} -> {losses[-1]:.4e}; samples/variant '
         f'{crt_list[0].coords.shape[-1]}')


# ---------------------------------------------------------------------------
# phase 4: EHT visibility step, dense and factored operators
# ---------------------------------------------------------------------------
# chi^2 of the two operators at one parameter set, both evaluated at
# matmul precision "highest": they are the same DFT factored two ways,
# so they agree to float32 summation order
EHT_CHI2_RTOL = 1e-4


def phase_eht(sz, geos, rt):
    import jax
    from bhnerf_jax import constants, observation, units
    from bhnerf_jax.train import TrainState, TrainStep, make_optimizer
    from bhnerf_jax.train.step import (apply_measurement_operator,
                                       compact_raytracing_args,
                                       image_plane_prediction, loss_fn_eht,
                                       make_scan_step)

    t0 = time.perf_counter()
    pred = _predictor(sz, compute_dtype='bfloat16')
    crt = compact_raytracing_args(rt, pred)
    nt, num = sz.nt, sz.npix
    t_hr = np.linspace(4.0, 15.5, nt).astype(np.float32)
    rng = np.random.default_rng(0)
    movie = rng.random((nt, num, num), dtype=np.float32)
    here = os.path.dirname(os.path.abspath(__file__))
    array = observation.load_txt(os.path.join(here, 'eht_arrays',
                                              'ngEHT.txt'))
    obs_empty = observation.empty_eht_obs(array, nt=nt, tint=30.0)
    fov_rad = float(FOV * constants.GM_c2(constants.sgra_mass).value
                    / constants.sgra_distance.to('m').value)
    obs = observation.observe_same(movie, t_hr, fov_rad / num, obs_empty,
                                   thermal_noise=True, seed=0)
    params = pred.init_params(seed=0)
    out_key = f'dense_{pred.net_depth}'
    params[out_key]['bias'] = params[out_key]['bias'] + 9.0
    # chi^2 target: the dense operator's visibilities of ANOTHER parameter
    # set, so the chi^2 measures model differences (against the thermal-
    # noise data the model's few-Jy visibilities would not register)
    params_b = pred.init_params(seed=1)
    params_b[out_key]['bias'] = params_b[out_key]['bias'] + 8.0
    chi2, notes, target_vis = {}, [], None
    for op in ('dense', 'factored'):
        ts = TrainStep.eht(units.Quantity(t_hr, 'hr'), obs, fov_rad, num,
                           pred, dtype='vis', operator=op)
        dev_args = ts.args[0].device_args
        scan_fn = make_scan_step(batchsize=sz.batch, chunk=sz.eht_steps,
                                 **ts.scan_meta)
        state = TrainState.create(pred.init_params(seed=0),
                                  make_optimizer(50000))
        state, losses = scan_fn(state, *dev_args, jax.random.PRNGKey(0),
                                crt, 1.0)
        losses = np.asarray(losses)
        _check(np.isfinite(losses).all(), f'EHT {op} losses not finite')
        _, sigma, A, t_fr = (x[:sz.batch] for x in dev_args)
        t_m = crt.frame_times_M(t_fr)
        with jax.default_matmul_precision('highest'):
            if target_vis is None:
                target_vis = apply_measurement_operator(
                    image_plane_prediction(params_b, pred, t_m, crt), A)
            chi2[op] = float(jax.jit(
                lambda p, tg, sg, a: loss_fn_eht(
                    p, pred, tg, sg, a, t_m, crt, 1.0, 'vis')[0])(
                        params, target_vis, sigma, A))
        notes.append(f'{op}: {losses.size} steps loss {losses[0]:.4e} -> '
                     f'{losses[-1]:.4e}, nvis/frame {A.shape[-2]}, '
                     f'chi2 {chi2[op]:.6e}')
    rel = abs(chi2['dense'] - chi2['factored']) / abs(chi2['dense'])
    _log(4, t0, f'eht ngEHT npix {num}: ' + ' | '.join(notes)
         + f' | chi2 rel diff {rel:.2e}')
    _check(chi2['dense'] > 0, 'degenerate chi2 comparison')
    _check(rel < EHT_CHI2_RTOL, f'dense vs factored chi2 differ {rel:.2e}')


# ---------------------------------------------------------------------------
# phase 5 (--multi): four devices against one
# ---------------------------------------------------------------------------
# one scan chunk from the same state and key on 1 device and on a
# 4-device mesh: same math, different summation order (psum over
# devices); float32 compute so the comparison sees no bf16 rounding.
# Losses agree to 1e-4 relative. Adam moves a parameter by ~lr per step
# whatever the size of its gradient, so a parameter whose gradient is ~0
# may step the other way under another summation order: parameters are
# held to steps x lr.
MULTI_LOSS_RTOL = 1e-4
MULTI_LR = 1e-4


def phase_multi(sz, rt, t_frames, n_dev=4):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from bhnerf_jax.parallel import create_mesh, replicate
    from bhnerf_jax.train import TrainState, make_optimizer
    from bhnerf_jax.train.step import compact_raytracing_args, make_scan_step

    devs = jax.devices()[:n_dev]
    _check(len(devs) == n_dev, f'--multi needs {n_dev} devices, found '
                               f'{len(jax.devices())}')
    pred = _predictor(sz, compute_dtype='float32')
    rng = np.random.default_rng(0)
    nt = sz.nt
    target = rng.random((nt, sz.npix, sz.npix), dtype=np.float32)
    frames = [target, np.ones_like(target), np.zeros_like(target),
              np.asarray(t_frames.value, np.float32)]
    scan_fn = make_scan_step(predictor=pred, kind='image', dtype='full',
                             batchsize=sz.batch, chunk=sz.multi_steps)

    def run(crt, frame_args, state):
        state, losses = scan_fn(state, *frame_args, jax.random.PRNGKey(7),
                                crt, 1.0)
        return np.asarray(losses), jax.tree_util.tree_map(np.asarray,
                                                          state.params)

    def fresh():
        return TrainState.create(pred.init_params(seed=0),
                                 make_optimizer(1000, lr_init=MULTI_LR))

    def compare(name, t0, ref, got):
        l_rel = float(np.max(np.abs(got[0] - ref[0]) / np.abs(ref[0])))
        p_err = max(float(np.abs(a - b).max()) for a, b in zip(
            jax.tree_util.tree_leaves(ref[1]),
            jax.tree_util.tree_leaves(got[1])))
        _log(5, t0, f'{name}: losses {got[0][0]:.6e} -> {got[0][-1]:.6e} '
             f'(1 device {ref[0][0]:.6e} -> {ref[0][-1]:.6e}); max loss '
             f'rel diff {l_rel:.2e}, max param diff {p_err:.2e}')
        _check(l_rel < MULTI_LOSS_RTOL
               and p_err <= sz.multi_steps * MULTI_LR,
               f'{name} disagrees with one device')

    t0 = time.perf_counter()
    crt1 = compact_raytracing_args(rt, pred)
    one = run(crt1, [jnp.asarray(x) for x in frames], fresh())
    _log(5, t0, f'one device: {sz.multi_steps} scan steps, n={crt1.npix} '
         f'pixels, {crt1.coords.shape[-1]} samples')

    t0 = time.perf_counter()
    mesh = create_mesh((n_dev, 1), devices=devs)
    sh = NamedSharding(mesh, P('data'))
    got = run(replicate(crt1, mesh),
              [jax.device_put(jnp.asarray(x), sh) for x in frames],
              replicate(fresh(), mesh))
    compare(f'frame-DP scan step, mesh data={n_dev}', t0, one, got)

    t0 = time.perf_counter()
    mesh = create_mesh((1, n_dev), devices=devs)
    crt4 = compact_raytracing_args(rt, pred, mesh=mesh)
    _check(crt4.num_shards == n_dev, 'sample-parallel layout not built')
    rep = NamedSharding(mesh, P())
    got = run(crt4, [jax.device_put(jnp.asarray(x), rep) for x in frames],
              replicate(fresh(), mesh))
    compare(f'sample-parallel shard_map scan step, ray={n_dev}', t0, one,
            got)


# ---------------------------------------------------------------------------
def run(sz=FULL, multi=False, require_gpu=True):
    """Run the phases; returns the device summary for the last line."""
    import jax
    from bhnerf_jax.utils import enable_compilation_cache
    enable_compilation_cache()
    dev = phase_device(require_gpu)
    t0 = time.perf_counter()
    geos, rt, t_frames, Omega, t_injection = _image_problem(sz)
    _log(0, t0, f'device-traced geodesics {sz.npix}x{sz.npix}x{sz.ngeo}')
    if multi:
        phase_multi(sz, rt, t_frames)
    else:
        phase_reference(sz, rt)
        phase_image_trainer(sz, geos, rt, t_frames, Omega, t_injection)
        phase_alma(sz)
        phase_eht(sz, geos, rt)
    return {'platform': dev.platform, 'kind': dev.device_kind,
            'count': len(jax.devices())}


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--multi', action='store_true',
                    help='run only the four-GPU phase and its one-GPU '
                         'comparison')
    args = ap.parse_args(argv)
    # the host f64 geodesic reference of phase 2 runs on the CPU backend
    # (set before JAX starts)
    plat = os.environ.get('JAX_PLATFORMS', '')
    if plat and 'cpu' not in plat.split(','):
        os.environ['JAX_PLATFORMS'] = plat + ',cpu'
    t0 = time.perf_counter()
    device = run(FULL, multi=args.multi)
    print(f'chip_smoke: all phases passed in '
          f'{time.perf_counter() - t0:.1f} s', flush=True)
    print(json.dumps({'ok': True, 'device': device}))


if __name__ == '__main__':
    main()
