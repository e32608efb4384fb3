"""Production drive: ONE full production ALMA fit on a GPU.

Runs scripts/fit_alma_lp_apr11_sgra_flare.py — the real entry point —
at the production settings (50,000 iterations, 10-variant sub-pixel
ensemble, batchsize 6, log_period 500 with live tensorboard LogFns,
periodic checkpoints) on a synthetic-equivalent Apr11 CSV (the real
.dat is not in the image; the synthetic QU-loop lightcurve has the
same cadence, window, shadow polarization, and Faraday rotation as
reference scripts/Fit_ALMA_LP_Apr11_SgrA_Flare.py expects).

Also drills mid-run preemption at production scale: SIGTERM once a
periodic checkpoint exists, then resume from the forced checkpoint to
the full 50k. Prints wall time + final train/val chi^2 as one JSON line.

One process per card: this parent never imports JAX; the fit, the
resumed fit and the chi^2 evaluation run as children one after another,
so only one process holds the GPU at any time.

Run: timeout 3600 python scripts/drive_alma_production.py
     [--num-iters N] (default 50000)
"""
import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np


def make_synthetic_csv(path):
    """Apr11-equivalent lightcurve: 4 s cadence over the fit window,
    a ~70 min QU loop + the constant shadow polarization + Faraday
    rotation that preprocess_data expects to remove."""
    import pandas as pd
    rng = np.random.default_rng(11)
    t = 9.30 + np.arange(2400) * 4.0 / 3600        # 9.30h .. 11.97h
    period = 70.0 / 60.0                            # hr (Wielgus QU loop)
    phase = 2 * np.pi * t / period
    de_rot = np.deg2rad(32.2)
    q_int = 0.08 * np.cos(2 * phase) * np.exp(-(t - 10.2) ** 2 / 1.0)
    u_int = 0.08 * np.sin(2 * phase) * np.exp(-(t - 10.2) ** 2 / 1.0)
    # forward-rotate by the Faraday angle the pipeline de-rotates
    Q = q_int * np.cos(2 * de_rot) - u_int * np.sin(2 * de_rot)
    U = q_int * np.sin(2 * de_rot) + u_int * np.cos(2 * de_rot)
    chi_sha = np.deg2rad(-37.0)
    Q = Q + 0.16 * np.cos(2 * chi_sha) + 1e-3 * rng.standard_normal(t.size)
    U = U + 0.16 * np.sin(2 * chi_sha) + 1e-3 * rng.standard_normal(t.size)
    I = 2.4 + 0.05 * np.cos(phase) + 1e-3 * rng.standard_normal(t.size)
    pd.DataFrame({'time': t, 'I': I, 'Q': Q, 'U': U}).to_csv(path)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--num-iters', type=int, default=50000)
    args = ap.parse_args()

    import yaml
    work = tempfile.mkdtemp(prefix='alma_prod_')
    csv_path = os.path.join(work, 'apr11_synth.csv')
    make_synthetic_csv(csv_path)

    cfg = yaml.safe_load(open(os.path.join(
        REPO, 'scripts', 'fit_alma_lp_apr11_sgra_flare.yaml')))
    cfg['optimization']['log_dir'] = os.path.join(work, 'runs')
    cfg['optimization']['checkpoint_dir'] = os.path.join(work, 'ckpt')
    cfg['optimization']['save_period'] = min(5000,
                                             max(args.num_iters // 3, 1))
    cfg['optimization']['hparams']['num_iters'] = args.num_iters
    cfg['model']['num_subrays'] = 10           # production ensemble
    if os.environ.get('DRIVE_CPU'):            # logic rehearsal shrink
        cfg['model']['num_alpha'] = cfg['model']['num_beta'] = 16
        cfg['model']['num_subrays'] = 2
    cfg_path = os.path.join(work, 'config.yaml')
    yaml.safe_dump(cfg, open(cfg_path, 'w'))

    inc = 60
    seed = int(cfg['optimization']['hparams']['seed'])
    run_dir = os.path.join(cfg['optimization']['checkpoint_dir'],
                           f'inc_{float(inc):.1f}.seed_{seed}')
    save_period = int(cfg['optimization']['save_period'])

    # PREPEND to PYTHONPATH, never replace an ambient path
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get('PYTHONPATH', '')) if p))
    fit = [sys.executable,
           os.path.join(REPO, 'scripts', 'fit_alma_lp_apr11_sgra_flare.py'),
           str(inc), '--data_path', csv_path, '--config_path', cfg_path]

    # ---- leg 1: launch the production fit, SIGTERM mid-run ------------
    # Child output goes to a FILE, not a pipe: tqdm refreshes ~10x/s on
    # stderr and fills a 64 KB pipe within a minute, blocking the child
    # on write() before the first checkpoint.
    t0 = time.time()
    leg1_log = os.path.join(work, 'fit_leg1.log')

    def leg1_tail():
        with open(leg1_log, 'r', errors='replace') as f:
            return f.read()[-2000:]

    with open(leg1_log, 'w') as logf:
        p = subprocess.Popen(fit, stdout=logf, stderr=subprocess.STDOUT,
                             text=True, env=env)
    first_ckpt = os.path.join(run_dir, f'checkpoint_{save_period}')
    devices_checked = False
    while not os.path.exists(first_ckpt):
        if p.poll() is not None:
            print(leg1_tail())
            raise SystemExit('fit died before the first periodic '
                             'checkpoint')
        if time.time() - t0 > 3000:
            p.kill()
            print(leg1_tail())
            raise SystemExit('timeout before first periodic checkpoint')
        if not devices_checked and not os.environ.get('DRIVE_CPU'):
            # fail fast if the child landed on the CPU (it would burn the
            # whole timeout at ~2 s/step)
            # Read a generous window (import-time warnings can push the
            # banner well past 4 KB) and only judge a COMPLETE line —
            # a banner straddling the read boundary must not false-kill.
            with open(leg1_log, 'r', errors='replace') as f:
                head = f.read(262144)
            lines = [l for l in head.splitlines(keepends=True)
                     if l.startswith('# jax devices:')
                     and l.endswith('\n')]
            if lines:
                devices_checked = True
                if 'CudaDevice' not in lines[0]:
                    p.kill()
                    raise SystemExit(
                        f'fit is NOT on a GPU: {lines[0].strip()!r}')
        time.sleep(2.0)
    time.sleep(1.0)                             # land mid-chunk
    p.send_signal(signal.SIGTERM)
    p.wait(timeout=600)
    assert p.returncode == 0, f'fit rc={p.returncode}:\n{leg1_tail()}'
    from bhnerf_jax.train.state import latest_checkpoint_step
    stop_step = latest_checkpoint_step(run_dir)
    assert stop_step and stop_step < args.num_iters, stop_step
    print(f'# leg1: SIGTERM at step {stop_step} '
          f'({time.time() - t0:.0f}s in), clean exit', flush=True)

    # ---- leg 2: resume from the forced checkpoint to the full count ---
    # through the REAL entry point's --resume mode (mid-run Optimizer
    # restore; the default sweep-level resume would skip the existing
    # run dir — reference alma.py:109 semantics). The drill therefore
    # exercises exactly the command a preempted pod rerun issues.
    leg2_log = os.path.join(work, 'fit_leg2.log')
    with open(leg2_log, 'w') as logf:
        r = subprocess.run(fit + ['--resume'], stdout=logf,
                           stderr=subprocess.STDOUT, text=True, env=env,
                           timeout=3000)
    leg2_out = open(leg2_log, errors='replace').read()
    print(leg2_out[-3000:])
    assert r.returncode == 0, leg2_out[-2000:]
    # "# resume: inc_60.0.seed_4 from step 5500, 44500 remaining"
    # (searched, not line-anchored: tqdm's cursor escapes share lines)
    import re
    m = re.search(r'# resume: \S+ from step (\d+), (\d+) remaining',
                  leg2_out)
    assert m, 'fit --resume never hit the resume path'
    start = int(m.group(1))
    assert start == stop_step, (start, stop_step)
    final = latest_checkpoint_step(run_dir)
    assert final == args.num_iters, (final, args.num_iters)

    # ---- evaluate: train/val chi^2 of the finished fit ----------------
    r = subprocess.run([sys.executable, '-c', f'''
import os, sys, json
sys.path.insert(0, {REPO!r})
import numpy as np
from bhnerf_jax import alma, config as config_lib, units
cfg = config_lib.RunConfig.from_yaml({cfg_path!r})
cfg.preprocess.data_path = {csv_path!r}
opt_cfg = cfg.optimization
target, t_frames = alma.preprocess_data(
    **config_lib.dataclasses.asdict(cfg.preprocess))
split = units.Quantity(cfg.preprocess.t_start, 'hr') + units.Quantity(
    opt_cfg.train_split, 'min')
t_vals = np.asarray(units.Quantity(t_frames, 'hr').value)
train_idx = t_vals <= split.to('hr').value
model = cfg.model
rt_raw = alma.get_raytracing_args(
    np.deg2rad({inc}), model.spin, model.asdict(),
    rot_angle=np.deg2rad(cfg.preprocess.de_rot_angle + 20.0),
    num_subpixel_rays=model.num_subrays)
sig = np.asarray(opt_cfg.sigma)
chi2_tr = float(alma.chi2_lightcurves(
    rt_raw, {run_dir!r}, units.Quantity(t_vals[train_idx], 'hr'),
    target[train_idx], sigma=sig, batchsize=20))
chi2_va = float(alma.chi2_lightcurves(
    rt_raw, {run_dir!r}, units.Quantity(t_vals[~train_idx], 'hr'),
    target[~train_idx], sigma=sig, batchsize=20))
print('EVAL_RESULT ' + json.dumps(dict(
    chi2_train=chi2_tr, chi2_val=chi2_va)))
'''], capture_output=True, text=True, env=env, timeout=1200)
    print(r.stdout[-1500:])
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    res = json.loads(r.stdout.rsplit('EVAL_RESULT ', 1)[1].splitlines()[0])
    wall = time.time() - t0
    result = {
        'metric': 'alma_production', 'num_iters': args.num_iters,
        'ensemble': 10, 'batchsize': 6, 'wall_s': round(wall, 1),
        'interrupt_step': stop_step,
        'chi2_train': round(res['chi2_train'], 4),
        'chi2_val': round(res['chi2_val'], 4),
        'steps_per_sec_effective': round(args.num_iters / wall, 1),
        'ok': bool(np.isfinite(res['chi2_train'])
                   and np.isfinite(res['chi2_val'])),
    }
    print(json.dumps(result), flush=True)


if __name__ == '__main__':
    main()
