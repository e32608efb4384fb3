"""Fit the April 11 ALMA linear polarization of Sagittarius A*.

JAX port of reference scripts/Fit_ALMA_LP_Apr11_SgrA_Flare.py:
fits the Q-U-loop period after the X-ray flare (Wielgus et al. 2022)
over an inclination grid x seeds with tensorboard logging and
checkpoint-based sweep resume.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))
import warnings
from pathlib import Path

import numpy as np

warnings.simplefilter('ignore')


def parse_args():
    parser = argparse.ArgumentParser()
    parser.add_argument('inc', type=int, nargs='+',
                        help='Inclination angle, or (num_blocks, index) to '
                             'split the [4, 80] deg grid')
    parser.add_argument('--start_inc', type=float,
                        help='Start after this angle.')
    parser.add_argument('--seeds', type=int, nargs='+',
                        help='Seeds for network weight initialization.')
    parser.add_argument('--data_path', type=str,
                        default='../data/Apr11_HI.dat',
                        help='Path to ALMA April 11 2017 data (HI band)')
    parser.add_argument('--config_path', type=str,
                        default=str(Path(__file__).with_name(
                            'fit_alma_lp_apr11_sgra_flare.yaml')),
                        help='Path to configuration YAML file')
    parser.add_argument('--resume', action='store_true',
                        help='Resume INCOMPLETE runs mid-schedule from '
                             'their latest checkpoint instead of skipping '
                             'existing run dirs (the default sweep-level '
                             'resume, reference alma.py:109). Finished '
                             'runs are still skipped.')
    return parser.parse_args()


def main():
    import jax

    import bhnerf_jax as bh
    from bhnerf_jax import alma, config as config_lib, units
    from bhnerf_jax.models import NeRFPredictor
    from bhnerf_jax.train import LogFn, Optimizer, TrainStep
    from bhnerf_jax.train.logging import SummaryWriter
    from bhnerf_jax.train.step import compact_ensemble_args
    from tqdm import tqdm

    basename = 'inc_{:.1f}.seed_{}'
    args = parse_args()
    if os.environ.get('DRIVE_CPU'):      # drive rehearsals pin the host
        jax.config.update('jax_platforms', 'cpu')
    # backend visibility: a run that lands on the CPU is ~300x slower —
    # make that diagnosable from the log
    print(f'# jax devices: {jax.devices()}', flush=True)
    cfg = config_lib.RunConfig.from_yaml(args.config_path)
    if args.data_path:
        cfg.preprocess.data_path = args.data_path
    opt_cfg = cfg.optimization

    ckpt_root = Path(opt_cfg.checkpoint_dir)
    ckpt_root.mkdir(parents=True, exist_ok=True)
    cfg.to_yaml(ckpt_root / 'config.yml')

    # Preprocess / train-validation split in time
    target, t_frames = alma.preprocess_data(
        **config_lib.dataclasses.asdict(cfg.preprocess))
    t_start = cfg.preprocess.t_start
    split = units.Quantity(t_start, 'hr') + units.Quantity(
        opt_cfg.train_split, 'min')
    t_vals = np.asarray(units.Quantity(t_frames, 'hr').value)
    train_idx = t_vals <= split.to('hr').value
    data_train, data_val = target[train_idx], target[~train_idx]
    t_train = units.Quantity(t_vals[train_idx], 'hr')
    t_val = units.Quantity(t_vals[~train_idx], 'hr')

    model = cfg.model
    rmax = model.fov_M / 2
    rmin = model.resolved_rmin()
    predictor = NeRFPredictor(scale=rmax, rmin=rmin, rmax=rmax,
                              z_width=model.z_width)
    train_step = TrainStep.image(t_train, data_train, predictor,
                                 sigma=np.asarray(opt_cfg.sigma),
                                 dtype='lc')
    val_step = TrainStep.image(t_val, data_val, predictor,
                               sigma=np.asarray(opt_cfg.sigma), dtype='lc')
    rot_angle = np.deg2rad(cfg.preprocess.de_rot_angle + 20.0)

    inc_grid = config_lib.inclination_grid(args.inc, args.start_inc)
    hparams = opt_cfg.hparams.asdict()
    seeds = args.seeds if args.seeds else [hparams['seed']]

    for inclination in tqdm(inc_grid, desc='inc'):
        raytracing_args = alma.get_raytracing_args(
            np.deg2rad(inclination), model.spin, model.asdict(),
            rot_angle=rot_angle, num_subpixel_rays=model.num_subrays)
        # domain compaction (uniformly padded across the sub-pixel
        # ensemble) puts the whole fit — including the in-scan per-step
        # variant draw — on the compact scan-chunked path
        raytracing_args = compact_ensemble_args(
            raytracing_args, predictor, layout='gather')

        for seed in tqdm(seeds, desc='seed', leave=False):
            runname = basename.format(inclination, seed)
            checkpoint_dir = ckpt_root / runname
            resuming = checkpoint_dir.exists()
            if resuming and not args.resume:
                continue  # sweep-level resume (reference alma.py:109)

            writer = SummaryWriter(logdir=os.path.join(opt_cfg.log_dir,
                                                       runname))
            log_fns = [
                LogFn(lambda opt: writer.add_scalar(
                    'log_loss/train', np.log10(np.mean(opt.loss)),
                    global_step=opt.step)),
                LogFn(lambda opt: writer.recovery_3d(model.fov_M)(opt),
                      log_period=opt_cfg.log_period),
                LogFn(lambda opt: writer.plot_lc_datafit(
                    opt, 'training', train_step, data_train,
                    ['I', 'Q', 'U'], t_vals[train_idx], batchsize=20),
                    log_period=opt_cfg.log_period),
                LogFn(lambda opt: writer.plot_lc_datafit(
                    opt, 'validation', val_step, data_val,
                    ['I', 'Q', 'U'], t_vals[~train_idx], batchsize=20),
                    log_period=opt_cfg.log_period),
            ]

            hparams['seed'] = seed
            optimizer = Optimizer(hparams, predictor, raytracing_args,
                                  save_period=opt_cfg.save_period,
                                  checkpoint_dir=str(checkpoint_dir))
            if resuming:
                # Optimizer.__init__ restored the latest checkpoint;
                # num_iters means "iterations from here", so finish the
                # CONFIGURED total schedule (this is the path a preempted
                # pod rerun takes — drilled by drive_alma_production.py)
                done = int(np.asarray(jax.device_get(
                    optimizer.state.step)))
                remaining = int(hparams['num_iters']) - done
                print(f'# resume: {runname} from step {done}, '
                      f'{remaining} remaining', flush=True)
                if remaining <= 0:
                    writer.close()
                    continue  # already finished
                optimizer.num_iters = remaining
            optimizer.run(opt_cfg.batchsize, train_step, raytracing_args,
                          log_fns=log_fns, scan_chunk=opt_cfg.scan_chunk)
            writer.close()


if __name__ == '__main__':
    main()
