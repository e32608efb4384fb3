"""Fit synthetic linear-polarization flare data of Sagittarius A*.

JAX port of reference scripts/Fit_Synthetic_LP_Flares.py: two-YAML
merge (simulation + recovery), inclination grid x seeds, time-based
train/validation split, tensorboard + checkpoints, skip-if-exists resume.
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
    parser.add_argument('yaml_path', type=str,
                        help='Path to data configuration (.yaml) with '
                             'lightcurve_path / flare_path / name keys')
    parser.add_argument('inc', type=int, nargs='+',
                        help='Inclination angle, or (num_blocks, index)')
    parser.add_argument('--start_inc', type=float)
    parser.add_argument('--seeds', type=int, nargs='+')
    parser.add_argument('--config_path', type=str,
                        default=str(Path(__file__).with_name(
                            'fit_synthetic_lp_flares.yaml')))
    return parser.parse_args()


def main():
    import yaml

    from bhnerf_jax import alma, config as config_lib, units, utils
    from bhnerf_jax.models import NeRFPredictor
    from bhnerf_jax.train import LogFn, Optimizer, TrainStep
    from bhnerf_jax.train.logging import SummaryWriter
    from bhnerf_jax.train.step import compact_ensemble_args
    from tqdm import tqdm
    import pandas as pd

    basename = 'inc_{:.1f}.seed_{}'
    args = parse_args()

    simulation_params = yaml.safe_load(Path(args.yaml_path).read_text())
    recovery = config_lib.RunConfig.from_yaml(args.config_path)
    recovery_raw = yaml.safe_load(Path(args.config_path).read_text())
    # dict-union merge: only the keys the recovery YAML actually sets
    # override the simulation model (reference Fit_Synthetic...py:59)
    model_params = dict(simulation_params.get('model', {}))
    model_params.update(recovery_raw.get('model', {}))
    opt_cfg = recovery.optimization
    stokes = opt_cfg.stokes

    # load + split lightcurve data
    data_path = Path(simulation_params['lightcurve_path'])
    lightcurves_df = pd.read_csv(data_path)
    target = np.array(lightcurves_df[stokes])
    t_vals = np.array(lightcurves_df['t'])
    t_start_obs = model_params['t_start_obs']
    split_hr = t_start_obs + opt_cfg.train_split / 60.0
    train_idx = t_vals <= split_hr
    data_train, data_val = target[train_idx], target[~train_idx]
    t_train = units.Quantity(t_vals[train_idx], 'hr')
    t_val = units.Quantity(t_vals[~train_idx], 'hr')

    spin = model_params['spin']
    fov_M = model_params['fov_M']
    rmax = fov_M / 2
    rmin = model_params['rmin']
    if rmin == 'ISCO':
        from bhnerf_jax import constants
        rmin = float(constants.isco_pro(spin))
    model_params.update(rmax=rmax, rmin=rmin)

    predictor = NeRFPredictor(
        scale=rmax, rmin=rmin, rmax=rmax,
        z_width=model_params['z_width'],
        posenc_var=model_params.get('recovery_scale', 1.0) / fov_M)
    train_step = TrainStep.image(t_train, data_train, predictor,
                                 sigma=np.asarray(opt_cfg.sigma),
                                 dtype='lc')

    sim_name = simulation_params.get('name', data_path.stem)
    recovery_dir = data_path.parent / 'recovery' / sim_name
    recovery_dir.mkdir(parents=True, exist_ok=True)
    with open(recovery_dir / 'params.yaml', 'w') as f:
        yaml.dump({'simulation': simulation_params,
                   'recovery': {'model': model_params}}, f,
                  default_flow_style=False)

    # ground-truth flare volume for 3D PSNR logging (.npz with
    # data/start/stop — this package's Grid3D serialization)
    emission_flare = None
    flare_path = simulation_params.get('flare_path')
    if flare_path and Path(flare_path).exists():
        blob = np.load(flare_path)
        emission_flare = utils.Grid3D(
            model_params.get('emission_scale', 1.0) * blob['data'],
            tuple(blob['start']), tuple(blob['stop']))

    inc_grid = config_lib.inclination_grid(args.inc, args.start_inc)
    hparams = opt_cfg.hparams.asdict()
    seeds = args.seeds if args.seeds else [hparams['seed']]

    for inclination in tqdm(inc_grid, desc='inc'):
        raytracing_args = alma.get_raytracing_args(
            np.deg2rad(inclination), spin, model_params, stokes,
            num_subpixel_rays=model_params.get('num_subrays', 1))
        # uniform compaction keeps the sub-pixel ensemble on the
        # compact scan-chunked path (variant drawn in-scan)
        raytracing_args = compact_ensemble_args(
            raytracing_args, predictor, layout='gather')

        for seed in tqdm(seeds, desc='seed', leave=False):
            runname = basename.format(inclination, seed)
            checkpoint_dir = recovery_dir / runname
            if checkpoint_dir.exists():
                continue

            writer = SummaryWriter(logdir=str(checkpoint_dir))
            if emission_flare is not None:
                writer.add_images(
                    'emission/true',
                    utils.intensity_to_nchw(np.asarray(
                        emission_flare.data)),
                    dataformats='NCWH', global_step=0)
            log_fns = [
                LogFn(lambda opt: writer.add_scalar(
                    'log_loss/train', np.log10(np.mean(opt.loss)),
                    global_step=opt.step)),
                LogFn(lambda opt: writer.recovery_3d(
                    fov_M, emission_true=emission_flare)(opt),
                    log_period=opt_cfg.log_period),
                LogFn(lambda opt: writer.plot_lc_datafit(
                    opt, 'training', train_step, data_train, stokes,
                    t_vals[train_idx], batchsize=20),
                    log_period=opt_cfg.log_period),
            ]

            hparams['seed'] = seed
            optimizer = Optimizer(hparams, predictor, raytracing_args,
                                  save_period=opt_cfg.save_period,
                                  checkpoint_dir=str(checkpoint_dir))
            optimizer.run(opt_cfg.batchsize, train_step, raytracing_args,
                          log_fns=log_fns, scan_chunk=opt_cfg.scan_chunk)
            writer.close()


if __name__ == '__main__':
    main()
