"""Typed configuration for fitting runs.

Replaces the reference's `locals().update(yaml)` pattern
(reference scripts/Fit_Synthetic_LP_Flares.py:56-59 — flagged as fragile
in SURVEY.md §5) with dataclasses while keeping the exact YAML schema of
scripts/*.yaml (preprocess / model / optimization sections).
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Optional

import numpy as np


@dataclasses.dataclass
class PreprocessConfig:
    data_path: str = ''
    window_size: int = 8
    I_hs_mean: float = 0.3
    P_sha: float = 0.16
    chi_sha: float = -37.0
    de_rot_angle: float = 32.2
    t_start: float = 9.33
    t_end: float = 11.8


@dataclasses.dataclass
class ModelConfig:
    spin: float = 0.0
    fov_M: float = 40.0
    z_width: float = 4.0
    rmin: Any = 'ISCO'
    recovery_scale: float = 1.0
    Q_frac: float = 0.85
    b_consts: dict = dataclasses.field(
        default_factory=lambda: {'arad': 0, 'avert': 1, 'ator': 0})
    Omega_dir: str = 'cw'
    Omega_frac: float = 1.0
    num_alpha: int = 64
    num_beta: int = 64
    t_start_obs: float = 9.34056333326589
    num_subrays: int = 1
    emission_scale: float = 1.0

    def resolved_rmin(self):
        from bhnerf_jax import constants
        if self.rmin == 'ISCO':
            return float(constants.isco_pro(self.spin))
        return float(self.rmin)

    def asdict(self):
        return dataclasses.asdict(self)


@dataclasses.dataclass
class HParams:
    num_iters: int = 50000
    lr_init: float = 1e-4
    lr_final: float = 1e-6
    seed: int = 1
    lr_inject: Optional[float] = None

    def __post_init__(self):
        # YAML 1.1 parses exponent-only literals like `1e-4` as strings
        self.num_iters = int(self.num_iters)
        self.lr_init = float(self.lr_init)
        self.lr_final = float(self.lr_final)
        self.seed = int(self.seed)
        if self.lr_inject is not None:
            self.lr_inject = float(self.lr_inject)

    def asdict(self):
        return dataclasses.asdict(self)


@dataclasses.dataclass
class OptimizationConfig:
    log_dir: str = 'runs'
    checkpoint_dir: str = 'checkpoints'
    log_period: int = 500
    save_period: int = -1
    train_split: float = 103.0      # minutes
    stokes: list = dataclasses.field(default_factory=lambda: ['I', 'Q', 'U'])
    batchsize: int = 6
    sigma: Any = 1.0
    # steps fused into one lax.scan dispatch (train.Optimizer scan_chunk;
    # 0 = per-step loop). Sub-pixel ensembles ride the scan path too.
    scan_chunk: int = 500
    hparams: HParams = dataclasses.field(default_factory=HParams)

    def __post_init__(self):
        self.train_split = float(self.train_split)
        self.batchsize = int(self.batchsize)
        self.scan_chunk = int(self.scan_chunk)
        if isinstance(self.sigma, str):
            self.sigma = float(self.sigma)
        elif isinstance(self.sigma, (list, tuple)):
            self.sigma = [float(s) for s in self.sigma]


@dataclasses.dataclass
class RunConfig:
    preprocess: PreprocessConfig = dataclasses.field(
        default_factory=PreprocessConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    optimization: OptimizationConfig = dataclasses.field(
        default_factory=OptimizationConfig)

    @classmethod
    def from_yaml(cls, path):
        import yaml
        raw = yaml.safe_load(Path(path).read_text()) or {}
        return cls.from_dict(raw)

    @classmethod
    def from_dict(cls, raw):
        def build(dc_cls, section):
            fields = {f.name for f in dataclasses.fields(dc_cls)}
            known = {k: v for k, v in section.items() if k in fields}
            unknown = set(section) - fields
            if unknown:
                raise ValueError(f'unknown config keys for '
                                 f'{dc_cls.__name__}: {sorted(unknown)}')
            return dc_cls(**known)

        # `or {}`: a bare YAML section header ('model:') parses as None
        opt_raw = dict(raw.get('optimization') or {})
        hp = build(HParams, opt_raw.pop('hparams', None) or {})
        opt = build(OptimizationConfig, opt_raw)
        opt.hparams = hp
        return cls(
            preprocess=build(PreprocessConfig,
                             raw.get('preprocess') or {}),
            model=build(ModelConfig, raw.get('model') or {}),
            optimization=opt)

    def to_yaml(self, path):
        payload = {
            'preprocess': dataclasses.asdict(self.preprocess),
            'model': dataclasses.asdict(self.model),
            'optimization': dataclasses.asdict(self.optimization),
        }
        import yaml
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        with open(path, 'w') as f:
            yaml.dump(payload, f, default_flow_style=False)

def inclination_grid(inc_args, start_inc=None):
    """CLI inclination-block logic (reference Fit_*.py:25-31, 91-96)."""
    inc_grid = np.asarray(inc_args, float)
    if len(inc_grid) > 1:
        angles = np.arange(4, 82, 2, dtype=float)
        inc_grid = np.array_split(angles, int(inc_args[0]))[int(inc_args[1])]
    if start_inc:
        inc_grid = inc_grid[inc_grid >= start_inc]
    return inc_grid
