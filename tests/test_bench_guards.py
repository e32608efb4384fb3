"""The measurement entry points fail instead of falling back: no GPU, a
failing section or an unknown device never turns into a number."""
import os
import subprocess
import sys
from pathlib import Path

import jax

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import bench  # noqa: E402
from bhnerf_jax import utils  # noqa: E402


def _run(code):
    env = dict(os.environ, JAX_PLATFORMS='cpu',
               PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get('PYTHONPATH', ''))
    return subprocess.run([sys.executable, '-c', code], cwd=str(REPO),
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_bench_exits_nonzero_without_gpu():
    proc = _run('import bench; bench.main()')
    assert proc.returncode != 0
    assert 'measures a GPU' in proc.stderr
    assert proc.stdout.strip() == ''


def test_bench_failing_section_exits_nonzero():
    """A section that raises ends the run with a non-zero exit and no
    JSON line (no section is caught and replaced by another path)."""
    proc = _run(
        'import types, bench\n'
        "bench.require_gpu = lambda: types.SimpleNamespace("
        "platform='gpu', device_kind='test')\n"
        'def broken(*a, **k):\n'
        "    raise RuntimeError('section failed')\n"
        'bench.image_setup = broken\n'
        'bench.main()\n')
    assert proc.returncode != 0
    assert 'section failed' in proc.stderr
    assert proc.stdout.strip() == ''


def test_peak_flops_table(capsys):
    assert bench.peak_flops('NVIDIA H100 80GB HBM3') == 989e12
    assert bench.peak_flops('some other card') is None
    assert 'mfu is null' in capsys.readouterr().err


def test_compilation_cache_dir_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv('JAX_COMPILATION_CACHE_DIR', str(tmp_path))
    assert utils.compilation_cache_dir() == str(tmp_path)
    monkeypatch.delenv('JAX_COMPILATION_CACHE_DIR')
    assert utils.compilation_cache_dir() == str(REPO / '.jax_cache')


def test_enable_compilation_cache_sets_no_other_dir(monkeypatch, tmp_path):
    """With $JAX_COMPILATION_CACHE_DIR set, no directory is set in code;
    without it, the fixed <repo>/.jax_cache is."""
    calls = []
    monkeypatch.setattr(jax.config, 'update',
                        lambda k, v: calls.append((k, v)))
    monkeypatch.setenv('JAX_COMPILATION_CACHE_DIR', str(tmp_path))
    utils.enable_compilation_cache()
    assert 'jax_compilation_cache_dir' not in dict(calls)
    calls.clear()
    monkeypatch.delenv('JAX_COMPILATION_CACHE_DIR')
    utils.enable_compilation_cache()
    assert dict(calls)['jax_compilation_cache_dir'] == str(
        REPO / '.jax_cache')
