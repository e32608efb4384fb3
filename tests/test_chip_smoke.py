"""chip_smoke.py at a tiny size on the CPU: every phase's code path,
its refusal of a CPU-only machine, and its failure outside the repo.

The full-size run needs a GPU (`python chip_smoke.py`); the `gpu`-marked
test below runs it through pytest on a GPU machine."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


def test_chip_smoke_phases_tiny_cpu():
    device = chip_smoke.run(chip_smoke.TINY, require_gpu=False)
    assert device['platform'] == 'cpu'


def test_chip_smoke_multi_tiny_cpu():
    """--multi's four-device comparisons on four virtual CPU devices."""
    device = chip_smoke.run(chip_smoke.TINY, multi=True, require_gpu=False)
    assert device['count'] >= 4


def test_chip_smoke_refuses_cpu():
    with pytest.raises(SystemExit, match='needs a GPU'):
        chip_smoke.phase_device(require_gpu=True)


def test_chip_smoke_fails_without_gpu_or_repo(tmp_path):
    """The script alone in a directory, and the script in the repo on a
    CPU-only machine, both exit non-zero and print no result line."""
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    env.pop('PYTHONPATH', None)
    shutil.copy(REPO / 'chip_smoke.py', tmp_path / 'chip_smoke.py')
    for cwd in (tmp_path, REPO):
        proc = subprocess.run([sys.executable, 'chip_smoke.py'],
                              cwd=str(cwd), env=env, capture_output=True,
                              text=True, timeout=300)
        assert proc.returncode != 0, (cwd, proc.stdout[-2000:])
        assert '"ok"' not in proc.stdout


@pytest.mark.gpu
def test_chip_smoke_full_on_gpu(gpu):
    device = chip_smoke.run(chip_smoke.FULL)
    assert device['platform'] == 'gpu'
