"""Package setup (reference setup.py parity)."""
from setuptools import find_packages, setup

setup(
    name='bhnerf_jax',
    version='1.0.0',
    description=('JAX neural 3D tomography of black-hole emission '
                 'with general-relativistic ray tracing'),
    packages=find_packages(include=['bhnerf_jax', 'bhnerf_jax.*']),
    python_requires='>=3.10',
    install_requires=['jax', 'numpy', 'optax'],
    extras_require={
        'full': ['orbax-checkpoint', 'tensorboardX', 'matplotlib',
                 'pandas', 'tqdm', 'pyyaml'],
    },
)
