"""Smoke coverage for visualization and side-car utilities."""
import matplotlib
matplotlib.use('Agg')

import numpy as np
import pytest

from bhnerf_jax import utils, visualization
from bhnerf_jax.geodesics import trace_geodesics


def test_plot_stokes_lc_and_qu_loop():
    lc = np.random.default_rng(0).random((20, 3))
    axes = visualization.plot_stokes_lc(lc, ['I', 'Q', 'U'])
    assert len(np.atleast_1d(axes)) == 4  # I, Q, U + QU loop
    axes2 = visualization.plot_stokes_lc(lc, ['I', 'Q', 'U'], axes=axes,
                                         fmt='x', label='est')
    assert axes2 is axes


def test_plot_evpa_ticks():
    rng = np.random.default_rng(0)
    Q, U = rng.normal(size=(2, 16))
    a, b = rng.uniform(-5, 5, (2, 16))
    ax = visualization.plot_evpa_ticks(Q, U, a, b)
    assert ax is not None


def test_slider_frame_comparison():
    m1 = np.random.default_rng(0).random((5, 8, 8))
    m2 = m1 + 0.1
    fig, update = visualization.slider_frame_comparison(m1, m2)
    update(3)  # headless frame update


def test_animate_movies_synced(tmp_path):
    import matplotlib.pyplot as plt
    movies = [np.random.default_rng(i).random((4, 8, 8)) for i in range(2)]
    fig, axes = plt.subplots(1, 2)
    anim = visualization.animate_movies_synced(movies, axes, fps=4)
    assert anim is not None


def test_plot_geodesic_3d():
    b = np.linspace(3, 8, 8)
    geos = trace_geodesics(b, np.zeros_like(b), 0.3, np.deg2rad(60),
                           ngeo=32, n_fine=512)
    ax = visualization.plot_geodesic_3D(geos)
    assert ax is not None


def test_volume_visualizer_render():
    vol = np.zeros((24, 24, 24))
    vol[8:16, 8:16, 10:14] = 1.0
    vis = visualization.VolumeVisualizer(resolution=(32, 32), samples=24)
    rgb = vis.render(vol, extent=8.0, bh_radius=2.0)
    assert rgb.shape == (32, 32, 3)
    assert np.isfinite(rgb).all()
    assert rgb.max() > 0.05  # emission visible


def test_volume_visualizer_overlays():
    """Cube wireframe + BH sphere overlays (reference draw_cube_jit /
    draw_bh_jit, visualization.py:665-755): the wireframe adds bright
    pixels outside the emission, the sphere darkens the center."""
    vol = np.zeros((24, 24, 24))
    vol[14:18, 14:18, 10:14] = 0.5
    vis = visualization.VolumeVisualizer(resolution=(48, 48), samples=48)
    plain = vis.render(vol, extent=8.0, sigma_scale=3.0)
    wired = vis.render(vol, extent=8.0, sigma_scale=3.0, draw_cube=True,
                       bh_radius=3.0)
    assert wired.shape == plain.shape and np.isfinite(wired).all()
    # wireframe: some near-white pixels appear that were dark before
    lum_p, lum_w = plain.mean(-1), wired.mean(-1)
    newly_bright = (lum_w > 0.8) & (lum_p < 0.3)
    assert newly_bright.sum() > 10, newly_bright.sum()
    # BH sphere: a visible dark-gray Lambert-shaded disk in the center
    c = slice(20, 28)
    assert abs(lum_w[c, c].mean() - lum_p[c, c].mean()) > 0.05
    assert lum_w[c, c].mean() < 0.5  # dark gray, not saturated


def test_ipyvolume_3d_replacement(tmp_path):
    """Transfer-function volume rendering (reference ipyvolume_3d,
    visualization.py:758-779) without ipyvolume: 3D returns an RGB
    image, 4D returns an animation."""
    vol = np.zeros((16, 16, 16))
    vol[6:10, 6:10, 6:10] = 1.0
    fig, rgb = visualization.ipyvolume_3d(vol, fov=16.0,
                                          resolution=(24, 24), samples=24)
    assert rgb.shape == (24, 24, 3)
    assert np.isfinite(rgb).all() and rgb.max() > 0.02
    # resolution-free opacity: doubling the sample count must not
    # change the render brightness materially
    _, rgb2 = visualization.ipyvolume_3d(vol, fov=16.0,
                                         resolution=(24, 24), samples=48)
    assert abs(rgb2.mean() - rgb.mean()) < 0.25 * rgb.mean() + 1e-3
    movie = np.stack([vol, 0.2 * vol])
    anim = visualization.ipyvolume_3d(movie, fov=16.0,
                                      resolution=(16, 16), samples=16)
    assert anim is not None
    with pytest.raises(AttributeError):
        visualization.ipyvolume_3d(vol[0], fov=16.0)


def test_animate_chi2_3d():
    """Working form of the reference's broken hypothesis-scan animation
    (visualization.py:11-41)."""
    import pandas as pd
    movie = np.random.default_rng(0).random((5, 8, 8))
    chi2 = pd.Series([3.0, 1.5, 1.0, 1.4, 2.8],
                     index=[30.0, 45.0, 60.0, 75.0, 90.0])
    anim = visualization.animate_chi2_3d(movie, chi2, true_val=60.0)
    assert anim is not None
    ax = visualization.plot_chi2(chi2, true_val=60.0)
    assert ax is not None


def test_fft_and_antialias():
    movie = np.random.default_rng(0).random((3, 16, 16))
    fft = np.asarray(utils.fft_transform(movie))
    assert fft.shape[-1] >= 32  # padded
    window = np.zeros((16, 16))
    window[8, 8] = 1.0  # delta window = identity-ish blur
    out = np.asarray(utils.anti_aliasing_filter(movie, window))
    assert out.shape == movie.shape
    np.testing.assert_allclose(out, movie, atol=1e-5)


def test_expand_3d_profile():
    movie = np.ones((2, 16, 16))
    vol = utils.expand_3d(movie, fov_xy=16.0, fov_z=4.0, H_r=0.1, nz=8)
    assert vol.data.shape == (2, 16, 16, 8)
    data = np.asarray(vol.data)
    # emission concentrated near the midplane
    assert data[..., 3:5].sum() > data[..., :2].sum()


def test_intensity_to_nchw():
    vol = np.random.default_rng(0).random((4, 8, 8))
    nchw = utils.intensity_to_nchw(vol)
    assert nchw.shape[1] == 3  # RGB channels


def test_spherical_rotation_axis():
    axis, angle = utils.spherical_coords_to_rotation_axis(
        np.deg2rad(30), np.deg2rad(45))
    assert np.isfinite(axis).all()
    np.testing.assert_allclose(np.linalg.norm(axis), 1.0, rtol=1e-6)


def test_stokes_movie_container():
    from bhnerf_jax import observation as obs_lib
    movie = np.zeros((2, 3, 8, 8))
    sm = obs_lib.stokes_array_to_ehtim(movie, np.array([6.0, 10.0]), 1e-10)
    assert sm.frames.shape == (2, 3, 8, 8)
    array = obs_lib.load_txt('eht_arrays/EHT2017.txt')
    obs0 = obs_lib.empty_eht_obs(array, nt=2, tint=60.0)
    obs = sm.observe_same(obs0, thermal_noise=False)
    assert obs.vis.shape[-1] == 3


def test_interactive_slider_widget_drives_frames():
    """interactive_slider builds an ipywidgets explorer (the reference's
    .visualization.slider accessor) whose slider actually swaps frames
    and rescales the color limits; the matplotlib fallback drives the
    same update path."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    from bhnerf_jax import visualization

    movie = np.stack([np.full((4, 4), i, float) for i in range(5)])
    movie[3, 0, 0] = 10.0

    # auto mode in a headless script (no IPython display) must fall
    # back to the matplotlib Slider — an undisplayed ipywidget would
    # render nothing
    from matplotlib.widgets import Slider
    auto = visualization.interactive_slider(movie)
    assert isinstance(auto, Slider)
    plt.close('all')

    widget = visualization.interactive_slider(movie, use_widgets=True)
    import ipywidgets
    assert isinstance(widget, ipywidgets.interactive)
    slider = widget.children[0]
    ax = plt.gcf().axes[0]
    im = ax.images[0]
    slider.value = 3
    assert float(np.asarray(im.get_array())[0, 0]) == 10.0
    assert im.get_clim() == (3.0, 10.0)
    plt.close('all')

    # matplotlib fallback path
    sl = visualization.interactive_slider(movie, use_widgets=False)
    sl.set_val(2)
    fig = sl.ax.figure
    assert float(np.asarray(fig.axes[0].images[0].get_array()).max()) == 2.0
    plt.close('all')
