"""Visualization: lightcurves, EVPA ticks, movie animation, volume render.

Rebuild of reference bhnerf/visualization.py:1-779 on matplotlib + jax.
The ipyvolume/ipywidgets interactive pieces of the reference (slider
comparisons, ipyvolume_3d) degrade gracefully: matplotlib animation and a
jit-compiled flat-space `VolumeVisualizer` cover the paper-figure paths.
"""
from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp


# ---------------------------------------------------------------------------
# lightcurve / polarization plots (reference visualization.py:44-80)
# ---------------------------------------------------------------------------
def plot_stokes_lc(lightcurves, stokes=('I', 'Q', 'U'), t_frames=None,
                   axes=None, plot_qu_loop=True, add_mean=False, fmt='.',
                   color=None, label=None, fontsize=12):
    """I/Q/U lightcurve panels + Q-U loop (reference 44-73)."""
    import matplotlib.pyplot as plt
    lightcurves = np.asarray(lightcurves)
    stokes = list(np.atleast_1d(stokes))
    n_panels = len(stokes) + (1 if plot_qu_loop and {'Q', 'U'} <= set(
        stokes) else 0)
    if axes is None:
        _, axes = plt.subplots(1, n_panels, figsize=(3.2 * n_panels, 3))
    axes = np.atleast_1d(axes)
    t = np.arange(lightcurves.shape[0]) if t_frames is None else \
        np.asarray(t_frames)
    for i, s in enumerate(stokes):
        axes[i].plot(t, lightcurves[:, i], fmt, color=color, label=label)
        axes[i].set_title(s, fontsize=fontsize)
        axes[i].set_xlabel('t')
    if plot_qu_loop and {'Q', 'U'} <= set(stokes):
        qi, ui = stokes.index('Q'), stokes.index('U')
        ax = axes[-1]
        ax.plot(lightcurves[:, qi], lightcurves[:, ui], fmt, color=color,
                label=label)
        if add_mean:
            ax.scatter(lightcurves[:, qi].mean(), lightcurves[:, ui].mean(),
                       marker='+', color=color)
        ax.set_title('Q-U loop', fontsize=fontsize)
        ax.set_xlabel('Q')
        ax.set_ylabel('U')
        ax.set_aspect('equal')
    import matplotlib.pyplot as plt
    plt.tight_layout()
    return axes


def plot_evpa_ticks(Q, U, alpha, beta, ax=None, color='white', scale=25,
                    width=0.004, headwidth=0):
    """Polarization tick quivers on an image (reference 75-80)."""
    import matplotlib.pyplot as plt
    if ax is None:
        _, ax = plt.subplots()
    evpa = 0.5 * np.arctan2(np.asarray(U), np.asarray(Q))
    p = np.sqrt(np.asarray(Q) ** 2 + np.asarray(U) ** 2)
    ax.quiver(alpha, beta, -p * np.sin(evpa), p * np.cos(evpa),
              color=color, scale=scale, width=width, headwidth=headwidth,
              headlength=0, headaxislength=0, pivot='mid')
    return ax


def slider_frame_comparison(movie1, movie2, scale='amp', title1='true',
                            title2='estimate'):
    """Interactive frame-by-frame comparison (reference 82-131).

    Uses matplotlib's Slider widget (always available headless; the
    ipywidgets notebook experience lives in `interactive_slider`).
    Returns (fig, update_fn); in headless runs call update_fn(i) to
    render frame i.
    """
    import matplotlib.pyplot as plt
    from matplotlib.widgets import Slider
    movie1, movie2 = np.asarray(movie1), np.asarray(movie2)
    if scale == 'log':
        movie1, movie2 = np.log10(np.abs(movie1) + 1e-12), \
            np.log10(np.abs(movie2) + 1e-12)
    fig, axes = plt.subplots(1, 3, figsize=(10, 3.5),
                             gridspec_kw={'width_ratios': [1, 1, 1]})
    ims = [axes[0].imshow(movie1[0]), axes[1].imshow(movie2[0]),
           axes[2].imshow(movie1[0] - movie2[0], cmap='RdBu_r')]
    for ax, ti in zip(axes, (title1, title2, 'difference')):
        ax.set_title(ti)
        ax.set_xticks([]); ax.set_yticks([])
    plt.subplots_adjust(bottom=0.2)
    s_ax = fig.add_axes([0.25, 0.05, 0.5, 0.04])
    slider = Slider(s_ax, 'frame', 0, movie1.shape[0] - 1, valinit=0,
                    valstep=1)

    def update(i):
        i = int(i)
        ims[0].set_array(movie1[i])
        ims[1].set_array(movie2[i])
        ims[2].set_array(movie1[i] - movie2[i])
        fig.canvas.draw_idle()

    slider.on_changed(update)
    fig._slider = slider  # keep a reference alive
    return fig, update


def interactive_slider(movie, ax=None, cmap=None, extent=None,
                       use_widgets=None):
    """Interactive frame explorer for a (nt, ny, nx) movie — the
    reference's xarray ``.visualization.slider`` accessor
    (visualization.py:377-419) for this package's plain arrays.

    In a notebook (ipywidgets available + IPython display active) this
    renders an ipywidgets IntSlider wired to the frame index with
    per-frame color rescaling, exactly like the reference accessor;
    otherwise it falls back to a matplotlib Slider. Returns the
    ipywidgets widget (drive it headlessly via
    ``widget.children[0].value = i``) or the matplotlib Slider.
    """
    import matplotlib.pyplot as plt
    movie = np.asarray(movie).squeeze()
    if movie.ndim != 3:
        raise ValueError(f'movie must be 3D (t, ny, nx); got shape '
                         f'{movie.shape}')
    if use_widgets is None:
        # auto mode needs BOTH ipywidgets and a live IPython display —
        # in a plain script an undisplayed widget would render nothing,
        # so fall back to the matplotlib Slider there
        try:
            import ipywidgets  # noqa: F401
            import IPython
            use_widgets = IPython.get_ipython() is not None
        except ImportError:
            use_widgets = False

    if ax is None:
        fig, ax = plt.subplots()
    else:
        fig = ax.figure
    im = ax.imshow(movie[0], origin='lower', cmap=cmap, extent=extent)
    fig.colorbar(im, ax=ax)

    def show_frame(frame=0):
        img = movie[int(frame)]
        im.set_array(img)
        im.set_clim(float(img.min()), float(img.max()))
        fig.canvas.draw_idle()

    if use_widgets:
        from ipywidgets import interactive
        widget = interactive(show_frame,
                             frame=(0, movie.shape[0] - 1))
        try:
            import IPython
            if IPython.get_ipython() is not None:
                from IPython.display import display
                display(widget)
        except ImportError:
            pass
        return widget

    from matplotlib.widgets import Slider
    fig.subplots_adjust(bottom=0.2)
    s_ax = fig.add_axes([0.25, 0.05, 0.5, 0.04])
    slider = Slider(s_ax, 'frame', 0, movie.shape[0] - 1, valinit=0,
                    valstep=1)
    slider.on_changed(show_frame)
    fig._slider = slider
    return slider


def animate_movies_synced(movies, axes, t_frames=None, vmin=None, vmax=None,
                          cmaps='afmhot', titles=None, fps=10,
                          output=None):
    """Side-by-side synced animation (reference 234-366)."""
    import matplotlib.pyplot as plt
    from matplotlib import animation
    movies = [np.asarray(m) for m in movies]
    axes = np.atleast_1d(axes)
    nt = movies[0].shape[0]
    if isinstance(cmaps, str):
        cmaps = [cmaps] * len(movies)
    vmin = [m.min() for m in movies] if vmin is None else np.atleast_1d(vmin)
    vmax = [m.max() for m in movies] if vmax is None else np.atleast_1d(vmax)
    images = []
    for ax, movie, cm, lo, hi in zip(axes, movies, cmaps, vmin, vmax):
        images.append(ax.imshow(movie[0], cmap=cm, vmin=lo, vmax=hi))
        ax.set_xticks([])
        ax.set_yticks([])
    if titles is not None:
        for ax, ti in zip(axes, titles):
            ax.set_title(ti)

    def update(i):
        for im, movie in zip(images, movies):
            im.set_array(movie[i])
        return images

    anim = animation.FuncAnimation(axes[0].get_figure(), update, frames=nt,
                                   interval=1000 / fps, blit=True)
    if output is not None:
        anim.save(output, writer='pillow', fps=fps)
    return anim


animate_synced = animate_movies_synced


def plot_geodesic_3D(geos, ray_indices=None, ax=None, max_r=None):
    """Matplotlib 3D ray viewer with the event horizon sphere
    (reference 133-232, sans ipywidgets interactivity)."""
    import matplotlib.pyplot as plt
    if ax is None:
        fig = plt.figure()
        ax = fig.add_subplot(projection='3d')
    x, y, z = geos.x, geos.y, geos.z
    npix = geos.npix
    flat = lambda a: a.reshape(npix, -1)
    xf, yf, zf = flat(x), flat(y), flat(z)
    if ray_indices is None:
        ray_indices = np.linspace(0, npix - 1, 32).astype(int)
    max_r = max_r or 1.5 * np.abs(geos.alpha).max()
    for i in ray_indices:
        r = np.sqrt(xf[i] ** 2 + yf[i] ** 2 + zf[i] ** 2)
        m = r < max_r
        ax.plot(xf[i][m], yf[i][m], zf[i][m], lw=0.5)
    # event horizon
    rh = 1 + np.sqrt(1 - geos.spin ** 2)
    u_s, v_s = np.mgrid[0:2 * np.pi:20j, 0:np.pi:10j]
    ax.plot_surface(rh * np.cos(u_s) * np.sin(v_s),
                    rh * np.sin(u_s) * np.sin(v_s), rh * np.cos(v_s),
                    color='black')
    ax.set_xlim(-max_r, max_r)
    ax.set_ylim(-max_r, max_r)
    ax.set_zlim(-max_r, max_r)
    return ax


# ---------------------------------------------------------------------------
# flat-space volume renderer (reference VolumeVisualizer, 491-755)
# ---------------------------------------------------------------------------
@functools.partial(jax.jit, static_argnames=('draw_cube', 'has_bh'))
def _vv_composite(volume, cam, dirs, ts, dt, extent, sigma_scale,
                  bh_radius, w_edge, cube_alpha, draw_cube, has_bh):
    """Alpha-composite with optional BH-sphere / cube-wireframe overlays.

    Module-level and jitted once per (shape, overlay-flags) — a per-call
    closure would retrace on every render (e.g. 24x in the rotating
    animation example). Scalars are traced args, so camera sweeps reuse
    the executable."""
    from jax.scipy.ndimage import map_coordinates
    pts = cam[None, None, None] + dirs[:, :, None] * ts[None, None, :,
                                                        None]
    npix_grid = jnp.asarray(volume.shape)
    idx = (pts + extent) / (2 * extent) * (npix_grid - 1)
    em = map_coordinates(volume, [idx[..., 0], idx[..., 1], idx[..., 2]],
                         order=1, cval=0.0)
    if has_bh:
        r = jnp.sqrt(jnp.sum(pts ** 2, axis=-1))
        opaque = r < bh_radius
        # Lambert term of the first sphere hit (limb darkening)
        cosv = jnp.clip(-jnp.sum(pts * dirs[:, :, None], axis=-1)
                        / jnp.maximum(r, 1e-9), 0.0, 1.0)
    else:
        opaque = jnp.zeros_like(em, bool)
        cosv = jnp.zeros_like(em)
    alpha = 1.0 - jnp.exp(-sigma_scale * em * dt)
    alpha = jnp.where(opaque, 1.0, alpha)
    if draw_cube:
        # a point lies on a wireframe edge when >= 2 coordinates are
        # within w_edge of a cube face (and inside the cube)
        ax3 = jnp.abs(pts)
        inside = jnp.all(ax3 <= extent + w_edge, axis=-1)
        n_face = jnp.sum(ax3 >= extent - w_edge, axis=-1)
        edge = inside & (n_face >= 2)
        alpha = 1.0 - (1.0 - alpha) * (1.0 - jnp.where(
            edge, cube_alpha, 0.0))
    else:
        edge = jnp.zeros_like(em, bool)
    trans = jnp.cumprod(1.0 - alpha + 1e-10, axis=-1)
    trans = jnp.concatenate(
        [jnp.ones_like(trans[..., :1]), trans[..., :-1]], axis=-1)
    weights = alpha * trans
    return (jnp.sum(weights * em, axis=-1),
            jnp.sum(weights * opaque, axis=-1),
            jnp.sum(weights * edge, axis=-1),
            jnp.sum(weights * opaque * cosv, axis=-1))


class VolumeVisualizer:
    """Pinhole-camera renderer for recovered 3D emission volumes.

    Generates camera rays, trilinearly samples the volume, and alpha-
    composites — all jit-compiled (reference visualization.py:491-663).
    """

    def __init__(self, resolution=(256, 256), fov=30.0, samples=128):
        self.resolution = tuple(resolution)
        self.fov_deg = fov
        self.samples = samples

    def _rays(self, azimuth, zenith, distance):
        h, w = self.resolution
        fov_r = np.deg2rad(self.fov_deg)
        # camera position on the sphere, looking at the origin
        cam = distance * np.array([
            np.sin(zenith) * np.cos(azimuth),
            np.sin(zenith) * np.sin(azimuth),
            np.cos(zenith)])
        forward = -cam / np.linalg.norm(cam)
        up0 = np.array([0.0, 0.0, 1.0])
        right = np.cross(forward, up0)
        if np.linalg.norm(right) < 1e-8:
            right = np.array([1.0, 0.0, 0.0])
        right = right / np.linalg.norm(right)
        up = np.cross(right, forward)
        ii, jj = np.meshgrid(np.linspace(-1, 1, w), np.linspace(-1, 1, h))
        half = np.tan(fov_r / 2)
        dirs = (forward[None, None] + half * (ii[..., None] * right
                + jj[..., None] * up))
        dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
        return jnp.asarray(cam), jnp.asarray(dirs)

    def render(self, volume, extent, azimuth=0.3, zenith=np.pi / 3,
               distance=None, sigma_scale=10.0, bh_radius=None,
               cmap='hot', draw_cube=False, cube_width=0.012,
               cube_alpha=0.85, bh_shade=0.25):
        """Render (h, w) RGB of the volume with optional overlays.

        volume: (nx, ny, nz) emission; extent: half-width of the cube [M].
        draw_cube=True composites the bounding-cube wireframe (edge
        proximity of the sample points, so occlusion by emission is
        handled by the same alpha march — reference draw_cube_jit,
        visualization.py:665-736); bh_radius draws the black-hole sphere
        with Lambert-shaded limb (reference draw_bh_jit, :738-755).
        """
        volume = jnp.asarray(volume)
        distance = distance or 3.0 * extent
        cam, dirs = self._rays(azimuth, zenith, distance)
        t_near = distance - 1.8 * extent
        t_far = distance + 1.8 * extent
        ts = jnp.linspace(t_near, t_far, self.samples)
        dt = (t_far - t_near) / self.samples
        w_edge = cube_width * extent

        img, shadow, wire, shade = _vv_composite(
            volume, cam, dirs, ts, dt, extent, sigma_scale,
            0.0 if bh_radius is None else bh_radius, w_edge, cube_alpha,
            draw_cube=bool(draw_cube), has_bh=bh_radius is not None)
        img = np.asarray(img)
        import matplotlib.pyplot as plt
        cm = plt.get_cmap(cmap)
        rgb = cm(img / max(img.max(), 1e-12))[..., :3]
        # black-hole sphere: dark silhouette with a faintly shaded limb
        rgb = rgb * (1.0 - np.asarray(shadow)[..., None]) \
            + bh_shade * np.asarray(shade)[..., None]
        # wireframe: white overlay weighted by its composite contribution
        wire = np.clip(np.asarray(wire), 0.0, 1.0)[..., None]
        rgb = rgb * (1.0 - wire) + wire
        return np.clip(rgb, 0.0, 1.0)


@jax.jit
def _transfer_composite(volume, vmax, cam, dirs, ts, dt, extent, levels,
                        opacities):
    """Alpha-composite a volume with an ipyvolume-style piecewise-linear
    transfer function: per-sample opacity = interp(em / vmax, level,
    opacity). vmax is supplied by the caller so a movie normalizes all
    frames against one global maximum. Module-level jit: movie frames
    reuse one executable. Returns (intensity, alpha)."""
    from jax.scipy.ndimage import map_coordinates

    # scale per-sample opacity with the step length (reference look:
    # 128 samples across the box) so the render is resolution-free
    ref_step = 2 * extent / 128.0
    pts = cam[None, None, None] + dirs[:, :, None] * ts[None, None, :,
                                                        None]
    npix_grid = jnp.asarray(volume.shape)
    idx = (pts + extent) / (2 * extent) * (npix_grid - 1)
    em = map_coordinates(volume, [idx[..., 0], idx[..., 1],
                                  idx[..., 2]], order=1, cval=0.0)
    em_n = em / jnp.maximum(vmax, 1e-12)
    alpha = jnp.clip(jnp.interp(em_n, levels, opacities), 0.0, 1.0)
    alpha = 1.0 - (1.0 - alpha) ** (dt / ref_step)
    trans = jnp.cumprod(1.0 - alpha + 1e-10, axis=-1)
    trans = jnp.concatenate(
        [jnp.ones_like(trans[..., :1]), trans[..., :-1]], axis=-1)
    weights = alpha * trans
    return jnp.sum(weights * em_n, axis=-1), jnp.sum(weights, axis=-1)


def ipyvolume_3d(volume, fov, azimuth=0, elevation=-60, distance=2.5,
                 level=(0.0, 0.2, 0.7), opacity=(0.0, 0.2, 0.3),
                 controls=False, resolution=(256, 256), samples=128,
                 cmap='magma', fps=10, output=None):
    """Volume rendering with an ipyvolume-style transfer function
    (reference visualization.py:758-779).

    ipyvolume is not a dependency; this renders the same view with
    the jitted ray compositor instead. `level`/`opacity` are the
    piecewise-linear transfer-function nodes of ipv.volshow (normalized
    emission -> opacity); azimuth/elevation are in degrees and distance
    is in bounding-box units, matching ipv.view.

    volume.ndim == 3 returns (fig, rgb image); ndim == 4 returns a
    matplotlib FuncAnimation over the leading time axis (saved as a GIF
    when `output` is given).
    """
    import matplotlib.pyplot as plt
    del controls  # interactivity handled by matplotlib backends
    volume = np.asarray(volume)
    if volume.ndim not in (3, 4):
        raise AttributeError(
            f'volume.ndim = {volume.ndim} not supported')

    extent = fov / 2.0
    vv = VolumeVisualizer(resolution=resolution, fov=45.0, samples=samples)
    dist = max(float(distance), 1.2) * fov
    cam, dirs = vv._rays(np.deg2rad(azimuth),
                         np.deg2rad(90.0 - elevation), dist)
    t_near, t_far = dist - 1.8 * extent, dist + 1.8 * extent
    ts = jnp.linspace(t_near, t_far, samples)
    dt = (t_far - t_near) / samples
    levels = jnp.asarray(level, jnp.float32)
    opacities = jnp.asarray(opacity, jnp.float32)
    cm = plt.get_cmap(cmap)
    # one global maximum for the whole input (movie frames must share a
    # normalization or a decaying hotspot renders as constant brightness)
    vmax = float(volume.max())

    def composite_frame(vol):
        img, a = _transfer_composite(vol, vmax, cam, dirs, ts, dt, extent,
                                     levels, opacities)
        return np.asarray(img), np.clip(np.asarray(a), 0.0, 1.0)

    def to_rgb(img, a, img_max):
        rgb = cm(img / max(img_max, 1e-12))[..., :3]
        return rgb * a[..., None]  # fade to black background

    if volume.ndim == 3:
        fig, ax = plt.subplots()
        img, a = composite_frame(volume)
        rgb = to_rgb(img, a, img.max())
        ax.imshow(rgb, origin='lower')
        ax.set_axis_off()
        return fig, rgb

    from matplotlib import animation
    composited = [composite_frame(v) for v in volume]
    img_max = max(img.max() for img, _ in composited)
    frames = [to_rgb(img, a, img_max) for img, a in composited]
    fig, ax = plt.subplots()
    im = ax.imshow(frames[0], origin='lower')
    ax.set_axis_off()

    def update(i):
        im.set_array(frames[i])
        return [im]

    anim = animation.FuncAnimation(fig, update, frames=len(frames),
                                   interval=1000 / fps, blit=True)
    if output is not None:
        anim.save(output, writer='pillow', fps=fps)
    return anim


# ---------------------------------------------------------------------------
# chi^2 hypothesis-scan visualization (reference animate_chi2_3d is broken
# upstream: visualization.py:11-41 references undefined chi2_inc/inc_true/
# plot_chi2 — this is the working form of its intent)
# ---------------------------------------------------------------------------
def plot_chi2(chi2, true_val=None, ax=None, xlabel=r'$\theta_o$ [deg]',
              color='tab:red', label=r'$\chi^2$'):
    """chi^2 vs hypothesis-parameter curve with the ground truth marked.

    chi2: pandas Series (index = hypothesis values, e.g. alma.chi2_df
    output grouped over seeds), a (values, index) pair of arrays, or a
    plain array (plotted against its positions).
    """
    import matplotlib.pyplot as plt
    if ax is None:
        _, ax = plt.subplots()
    if isinstance(chi2, (tuple, list)):
        ys, xs = np.asarray(chi2[0], float), np.asarray(chi2[1], float)
    elif hasattr(chi2, 'index') and not callable(chi2.index):
        xs, ys = np.asarray(chi2.index, float), np.asarray(chi2.values)
    else:
        ys = np.asarray(chi2, float)
        xs = np.arange(ys.shape[0], dtype=float)
    ax.plot(xs, ys, '.-', color=color, label=label)
    if true_val is not None:
        ax.axvline(true_val, color='black', linestyle=':', label='true')
    ax.set_xlabel(xlabel)
    ax.set_ylabel(r'$\chi^2$')
    return ax


def animate_chi2_3d(movie, chi2, true_val=None, figsize=(9, 4),
                    legend_loc='lower right', cmap='afmhot', fps=10,
                    output=None, writer='pillow',
                    xlabel=r'$\theta_o$ [deg]'):
    """Animate a hypothesis scan: chi^2 curve with a moving hypothesis
    marker next to the corresponding emission estimate (the working form
    of reference visualization.py:11-41, which is broken upstream).

    movie: (n_hyp, h, w) emission renders, one per hypothesis; chi2:
    pandas Series indexed by the hypothesis values (len n_hyp).
    """
    import matplotlib.pyplot as plt
    from matplotlib import animation
    movie = np.asarray(movie)
    if hasattr(chi2, 'index') and not callable(chi2.index):
        xs = np.asarray(chi2.index, float)
    else:
        # index-less chi2: synthesize hypothesis positions and hand
        # plot_chi2 the (values, index) pair form it expects
        xs = np.arange(movie.shape[0], dtype=float)
        chi2 = (np.asarray(chi2, float), xs)

    fig, axes = plt.subplots(1, 2, figsize=figsize)
    plot_chi2(chi2, true_val, ax=axes[0], xlabel=xlabel)
    line = axes[0].axvline(xs[0], color='blue', linestyle='--',
                           label='hypothesis')
    axes[0].legend(loc=legend_loc)
    axes[0].set_xlim(xs[0], xs[-1])
    axes[1].set_title('Emission estimate')
    axes[1].set_axis_off()
    im = axes[1].imshow(movie[0].clip(max=1), cmap=cmap,
                        vmin=0.0, vmax=1.0)
    plt.tight_layout()

    def update(i):
        axes[0].set_title(
            rf'Emission estimate: $\theta_o={xs[i]:1.1f}$')
        im.set_array(movie[i].clip(max=1))
        line.set_xdata([xs[i]])
        return im, line

    anim = animation.FuncAnimation(fig, update, frames=movie.shape[0],
                                   interval=1e3 / fps)
    if output is not None:
        anim.save(output, writer=writer, fps=fps)
    return anim
