"""Losses and jitted, mesh-sharded train/test steps.

Rebuild of the reference's loss + gradient-step layer
(bhnerf/network.py:373-795). Key structural changes:

* `RayTracingArgs` freezes the geodesic constants into a float32 pytree
  (reference network.py:850-894 OrderedDict). Host-side it pre-subtracts
  t_injection from the geodesic times and pre-scales observation times to
  M units, so the float32 device arrays carry O(1..100) values instead of
  O(r_o) — f32-critical (the reference silently loses ~0.06M of precision
  here on GPUs).
* steps are plain `jit` over a Mesh: frame-batched tensors arrive with a
  'data'-axis NamedSharding, ray tensors may shard over 'ray', params stay
  replicated; XLA inserts the gradient all-reduce (the explicit
  jax.lax.pmean of the reference pmap step, network.py:620, disappears).
* loss semantics are global sums, invariant to mesh shape.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from bhnerf_jax import constants as consts
from bhnerf_jax import units, utils
from bhnerf_jax.models.fields import learned_t_injection
from bhnerf_jax.ops import gr


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class RayTracingArgs:
    """Non-optimized ray-tracing constants for the training hot loop
    (reference network.py:850-894)."""

    coords: Any      # (3, na, nb, ngeo) f32
    Omega: Any       # scalar or (na, nb, ngeo)
    J: Any           # scalar 1.0 or (nstokes, na, nb, ngeo)
    g: Any           # (na, nb, ngeo) doppler
    dtau: Any        # (na, nb, ngeo)
    Sigma: Any       # (na, nb, ngeo)
    t_geos_rel: Any  # (na, nb, ngeo): t_geos - t_injection, O(1..100)
    t_injection: Any  # scalar f32 offset (0 unless learnable-injection)
    # aux (static)
    t_start_obs: float = 0.0   # in t_units
    t_to_M: float = 1.0        # multiply (t - t_start_obs) -> M units
    t_units: Any = None

    _LEAVES = ('coords', 'Omega', 'J', 'g', 'dtau', 'Sigma', 't_geos_rel',
               't_injection')
    _AUX = ('t_start_obs', 't_to_M', 't_units')

    def tree_flatten(self):
        return (tuple(getattr(self, f) for f in self._LEAVES),
                tuple(getattr(self, f) for f in self._AUX))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)

    @property
    def num_stokes(self):
        return 1 if jnp.ndim(self.J) == 0 else np.shape(self.J)[0]

    def frame_times_M(self, t_frames):
        """Observation times -> M units relative to t_start_obs."""
        return (jnp.asarray(t_frames) - self.t_start_obs) * self.t_to_M


def raytracing_args(geos, Omega, t_injection, t_start_obs, J=1.0,
                    M=consts.sgra_mass, dtype=jnp.float32):
    """Freeze geodesics into device arrays (reference network.py:850-894).

    t_start_obs: units.Quantity (or float hours). The returned pytree is
    what the TrainStep factories consume.
    """
    umu = gr.azimuthal_velocity_vector(geos, jnp.asarray(Omega))
    g = gr.doppler_factor(geos, umu)

    t_value, t_unit = units.strip_time(t_start_obs)
    GM_c3 = consts.GM_c3(M).to(t_unit.name if t_unit else 'hr').value

    # f64 host subtraction before the f32 cast — see module docstring
    t_geos_rel = np.asarray(geos.t, np.float64) - float(t_injection)

    as_f32 = lambda x: jnp.asarray(x, dtype)
    return RayTracingArgs(
        coords=as_f32(np.stack([geos.x, geos.y, geos.z], axis=0)),
        Omega=as_f32(Omega),
        J=J if np.isscalar(J) else as_f32(J),
        g=as_f32(g),
        dtau=as_f32(geos.dtau),
        Sigma=as_f32(geos.Sigma),
        t_geos_rel=as_f32(t_geos_rel),
        t_injection=jnp.zeros((), dtype),
        t_start_obs=float(t_value),
        t_to_M=float(1.0 / GM_c3),
        t_units=t_unit,
    )


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class CompactRayArgs:
    """Domain-compacted ray constants.

    Only ~17-25% of ray samples fall inside the supervised emission shell
    (rmin/rmax/z_width) for production configs; the domain mask is static
    per model, so in-domain samples are gathered once on host and the
    whole training pipeline (warp, posenc, MLP, transfer) runs on the
    compact set. The per-pixel reduction becomes a sorted segment-sum.
    This is a pure optimization: images match RayTracingArgs bit-for-bit
    up to float reassociation.
    """

    coords: Any        # (3, N_pad) in-domain sample positions
    Omega: Any         # scalar or (N_pad,)
    weights: Any       # (nstokes, N_pad) = J * g^2 * dtau * Sigma
    t_geos_rel: Any    # (N_pad,)
    pixel_ids: Any     # (N_pad,) int32, sorted; padding rows -> npix
    t_injection: Any   # scalar f32 offset
    # grouped-reduction layout (see _REDUCE_G): re-gathering samples
    # into per-pixel segments padded to multiples of G makes the
    # segment_sum scatter G x smaller (group sums are vectorized), at the
    # price of one static gather. None -> plain segment_sum. Whether it
    # pays on the GPU, where segment_sum lowers to atomics, is not
    # measured yet.
    red_gather: Any = None     # (N_red,) int32 into the sample axis
    red_weights: Any = None    # (nstokes, N_red); 0 on filler slots
    red_group_ids: Any = None  # (N_red // G,) int32, sorted; pads -> npix
    # aux (static)
    image_shape: tuple = ()
    polarized: bool = False
    t_start_obs: float = 0.0
    t_to_M: float = 1.0
    t_units: Any = None
    # sample-parallel layout (compact_raytracing_args(..., mesh=...)):
    # the sample axis is blocked into `num_shards` equal contiguous
    # shards; red_gather holds SHARD-LOCAL indices and the prediction
    # runs under jax.shard_map over mesh axis `shard_axis`, psum-ing the
    # per-shard partial images (no all-gather of sample tensors).
    num_shards: int = 1
    mesh: Any = None
    shard_axis: str = 'ray'

    _LEAVES = ('coords', 'Omega', 'weights', 't_geos_rel', 'pixel_ids',
               't_injection', 'red_gather', 'red_weights', 'red_group_ids')
    _AUX = ('image_shape', 'polarized', 't_start_obs', 't_to_M', 't_units',
            'num_shards', 'mesh', 'shard_axis')

    def tree_flatten(self):
        return (tuple(getattr(self, f) for f in self._LEAVES),
                tuple(getattr(self, f) for f in self._AUX))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)

    @property
    def num_stokes(self):
        return np.shape(self.weights)[0]

    @property
    def npix(self):
        return int(np.prod(self.image_shape))

    def frame_times_M(self, t_frames):
        return (jnp.asarray(t_frames) - self.t_start_obs) * self.t_to_M


# group size of the two-level compact reduction (see CompactRayArgs)
_REDUCE_G = 8


def _grouped_layout(pixel_ids, W, npix, G):
    """Grouped-reduction layout over ONE contiguous sample block.

    pixel_ids: (n,) sorted pixel of each sample (block-local positions);
    W: (nstokes, n) weights. Returns (red_gather block-LOCAL int indices,
    red_weights with 0 on filler slots, red_group_ids sorted global pixel
    ids, valid_slot bool), with n_groups * G slots (groups not yet
    padded)."""
    counts = np.bincount(pixel_ids, minlength=npix)
    nz = np.flatnonzero(counts)
    c_nz = counts[nz]
    seg_starts = np.concatenate([[0], np.cumsum(c_nz)])[:-1]
    ng = -(-c_nz // G)                       # groups per pixel
    slots_per_pix = ng * G
    tot_slots = int(slots_per_pix.sum())
    pix_of_slot = np.repeat(np.arange(nz.size), slots_per_pix)
    slot_off = np.concatenate([[0], np.cumsum(slots_per_pix)])[:-1]
    slot_in_pix = np.arange(tot_slots) - slot_off[pix_of_slot]
    valid_slot = slot_in_pix < c_nz[pix_of_slot]
    red_gather = np.where(valid_slot,
                          seg_starts[pix_of_slot] + slot_in_pix, 0)
    red_weights = np.where(valid_slot[None], W[:, red_gather], 0.0)
    red_group_ids = np.repeat(nz, ng)
    return red_gather, red_weights, red_group_ids, valid_slot


def _pad_grouped(red_gather, red_weights, red_group_ids, valid_slot,
                 n_groups, npix, G):
    """Pad a block's grouped layout to exactly n_groups groups."""
    g_pad = n_groups - red_group_ids.size
    assert g_pad >= 0
    if g_pad:
        red_gather = np.concatenate(
            [red_gather, np.zeros(g_pad * G, np.int64)])
        red_weights = np.concatenate(
            [red_weights, np.zeros((red_weights.shape[0], g_pad * G),
                                   red_weights.dtype)], axis=1)
        red_group_ids = np.concatenate(
            [red_group_ids, np.full(g_pad, npix, np.int64)])
        valid_slot = np.concatenate(
            [valid_slot, np.zeros(g_pad * G, bool)])
    return red_gather, red_weights, red_group_ids, valid_slot


def compact_raytracing_args(rt: RayTracingArgs, predictor, tile=128,
                            mesh=None, shards=None, shard_axis='ray',
                            pad_local_n=None, pad_groups=None,
                            layout='auto') -> CompactRayArgs:
    """Gather the in-domain subset of a RayTracingArgs (host-side, once).

    predictor supplies rmin/rmax/z_width; J/g/dtau/Sigma fold into a
    single per-sample weight per Stokes component. The sample count is
    padded to a multiple of `tile` (default 128, the MLP GEMM's row tile),
    so both the sample count and the compiled shapes stay stable.

    mesh + shard_axis (or an explicit shard count) produce the
    SAMPLE-PARALLEL layout: the pixel-sorted in-domain samples are split
    into equal contiguous blocks, each padded to the tile size with its
    own block-local grouped-reduction tables, and the prediction runs
    under jax.shard_map with each device owning one block (the
    multi-chip scaling semantics of the reference's pmap hot loop,
    optimization.py:209-216 — but over samples, which is where this
    rebuild's FLOPs live). Shards are static host-side layout; the same
    CompactRayArgs runs single-device too (shard_map over a 1-sized
    axis is the identity mesh case).

    pad_local_n / pad_groups force minimum per-shard sample / group
    counts so several sub-pixel-ray variants come out identically
    shaped (compact_ensemble_args uses this to build stackable
    ensembles for the scan-chunked training path).

    layout selects the reduction strategy:
    * 'gather'  — samples packed tight; the reduce re-gathers them into
      per-pixel groups (red_gather/red_weights). Meant for a cheap
      epilogue relative to the MLP (1 Stokes component).
    * 'native'  — samples are laid out DIRECTLY in the per-pixel padded
      group slots (~20% inert filler samples through the MLP), so the
      reduce needs NO gather at all and its backward gathers per GROUP
      (8x fewer rows). Meant for the polarized (3-Stokes) epilogue.
    * 'auto'    — 'native' for multi-Stokes weights, 'gather' otherwise.
    Which layout is faster on the GPU is not measured yet.
    """
    if shards is None:
        shards = (mesh.shape.get(shard_axis, 1) if mesh is not None else 1)
    if shards > 1 and mesh is None:
        raise ValueError('sample-parallel layout (shards > 1) needs the '
                         'mesh that shard_map will run over')
    from bhnerf_jax import emission as emission_lib
    coords = np.asarray(rt.coords)          # (3, na, nb, ngeo)
    na, nb, ngeo = coords.shape[1:]
    domain = np.asarray(emission_lib.domain_mask(
        coords, predictor.rmin, predictor.rmax, predictor.z_width))

    flat_idx_all = np.flatnonzero(domain.reshape(-1))
    G = _REDUCE_G
    npix = na * nb
    w_all = (np.asarray(rt.g) ** 2 * np.asarray(rt.dtau)
             * np.asarray(rt.Sigma)).reshape(-1)[flat_idx_all]
    J = rt.J
    # ndim (not isscalar): a scalar J that passed through a pytree op
    # arrives as a 0-d array
    polarized = np.ndim(J) > 0
    if polarized:
        W_all = (np.asarray(J).reshape(np.shape(J)[0], -1)[:, flat_idx_all]
                 * w_all)
    else:
        W_all = (w_all * float(np.asarray(J)))[None]

    # contiguous equal blocks of the pixel-sorted sample list — pixel
    # segments stay (mostly) shard-local
    if layout == 'auto':
        layout = 'native' if W_all.shape[0] > 1 else 'gather'
    if layout not in ('native', 'gather'):
        raise ValueError(f'unknown layout {layout!r}')

    blocks = np.array_split(np.arange(flat_idx_all.size), shards)
    # common per-block group count, computed after building each block's
    # layout. 'gather': multiple of 8 (sublane-friendly scatter rows);
    # 'native': groups*G must also be a multiple of the kernel tile
    layouts = []
    for b in blocks:
        pix_b = flat_idx_all[b] // ngeo
        layouts.append(_grouped_layout(pix_b, W_all[:, b], npix, G))
    n_groups = max(l[2].size for l in layouts)
    gmult = max(8, tile // G) if layout == 'native' else 8
    if pad_groups is not None:
        n_groups = max(n_groups, int(pad_groups))
    n_groups = (n_groups + gmult - 1) // gmult * gmult
    if layout == 'native':
        local_n = n_groups * G
    else:
        local_n = max((len(b) + tile - 1) // tile * tile for b in blocks)
        if pad_local_n is not None:
            local_n = max(local_n, int(pad_local_n))

    Omega = rt.Omega
    omega_flat = (None if jnp.ndim(Omega) == 0
                  else np.asarray(Omega).reshape(-1))
    tg_flat = np.asarray(rt.t_geos_rel).reshape(-1)
    coords_flat = coords.reshape(3, -1)

    cols = dict(coords=[], Omega=[], weights=[], tg=[], pix=[],
                red_gather=[], red_weights=[], red_group_ids=[])
    for b, lay in zip(blocks, layouts):
        idx = flat_idx_all[b]
        rg, rw, rgid, valid = _pad_grouped(*lay, n_groups, npix, G)
        if layout == 'native':
            # samples live directly in the padded group slots: the
            # reduce is a pure blocked sum (no gather); filler slots
            # are inert (never-valid time, zero weight). Slots are
            # K-MAJOR (slot = k * n_groups + g): the G-sum then reduces
            # over SUBLANES with all n_groups lanes busy — the g-major
            # order put G=8 in the lane dimension and wasted 120/128
            # lanes of the reduce fusion (measured ~2 ms/step)
            def kmajor(a):
                return (a.reshape(*a.shape[:-1], n_groups, G)
                        .swapaxes(-1, -2).reshape(*a.shape[:-1], -1))

            slot_idx = idx[rg]
            cols['coords'].append(kmajor(
                np.where(valid[None], coords_flat[:, slot_idx], 0.0)))
            if omega_flat is not None:
                cols['Omega'].append(kmajor(
                    np.where(valid, omega_flat[slot_idx], 0.0)))
            cols['weights'].append(kmajor(rw))
            cols['tg'].append(kmajor(
                np.where(valid, tg_flat[slot_idx], -1e30)))
            cols['pix'].append(np.tile(rgid, G))
            cols['red_group_ids'].append(rgid)
            continue

        pad = local_n - len(b)

        def padded(x, fill=0.0):
            return np.concatenate(
                [x, np.full((*x.shape[:-1], pad), fill, x.dtype)], axis=-1)

        cols['coords'].append(padded(coords_flat[:, idx]))
        if omega_flat is not None:
            cols['Omega'].append(padded(omega_flat[idx]))
        cols['weights'].append(padded(W_all[:, b]))
        # padding gets a far-future-invalid time so it never activates
        cols['tg'].append(padded(tg_flat[idx], fill=-1e30))
        cols['pix'].append(padded((idx // ngeo).astype(np.int64),
                                  fill=npix))
        cols['red_gather'].append(rg)
        cols['red_weights'].append(rw)
        cols['red_group_ids'].append(rgid)

    cat = lambda xs: np.concatenate(xs, axis=-1)

    if mesh is not None:
        # commit every leaf with the EXACT sharding the shard_map'd
        # executable expects: otherwise jit re-shards (device_put) the
        # whole sample set on EVERY call
        from jax.sharding import NamedSharding, PartitionSpec as P
        row = NamedSharding(mesh, P(shard_axis))
        mat = NamedSharding(mesh, P(None, shard_axis))
        rep = NamedSharding(mesh, P())
        put = lambda x, dt, sh: jax.device_put(jnp.asarray(x, dt), sh)
    else:
        row = mat = rep = None
        put = lambda x, dt, sh: jnp.asarray(x, dt)

    return CompactRayArgs(
        coords=put(cat(cols['coords']), jnp.float32, mat),
        Omega=(put(Omega, jnp.float32, rep) if omega_flat is None
               else put(cat(cols['Omega']), jnp.float32, row)),
        weights=put(cat(cols['weights']), jnp.float32, mat),
        t_geos_rel=put(cat(cols['tg']), jnp.float32, row),
        pixel_ids=put(cat(cols['pix']), jnp.int32, row),
        t_injection=put(rt.t_injection, jnp.float32, rep),
        red_gather=(None if layout == 'native'
                    else put(cat(cols['red_gather']), jnp.int32, row)),
        red_weights=(None if layout == 'native'
                     else put(cat(cols['red_weights']), jnp.float32,
                              mat)),
        red_group_ids=put(cat(cols['red_group_ids']), jnp.int32, row),
        image_shape=(na, nb),
        polarized=polarized,
        t_start_obs=rt.t_start_obs,
        t_to_M=rt.t_to_M,
        t_units=rt.t_units,
        num_shards=int(shards),
        mesh=mesh,
        shard_axis=shard_axis,
    )


def compact_ensemble_args(rt_list, predictor, **kwargs):
    """Domain-compact a sub-pixel-ray ensemble into identically-shaped
    CompactRayArgs (reference alma.py:65-81 builds N randomized
    geodesic tables; optimization.py:167-169 samples one per grad step).

    Different sub-pixel offsets give different in-domain sample counts;
    every variant is padded to the ensemble maximum so the list can be
    stacked (stack_ensemble) and the per-step variant choice can happen
    INSIDE the scan-chunked training dispatch. Returns a list.
    """
    rt_list = np.atleast_1d(rt_list)
    built = [compact_raytracing_args(rt, predictor, **kwargs)
             for rt in rt_list]
    shapes = {(c.coords.shape[-1], c.red_group_ids.shape[-1])
              for c in built}
    if len(shapes) > 1:
        # re-compact only the variants below the ensemble maximum (the
        # pads are max(current, pad), so max-shaped variants are already
        # in their final layout — compaction is the host-side cost here)
        ln = max(c.coords.shape[-1] // c.num_shards for c in built)
        ng = max(c.red_group_ids.shape[-1] // c.num_shards for c in built)
        built = [c if (c.coords.shape[-1] == ln * c.num_shards
                       and c.red_group_ids.shape[-1] == ng * c.num_shards)
                 else compact_raytracing_args(rt, predictor, pad_local_n=ln,
                                              pad_groups=ng, **kwargs)
                 for c, rt in zip(built, rt_list)]
    return built


def stack_ensemble(rt_list):
    """Stack identically-shaped ray-tracing args (dense or compact) into
    one pytree with a leading variant axis on every leaf.

    The scan-chunked training step draws a uniform variant per step
    inside the scan (the reference's per-step np.random.choice over the
    ensemble, optimization.py:167-169). Raises if leaf shapes differ —
    use compact_ensemble_args to build uniformly-padded compact
    variants.
    """
    rt_list = list(np.atleast_1d(rt_list))
    if len(rt_list) == 1:
        return rt_list[0]
    try:
        return jax.tree_util.tree_map(
            lambda *xs: jnp.stack([jnp.asarray(x) for x in xs]), *rt_list)
    except (ValueError, TypeError) as e:
        raise ValueError(
            f'ensemble variants are not uniformly shaped ({e}); build '
            f'compact ensembles with compact_ensemble_args') from e


# ---------------------------------------------------------------------------
# forward + losses
# ---------------------------------------------------------------------------
def _reduce_to_images(em, crt: CompactRayArgs):
    """Per-pixel weighted sums of compact samples: em (F, N) ->
    images (F, nstokes, npix).

    Uses the grouped layout when present (one static gather + vectorized
    sums of G + a G x smaller sorted scatter instead of the direct
    segment_sum scatter-add). The custom VJP keeps the backward a plain gather (the exact adjoint:
    d_em[i] = sum_s d_img[s, pixel_ids[i]] * weights[s, i]), which the
    autodiff of the gather layout would otherwise turn into another
    scatter."""
    npix = crt.npix

    if crt.red_gather is None and crt.red_group_ids is None:
        def per_frame(e):
            contrib = e[None, :] * crt.weights          # (nstokes, N)
            return jax.vmap(lambda c: jax.ops.segment_sum(
                c, crt.pixel_ids, num_segments=npix + 1,
                indices_are_sorted=True)[:npix])(contrib)
        return jax.vmap(per_frame)(em)

    # all arrays pass as explicit arguments (a custom_vjp closing over
    # them would leak tracers under shard_map)
    if crt.red_gather is None:
        # 'native' layout: samples already live in the group slots
        return _native_reduce(npix, em, crt.weights, crt.red_group_ids)
    return _grouped_reduce(npix, em, crt.red_gather, crt.red_weights,
                           crt.red_group_ids, crt.pixel_ids, crt.weights)


def _grouped_reduce_impl(npix, em, red_gather, red_weights, red_group_ids):
    F, ns = em.shape[0], red_weights.shape[0]
    emg = jnp.take(em, red_gather, axis=1)          # (F, N_red)
    contrib = emg[:, None, :] * red_weights         # (F, ns, N_red)
    gsum = contrib.reshape(F, ns, -1, _REDUCE_G).sum(-1)
    return jax.vmap(jax.vmap(lambda g: jax.ops.segment_sum(
        g, red_group_ids, num_segments=npix + 1,
        indices_are_sorted=True)[:npix]))(gsum)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def _grouped_reduce(npix, em, red_gather, red_weights, red_group_ids,
                    pixel_ids, weights):
    return _grouped_reduce_impl(npix, em, red_gather, red_weights,
                                red_group_ids)


def _gr_fwd(npix, em, red_gather, red_weights, red_group_ids, pixel_ids,
            weights):
    out = _grouped_reduce_impl(npix, em, red_gather, red_weights,
                               red_group_ids)
    return out, (red_gather, red_weights, red_group_ids, pixel_ids,
                 weights)


def _gr_bwd(npix, res, d_img):
    red_gather, red_weights, red_group_ids, pixel_ids, weights = res
    dpad = jnp.pad(d_img, ((0, 0), (0, 0), (0, 1)))  # padding pixel
    d_em = jnp.einsum('fsn,sn->fn', jnp.take(dpad, pixel_ids, axis=2),
                      weights)
    f0 = lambda x: np.zeros(x.shape, jax.dtypes.float0)
    return (d_em, f0(red_gather), jnp.zeros_like(red_weights),
            f0(red_group_ids), f0(pixel_ids), jnp.zeros_like(weights))


_grouped_reduce.defvjp(_gr_fwd, _gr_bwd)


def _native_reduce_impl(npix, em, weights, group_ids):
    F, ns = em.shape[0], weights.shape[0]
    contrib = em[:, None, :] * weights              # (F, ns, N)
    # k-major slots: group elements strided by n_groups, so this sum
    # reduces over sublanes with groups filling the lanes
    gsum = contrib.reshape(F, ns, _REDUCE_G, -1).sum(2)
    return jax.vmap(jax.vmap(lambda g: jax.ops.segment_sum(
        g, group_ids, num_segments=npix + 1,
        indices_are_sorted=True)[:npix]))(gsum)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def _native_reduce(npix, em, weights, group_ids):
    """Blocked reduce for the 'native' sample layout: pure strided
    group sums (no gather) + the small sorted scatter. The backward
    gathers d_img per GROUP (8x fewer rows than per sample) and
    broadcasts within the group."""
    return _native_reduce_impl(npix, em, weights, group_ids)


def _nr_fwd(npix, em, weights, group_ids):
    return _native_reduce_impl(npix, em, weights, group_ids), (weights,
                                                               group_ids)


def _nr_bwd(npix, res, d_img):
    weights, group_ids = res
    ns = weights.shape[0]
    dpad = jnp.pad(d_img, ((0, 0), (0, 0), (0, 1)))  # padding pixel
    dg = jnp.take(dpad, group_ids, axis=2)          # (F, ns, ngroups)
    w4 = weights.reshape(ns, _REDUCE_G, -1)
    d_em = jnp.einsum('fsg,skg->fkg', dg, w4).reshape(d_img.shape[0], -1)
    f0 = lambda x: np.zeros(x.shape, jax.dtypes.float0)
    return (d_em, jnp.zeros_like(weights), f0(group_ids))


_native_reduce.defvjp(_nr_fwd, _nr_bwd)


def predict_emission(params, predictor, t_frames_M, rt: RayTracingArgs):
    """Velocity-warped emission along rays for a batch of frames."""
    from bhnerf_jax import emission as emission_lib
    warped, valid = emission_lib.velocity_warp_coords(
        rt.coords, rt.Omega, t_frames_M, 0.0, rt.t_geos_rel,
        learned_t_injection(params, rt.t_injection), t_units=None,
        return_mask=True)
    return predictor.emission_at(params, warped, valid, rt.coords)


def _compact_emission(params, predictor, t_frames_M, crt: CompactRayArgs):
    """Per-sample emission over compact samples: (F, n) for flat frames."""
    from bhnerf_jax import emission as emission_lib
    n = crt.coords.shape[-1]
    t_shape = jnp.shape(t_frames_M)
    warped, valid = emission_lib.velocity_warp_coords(
        crt.coords, crt.Omega, t_frames_M, 0.0, crt.t_geos_rel,
        learned_t_injection(params, crt.t_injection), t_units=None,
        return_mask=True)
    warped = jnp.broadcast_to(warped, (*t_shape, n, 3))
    valid = jnp.broadcast_to(valid, (*t_shape, n))
    # domain mask is pre-applied by compaction (and re-masks padding
    # rows whose coords are 0); only t-validity is dynamic here
    emission = predictor.emission_at(params, warped, valid, crt.coords)
    return emission.reshape(-1, n)


def _shape_images(images, t_shape, crt):
    images = images.reshape(*t_shape, crt.num_stokes, *crt.image_shape)
    if not crt.polarized:
        images = images[..., 0, :, :]
    return images


def _sharded_compact_apply(params, predictor, t_frames_M,
                           crt: CompactRayArgs, body,
                           with_reduction=True):
    """Sample-parallel shard_map scaffolding shared by the compact image
    and lightcurve paths. with_reduction=False omits the per-pixel
    reduction tables (pixel_ids/red_*) from the sharded inputs — the
    lightcurve body never reads them, and dead operands would bloat the
    executable signature.

    Each device of the `crt.shard_axis` mesh axis owns one contiguous
    sample block (built by compact_raytracing_args(mesh=...)): it runs
    the full warp+posenc+MLP and then
    `body(em, local_crt)` on its block (block-local grouped reduction
    for images, em @ W^T for lightcurves); the per-shard partials are
    merged with ONE psum — no all-gather of any sample-sized tensor.
    This is the scaling semantics the reference got from pmap frame-DP
    (optimization.py:209-216), applied to the axis that carries this
    rebuild's FLOPs. Gradients flow through shard_map: the replicated
    params' cotangents are psum-merged by the transpose.
    """
    import dataclasses as dc
    from jax.sharding import PartitionSpec as P

    mesh, ax = crt.mesh, crt.shard_axis
    t_flat = jnp.reshape(jnp.asarray(t_frames_M), (-1,))

    leaves = dict(coords=crt.coords, weights=crt.weights,
                  t_geos_rel=crt.t_geos_rel)
    if with_reduction:
        leaves['pixel_ids'] = crt.pixel_ids
        if crt.red_gather is not None:
            leaves.update(red_gather=crt.red_gather,
                          red_weights=crt.red_weights)
        if crt.red_group_ids is not None:
            leaves.update(red_group_ids=crt.red_group_ids)
    if jnp.ndim(crt.Omega) > 0:
        leaves['Omega'] = crt.Omega

    def spec_of(x):
        return P(*([None] * (jnp.ndim(x) - 1) + [ax]))

    specs = {k: spec_of(v) for k, v in leaves.items()}

    def local_fn(params, t_flat, t_inj, omega_rep, lv):
        local = dc.replace(crt, t_injection=t_inj, num_shards=1,
                           mesh=None, Omega=lv.get('Omega', omega_rep),
                           **{k: v for k, v in lv.items() if k != 'Omega'})
        em = _compact_emission(params, predictor, t_flat, local)
        return jax.lax.psum(body(em, local), ax)

    omega_rep = crt.Omega if jnp.ndim(crt.Omega) == 0 else 0.0
    fn = jax.shard_map(local_fn, mesh=mesh,
                       in_specs=(P(), P(), P(), P(), specs),
                       out_specs=P(), check_vma=False)
    return fn(params, t_flat, crt.t_injection, omega_rep, leaves)


def _sharded_compact_prediction(params, predictor, t_frames_M,
                                crt: CompactRayArgs):
    """Sample-parallel compact image prediction (see
    _sharded_compact_apply for the shard_map layout)."""
    images = _sharded_compact_apply(params, predictor, t_frames_M, crt,
                                    _reduce_to_images)
    return _shape_images(images, jnp.shape(t_frames_M), crt)


def _compact_prediction(params, predictor, t_frames_M, crt: CompactRayArgs):
    """Image frames from domain-compacted samples: per-sample emission,
    then a sorted segment-sum over pixel ids (sample-parallel under
    shard_map when the args carry a mesh)."""
    if crt.mesh is not None:
        return _sharded_compact_prediction(params, predictor, t_frames_M,
                                           crt)
    t_shape = jnp.shape(t_frames_M)
    emission = _compact_emission(params, predictor, t_frames_M, crt)
    images = _reduce_to_images(emission, crt)
    return _shape_images(images, t_shape, crt)


def compact_lightcurve(params, predictor, t_frames_M, crt: CompactRayArgs):
    """Lightcurve directly from compact samples: lc = em @ weights^T.

    The 'lc' loss (the ALMA production loss) sums the image over pixels
    — so the per-pixel reduction (grouped sums + a 750k-row scatter at
    the polarized flagship shape) is dead weight: the per-Stokes totals
    are ONE (F, N) @ (N, ns) matmul, and its VJP is the transposed
    matmul. loss_fn_image routes compact 'lc' losses through
    compact_image_and_lightcurve (same math, emission shared with the aux
    images); this standalone variant serves callers that never need
    images.
    """
    t_shape = jnp.shape(t_frames_M)

    if crt.mesh is not None:
        lc = _sharded_compact_apply(params, predictor, t_frames_M, crt,
                                    lambda em, local: em @ local.weights.T,
                                    with_reduction=False)
    else:
        em = _compact_emission(params, predictor, t_frames_M, crt)
        lc = em @ crt.weights.T                       # (F, nstokes)

    lc = lc.reshape(*t_shape, crt.num_stokes)
    if not crt.polarized:
        lc = lc[..., 0]
    return lc


def compact_image_and_lightcurve(params, predictor, t_frames_M,
                                 crt: CompactRayArgs):
    """(images, lightcurve) from ONE emission pass over compact samples.

    The per-step (non-scan) 'lc' gradient step returns the per-pixel
    images as aux — computing the image and lightcurve independently
    would run the forward twice under a mesh (two shard_maps). Share the
    emission: the lightcurve is em @ W^T and the image reduce rides the
    same pass
    (XLA still dead-code-eliminates the reduce wherever the aux is
    discarded, e.g. inside scan-chunked steps).
    """
    t_shape = jnp.shape(t_frames_M)
    if crt.mesh is not None:
        images, lc = _sharded_compact_apply(
            params, predictor, t_frames_M, crt,
            lambda em, local: (_reduce_to_images(em, local),
                               em @ local.weights.T))
    else:
        em = _compact_emission(params, predictor, t_frames_M, crt)
        images = _reduce_to_images(em, crt)
        lc = em @ crt.weights.T                       # (F, nstokes)
    images = _shape_images(images, t_shape, crt)
    lc = lc.reshape(*t_shape, crt.num_stokes)
    if not crt.polarized:
        lc = lc[..., 0]
    return images, lc


def image_plane_prediction(params, predictor, t_frames_M,
                           rt):
    """Emission -> (polarized) image-plane frames
    (reference network.py:373-420). CompactRayArgs inputs dispatch to
    the domain-compacted pipeline."""
    if isinstance(rt, CompactRayArgs):
        return _compact_prediction(params, predictor, t_frames_M, rt)
    emission = predict_emission(params, predictor, t_frames_M, rt)
    from bhnerf_jax.emission import apply_stokes_factors
    emission = apply_stokes_factors(emission, rt.J)
    return gr.radiative_transfer(emission, rt.g, rt.dtau, rt.Sigma)


def loss_fn_image(params, predictor, target, sigma, offset, t_frames_M,
                  rt, scale, dtype):
    """Chi-square image/lightcurve loss (reference network.py:422-484)."""
    if dtype == 'full':
        images = image_plane_prediction(params, predictor, t_frames_M, rt)
        loss = jnp.sum(jnp.abs((images - target - offset) / sigma) ** 2)
    elif dtype == 'lc':
        if isinstance(rt, CompactRayArgs):
            # the lightcurve is one matmul instead of the per-pixel
            # reduce + pixel sum (bit-different only by float
            # reassociation); the aux images share the same emission
            # pass and are dead code wherever the aux is discarded
            images, lightcurve = compact_image_and_lightcurve(
                params, predictor, t_frames_M, rt)
        else:
            images = image_plane_prediction(params, predictor, t_frames_M,
                                            rt)
            lightcurve = images.sum(axis=(-1, -2))
        loss = jnp.sum(jnp.abs((lightcurve - target - offset) / sigma) ** 2)
    else:
        raise ValueError(f'image dtype ({dtype}) not supported')
    return scale * loss, [images]


def to_real_measurements(dtype, target, sigma, A):
    """Split complex measurement operators into a real/imag layout.

    The loss runs in real arithmetic (whether complex64 pays on the GPU
    is not measured yet). Layouts consumed by loss_fn_eht:

    * 'vis':    target (..., 2, nvis) [re, im]; sigma broadcastable;
                A (..., 2, nvis, npix^2)
    * 'amp':    target (..., nvis) real; A (..., 2, nvis, npix^2)
    * 'cphase': target (..., ntri) radians; A (..., 3, 2, ntri, npix^2)
    * 'bs':     target (..., 2, ntri) [re, im]; sigma broadcastable;
                A (..., 3, 2, ntri, npix^2)
    * 'logcamp'/'camp': target (..., nquad) real; A
                (..., 4, 2, nquad, npix^2)

    Factored operators (observation.chisqdata(operator='factored')) are
    already real separable stacks (..., 4, n, npix) — passed through
    unchanged (loss_fn_eht detects the form by the trailing dim).
    """
    A = np.asarray(A)
    if np.iscomplexobj(A):
        A_ri = np.stack([A.real, A.imag], axis=-3).astype(np.float32)
    else:
        A_ri = A.astype(np.float32)
    target = np.asarray(target)
    sigma = np.asarray(sigma, np.float32)
    if dtype in ('vis', 'bs'):
        target_ri = np.stack([target.real, target.imag],
                             axis=-2).astype(np.float32)
        sigma_ri = np.broadcast_to(sigma[..., None, :],
                                   target_ri.shape).copy()
        return np.nan_to_num(target_ri), sigma_ri, np.nan_to_num(A_ri)
    return (np.nan_to_num(np.asarray(target, np.float32)), sigma,
            np.nan_to_num(A_ri))


def apply_measurement_operator(images, A):
    """images (..., ny, nx) -> visibilities (..., 2, n) [re, im].

    Two operator forms, discriminated by the trailing dim:

    * dense (..., 2, n, ny*nx): one batched matmul against vec(image)
      (the re/im rows of the complex DTFT matrix).
    * factored (..., 4, n, npix) [Cu, Su, Cv, Sv]: the separable type-3
      DFT (observation.dft_factors) as TWO real (ny, nx) @ (nx, n)
      matmuls contracting the image x-axis, then an elementwise combine
      + y-reduction:
          V = sum_y (Cv - i Sv) * (Tc - i Ts),   T* = I @ {Cu,Su}^T
      npix-fold less operator memory/HBM traffic than dense — the
      production-npix path (reference uses ehtim NFFT,
      observation.py:121). Rectangular images: the Cu/Su rows carry nx
      columns and Cv/Sv ny, zero-padded to max(nx, ny) in the common
      stack — sliced back out here by the image's static shape.
    """
    ny, nx = images.shape[-2], images.shape[-1]
    npix2 = ny * nx
    if A.shape[-1] == npix2 and A.shape[-3] != 4:
        image_vectors = images.reshape(*images.shape[:-2], -1, 1)
        image_vectors = utils.expand_dims(image_vectors, A.ndim, axis=-3)
        return jnp.squeeze(jnp.matmul(A, image_vectors), -1)
    if A.shape[-3] != 4 or A.shape[-1] < max(nx, ny):
        raise ValueError(
            f'measurement operator shape {A.shape} matches neither the '
            f'dense (..., 2, n, {npix2}) nor the factored (..., 4, n, '
            f'>=max(nx, ny)) layout for image shape {images.shape}')
    imgs = utils.expand_dims(images, A.ndim - 1, axis=-3)
    cu, su = A[..., 0, :, :nx], A[..., 1, :, :nx]
    cv, sv = A[..., 2, :, :ny], A[..., 3, :, :ny]
    tc = jnp.einsum('...yx,...kx->...ky', imgs, cu)
    ts = jnp.einsum('...yx,...kx->...ky', imgs, su)
    re = jnp.sum(cv * tc - sv * ts, axis=-1)
    im = -jnp.sum(sv * tc + cv * ts, axis=-1)
    return jnp.stack([re, im], axis=-2)


def loss_fn_eht(params, predictor, target, sigma, A, t_frames_M, rt,
                scale, dtype):
    """Chi-square losses on interferometric data (network.py:486-564).

    A: per-frame DFT matrices in split real/imag layout (see
    to_real_measurements). The image -> visibility map is a batched real
    matmul.
    """
    images = image_plane_prediction(params, predictor, t_frames_M, rt)
    vis_ri = apply_measurement_operator(images, A)
    if dtype == 'vis':
        # vis_ri, target: (..., 2, nvis)
        chisq = jnp.sum(((vis_ri - target) / sigma) ** 2)
    elif dtype == 'amp':
        amp = jnp.sqrt(vis_ri[..., 0, :] ** 2 + vis_ri[..., 1, :] ** 2
                       + 1e-30)
        chisq = jnp.sum(((amp - target) / sigma) ** 2)
    elif dtype in ('cphase', 'bs'):
        # vis_ri: (..., 3, 2, ntri): complex triple product done in reals
        re0, im0 = vis_ri[..., 0, 0, :], vis_ri[..., 0, 1, :]
        re1, im1 = vis_ri[..., 1, 0, :], vis_ri[..., 1, 1, :]
        re2, im2 = vis_ri[..., 2, 0, :], vis_ri[..., 2, 1, :]
        re01 = re0 * re1 - im0 * im1
        im01 = re0 * im1 + im0 * re1
        re = re01 * re2 - im01 * im2
        im = re01 * im2 + im01 * re2
        if dtype == 'bs':
            # complex-bispectrum chi^2 (ehtim chisq_bs): padded rows have
            # sigma = inf so both components contribute exactly zero
            bs_ri = jnp.stack([re, im], axis=-2)
            return scale * jnp.sum(((bs_ri - target) / sigma) ** 2), \
                [images]
        # padded triangle rows have A=0 => (re, im) = (0, 0), and
        # arctan2's vjp at the origin is NaN even under a zero cotangent
        # (sigma=inf): double-where so padding contributes exactly zero
        safe = (re * re + im * im) > 1e-30
        clphase = jnp.arctan2(jnp.where(safe, im, 0.0),
                              jnp.where(safe, re, 1.0))
        chisq = jnp.sum(jnp.where(
            safe, (1.0 - jnp.cos(target - clphase)) / sigma**2, 0.0))
    elif dtype in ('logcamp', 'camp'):
        # vis_ri: (..., 4, 2, nquad): per-leg complex visibilities,
        # legs = numerator (0, 1), denominator (2, 3)
        amp2 = vis_ri[..., 0, :] ** 2 + vis_ri[..., 1, :] ** 2
        # padded quads have A = 0 => amp2 = 0; log's vjp at 0 is inf
        # even under a zero cotangent (sigma = inf): double-where
        safe = jnp.min(amp2, axis=-2) > 1e-30
        amp2 = jnp.where(safe[..., None, :], amp2, 1.0)
        lca = 0.5 * (jnp.log(amp2[..., 0, :]) + jnp.log(amp2[..., 1, :])
                     - jnp.log(amp2[..., 2, :]) - jnp.log(amp2[..., 3, :]))
        model = jnp.exp(lca) if dtype == 'camp' else lca
        chisq = jnp.sum(jnp.where(
            safe, ((model - target) / sigma) ** 2, 0.0))
    else:
        raise ValueError(f'eht dtype ({dtype}) not supported')
    return scale * chisq, [images]


def tv_loss(params, predictor, fov, resolution=32):
    """Finite-difference total variation of the emission field on a voxel
    grid — one batched forward evaluation, usable inside the training
    loss at production sizes.

    The reference's tv_reg (network.py:908-933) is broken upstream
    (undefined `lam`) and its intent — a training-time smoothness
    regularizer — would cost a per-point vjp; finite differences on the
    canonical-frame (t=0) volume give the same penalty in one pass.
    """
    grid = jnp.linspace(-fov / 2, fov / 2, resolution)
    coords = jnp.stack(jnp.meshgrid(grid, grid, grid, indexing='ij'))
    pts = jnp.moveaxis(coords, 0, -1)
    valid = jnp.ones(pts.shape[:-1], bool)
    em = predictor.emission_at(params, pts, valid, coords)
    h = fov / (resolution - 1)
    tv = sum(jnp.mean(jnp.abs(jnp.diff(em, axis=a))) for a in range(3))
    return tv / h


# ---------------------------------------------------------------------------
# jitted steps
# ---------------------------------------------------------------------------
def _take_frames(x, indices):
    """Select a frame batch from a device-resident full-movie tensor.

    For wide rows (e.g. the (nt, 2, nvis, npix^2) EHT operator) unrolled
    dynamic slices read only the selected rows, so no gather can stage
    the whole array. Narrow rows keep the single gather op (one op
    beats `batchsize` slices). Whether the split pays on the GPU is not
    measured yet.
    """
    if x.ndim >= 2 and x.size // x.shape[0] >= (1 << 15):
        rows = [jax.lax.dynamic_index_in_dim(x, indices[j], axis=0,
                                             keepdims=False)
                for j in range(indices.shape[0])]
        return jnp.stack(rows)
    return jnp.take(x, indices, axis=0)


@functools.lru_cache(maxsize=64)
def make_step_fns(predictor, kind='image', dtype='full', donate_state=False,
                  gather=False, tv_scale=0.0, tv_fov=None,
                  tv_resolution=32):
    """Build (grad_step, test_step), each jit'd once per (predictor
    config, loss kind). Mesh-parallelism comes from input shardings.

    Cached on the (hashable, frozen) predictor + flags so repeated
    construction — e.g. alma.chi2_df scanning dozens of checkpoints —
    reuses the same jit caches instead of recompiling per scan entry.

    kind='image': batch args are (target, sigma, offset, t_frames).
    kind='eht':   batch args are (target, sigma, A, t_frames).
    gather=True:  batch args are the FULL frame tensors plus an extra
        `indices` argument; the frame-batch gather happens inside the
        jitted step. One training step is then a single dispatch with no
        per-step host->device upload.
    """
    loss_fn = loss_fn_image if kind == 'image' else loss_fn_eht

    def compute_loss(params, target, sigma, third, t_frames, rt, scale):
        t_frames_M = rt.frame_times_M(t_frames)
        loss, aux = loss_fn(params, predictor, target, sigma, third,
                            t_frames_M, rt, scale, dtype)
        if tv_scale:
            fov = 2.0 * predictor.scale if tv_fov is None else tv_fov
            loss = loss + tv_scale * tv_loss(params, predictor, fov,
                                             tv_resolution)
        return loss, aux

    if gather:
        def compute_batch_loss(params, target, sigma, third, t_frames,
                               indices, rt, scale):
            take = lambda x: _take_frames(x, indices)
            return compute_loss(params, take(target), take(sigma),
                                take(third), take(t_frames), rt, scale)

        @functools.partial(jax.jit,
                           donate_argnums=(0,) if donate_state else ())
        def grad_step(state, target, sigma, third, t_frames, indices, rt,
                      scale):
            (loss, [images]), grads = jax.value_and_grad(
                compute_batch_loss, has_aux=True)(
                    state.params, target, sigma, third, t_frames, indices,
                    rt, scale)
            state = state.apply_gradients(grads)
            return loss, state, images

        @jax.jit
        def test_step(state, target, sigma, third, t_frames, indices, rt,
                      scale):
            loss, [images] = compute_batch_loss(
                state.params, target, sigma, third, t_frames, indices, rt,
                scale)
            return loss, state, images

        return grad_step, test_step

    @functools.partial(jax.jit, donate_argnums=(0,) if donate_state else ())
    def grad_step(state, target, sigma, third, t_frames, rt, scale):
        (loss, [images]), grads = jax.value_and_grad(
            compute_loss, has_aux=True)(state.params, target, sigma, third,
                                        t_frames, rt, scale)
        state = state.apply_gradients(grads)
        return loss, state, images

    @jax.jit
    def test_step(state, target, sigma, third, t_frames, rt, scale):
        loss, [images] = compute_loss(state.params, target, sigma, third,
                                      t_frames, rt, scale)
        return loss, state, images

    return grad_step, test_step


@functools.lru_cache(maxsize=64)
def make_scan_step(predictor, kind='image', dtype='full',
                   tv_scale=0.0, tv_fov=None, tv_resolution=32,
                   batchsize=6, chunk=100, num_variants=1):
    """One dispatch = `chunk` training steps via lax.scan.

    Per-step frame batches are sampled INSIDE the scan with jax PRNG
    (uniform without replacement, the reference's np.random.choice
    semantics — optimization.py:285-287). Eliminates the per-step
    dispatch round-trip and the Python loop entirely.

    num_variants > 1: `rt` is a stack_ensemble'd sub-pixel-ray ensemble
    (leading variant axis on every leaf); each step draws ONE uniform
    variant in-scan — the reference's stochastic ensemble semantics
    (optimization.py:167-169) without leaving the fast path. The
    per-step PRNG key is split (batch, variant) unconditionally, so a
    single-variant run and an ensemble of identical variants walk the
    same frame-batch chain.

    Returns jit fn (state, target, sigma, third, t_frames, key, rt,
    scale) -> (state, losses (chunk,)). Single-loss only;
    make_composed_scan_step is the multi-loss counterpart.
    """
    loss_fn = loss_fn_image if kind == 'image' else loss_fn_eht

    def compute_loss(params, target, sigma, third, t_frames, indices, rt,
                     scale):
        take = lambda x: _take_frames(x, indices)
        t_frames_M = rt.frame_times_M(take(t_frames))
        loss, aux = loss_fn(params, predictor, take(target), take(sigma),
                            take(third), t_frames_M, rt, scale, dtype)
        if tv_scale:
            fov = 2.0 * predictor.scale if tv_fov is None else tv_fov
            loss = loss + tv_scale * tv_loss(params, predictor, fov,
                                             tv_resolution)
        return loss, aux

    @functools.partial(jax.jit, donate_argnums=(0,))
    def scan_steps(state, target, sigma, third, t_frames, key, rt, scale):
        nt = target.shape[0]

        def body(state, k):
            k_batch, k_var = jax.random.split(k)
            indices = jax.random.choice(k_batch, nt, (batchsize,),
                                        replace=False)
            if num_variants > 1:
                var = jax.random.randint(k_var, (), 0, num_variants)
                rt_i = jax.tree_util.tree_map(lambda x: x[var], rt)
            else:
                rt_i = rt
            (loss, _), grads = jax.value_and_grad(
                compute_loss, has_aux=True)(
                    state.params, target, sigma, third, t_frames, indices,
                    rt_i, scale)
            return state.apply_gradients(grads), loss

        keys = jax.random.split(key, chunk)
        return jax.lax.scan(body, state, keys)

    return scan_steps


@functools.lru_cache(maxsize=32)
def make_composed_scan_step(batchsize=6, chunk=100, num_variants=1,
                            metas=(), scales=()):
    """Scan-chunked training for COMPOSED multi-loss TrainSteps.

    metas: one frozen (sorted key/value items) tuple per loss — the
    same kwargs each loss would pass to make_scan_step. Semantics match
    the per-step composed loop exactly: each scan step draws ONE shared
    frame batch and sub-pixel-ray variant, then applies every loss's
    gradients SEQUENTIALLY in composition order (the reference also
    updates state once per loss per step — optimization.py:176).
    scales are baked in (python floats) so the jit signature stays
    (state, *per_loss_args, key, rt) with per_loss_args the
    concatenated (target_i, sigma_i, third_i, t_frames_i) quads.

    All losses share the frame-batch indices, so their frame counts
    must agree (Optimizer.run falls back to the per-step loop
    otherwise).
    """
    metas = [dict(m) for m in metas]
    if len(scales) != len(metas):
        raise ValueError('need one scale per loss')

    def make_loss(m):
        loss_fn = (loss_fn_image if m.get('kind', 'image') == 'image'
                   else loss_fn_eht)
        predictor = m['predictor']
        dtype = m['dtype']
        tv_scale = m.get('tv_scale', 0.0)
        tv_fov = m.get('tv_fov')
        tv_resolution = m.get('tv_resolution', 32)

        def compute(params, target, sigma, third, t_frames, indices, rt,
                    scale):
            take = lambda x: _take_frames(x, indices)
            t_frames_M = rt.frame_times_M(take(t_frames))
            loss, aux = loss_fn(params, predictor, take(target),
                                take(sigma), take(third), t_frames_M,
                                rt, scale, dtype)
            if tv_scale:
                fov = (2.0 * predictor.scale if tv_fov is None
                       else tv_fov)
                loss = loss + tv_scale * tv_loss(params, predictor, fov,
                                                 tv_resolution)
            return loss, aux

        return compute

    loss_closures = [make_loss(m) for m in metas]

    @functools.partial(jax.jit, donate_argnums=(0,))
    def scan_steps(state, *args):
        *loss_args, key, rt = args
        assert len(loss_args) == 4 * len(loss_closures)
        nt = loss_args[0].shape[0]

        def body(state, k):
            k_batch, k_var = jax.random.split(k)
            indices = jax.random.choice(k_batch, nt, (batchsize,),
                                        replace=False)
            if num_variants > 1:
                var = jax.random.randint(k_var, (), 0, num_variants)
                rt_i = jax.tree_util.tree_map(lambda x: x[var], rt)
            else:
                rt_i = rt
            total = 0.0
            for i, compute in enumerate(loss_closures):
                quad = loss_args[4 * i:4 * i + 4]
                (loss, _), grads = jax.value_and_grad(
                    compute, has_aux=True)(
                        state.params, *quad, indices, rt_i, scales[i])
                state = state.apply_gradients(grads)
                total = total + loss
            return state, total

        keys = jax.random.split(key, chunk)
        return jax.lax.scan(body, state, keys)

    return scan_steps
