"""Ghost-image (stray light) analysis: two-reflection path enumeration.

Counterpart of ``raytracetorch_tpu/utils/ghosts.py`` (``ghost_pairs``,
``_ghost_order``, ``ghost_table``, ``ghost_trace``; the ranked
``GhostReport`` / ``ghost_report`` wait for the dense all-row dispatch,
ROADMAP Queue 1 item 13).

Every pair of refracting surface rows (i, j), i < j, of a sequential system
spawns a ghost: light transmits to row j, Fresnel-reflects back, travels to
row i, reflects forward again and goes on to the detector.  A ghost path is
a REORDERED surface table: rows 0..j-1, j as a REFLECT_W row (reflect,
intensity times the Fresnel R), rows j-1..i+1 traversed backward (the
two-sided refraction handles the reversed pass with the same rows), i as
REFLECT_W, then i+1..end forward again; with ``transmission='fresnel'``
every refracting row becomes FRESNEL_W, so the ghost's flux is the product
T...R_j...R_i...T.  ``ghost_trace`` runs it through the eager
``trace_sequential``, whose REFLECT_W rows kill the rays that miss them
(they belong to the primary beam).  The port's K1 applies the same kill,
so a ghost table also runs through ``simulate_fused``'s kernels (the JAX
package's fused kernel omits it: ROADMAP Queue 3).
"""

from __future__ import annotations

from ..constants import PhysKind
from ..core.static_dispatch import StaticRowMeta
from ..core.trace import trace_sequential

_REFRACTING = (PhysKind.SNELL, PhysKind.FRESNEL, PhysKind.FRESNEL_W)


def _meta_with_ph(m, ph):
    """A copy of a StaticRowMeta with another physics kind."""
    return StaticRowMeta(ph, **{s: getattr(m, s)
                                for s in StaticRowMeta.__slots__
                                if s != 'ph'})


def ghost_pairs(scene):
    """All two-reflection sequences: (i, j) row-index pairs over the
    scene's refracting surface rows, i < j."""
    refr = [k for k, m in enumerate(scene.static_meta())
            if m.ph in _REFRACTING]
    return [(i, j) for a, j in enumerate(refr) for i in refr[:a]]


def _ghost_order(pair, n_rows):
    """Row visit order of the two-reflection path and the positions of the
    two REFLECT_W rows within it."""
    i, j = pair
    if not 0 <= i < j < n_rows:
        raise ValueError(f'bad ghost pair {pair} for {n_rows} rows')
    order = list(range(j + 1))                   # 0..j   (j reflects)
    order += list(range(j - 1, i - 1, -1))       # j-1..i (i reflects)
    order += list(range(i + 1, n_rows))          # i+1..end
    return order, (j, j + (j - i))


def ghost_table(scene, params, pair, transmission='fresnel'):
    """The ``(table, static_meta)`` of one two-reflection ghost.

    ``transmission='fresnel'`` turns every refracting row (SNELL, FRESNEL)
    into FRESNEL_W, so the ghost's flux carries the true product
    T...T R_j T... R_i T...; ``'ideal'`` keeps lossless refraction (flux
    R_i R_j only).  The table's rows are the scene table's, reordered
    (differentiable in the params)."""
    if transmission not in ('fresnel', 'ideal'):
        raise ValueError(f"transmission must be 'fresnel' or 'ideal': "
                         f"{transmission!r}")
    base = scene.build_table(params)
    metas = list(scene.static_meta())
    order, refl_pos = _ghost_order(pair, len(metas))
    table = base.index_rows(order)
    new_metas, kinds = [], []
    for pos, src in enumerate(order):
        m = metas[src]
        ph = m.ph
        if pos in refl_pos:
            ph = int(PhysKind.REFLECT_W)
        elif transmission == 'fresnel' and m.ph in (PhysKind.SNELL,
                                                    PhysKind.FRESNEL):
            ph = int(PhysKind.FRESNEL_W)
        new_metas.append(m if ph == m.ph else _meta_with_ph(m, ph))
        kinds.append(ph)
    table = table.replace(ph_kind=table.ph_kind.new_tensor(kinds))
    return table, tuple(new_metas)


def ghost_trace(scene, params, rays, pair, transmission='fresnel', **kw):
    """The eager trace of one ghost path -> ``(rays_out, sensors, aux)``:
    the sensor rows of the tail segment accumulate the ghost's detector
    irradiance.  ``kw`` goes to core/trace.py::trace_sequential (the
    streams; ``generator`` where an ``'ideal'`` ghost keeps FRESNEL
    rows)."""
    table, metas = ghost_table(scene, params, pair, transmission)
    kw.setdefault('static_meta', metas)
    return trace_sequential(table, rays, scene.sensor_config(), **kw)
