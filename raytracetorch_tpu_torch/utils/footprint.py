"""Beam footprints: where the bundle lands on every surface.

Counterpart of ``raytracetorch_tpu/utils/footprint.py``: one sequential
trace with ``record_hits=True`` yields each surface's surface-local hit
cloud; ``footprints`` packages them with per-surface extent statistics and
``footprint_report`` prints the clearance table (largest hit radius against
the surface's own semi-diameter where one is known).  On the card the trace
is ``simulate_fused``, so kernel K1 records the hits; on the CPU it is the
eager ``simulate``.  The clouds stay tensors on the rays' device.
"""

from __future__ import annotations

import torch


def _row_labels(scene):
    labels = []
    for el in scene.elements:
        for i in range(el.n_surfaces):
            labels.append(f'{el.name}[{i}]')
    return labels


def _row_semidias(scene, params):
    """Best-effort clear semi-diameter per surface row (None where the
    element type carries no obvious aperture parameter)."""
    out = []
    for el in scene.elements:
        p = params[el.name]
        if 'radius' in p:
            r = float(p['radius'])
        elif 'd' in p:
            d = float(p['d'])
            r = d / 2.0 if d > 0 else None
        elif 'half_x' in p:
            r = float(p['half_x'])
        elif 'diameter' in p:
            dia = float(p['diameter'])
            r = dia / 2.0 if dia < 1e17 else None
        else:
            r = None
        out.extend([r] * el.n_surfaces)
    return out


def footprints(scene, params, rays):
    """-> list of per-surface dicts:

    ``label``, ``x``/``y`` (surface-local hit coordinates of the rays alive
    through the whole train), ``w`` (their final intensity), ``r_max``
    (largest hit radius), ``semi_dia`` (the element's clear semi-aperture
    or None), ``fill`` (r_max / semi_dia), ``n`` (hit count).

    Sequential scenes only (the per-surface record is ordered).  The mask
    is the JAX package's: rays whose final intensity is > 0, the
    conservative footprint (the rays that matter for clearance)."""
    if not scene.sequential:
        raise ValueError('footprints needs a SequentialScene (ordered '
                         'per-surface hit record)')
    simulate = (scene.simulate_fused if rays.px.device.type == 'cuda'
                else scene.simulate)
    with torch.no_grad():
        out, _, aux = simulate(params, rays, record_hits=True)
    hits = aux['hits']                      # [K, N, 3] surface-local
    alive = out.intensity > 0
    w = out.intensity[alive]
    n_alive = int(alive.sum())
    reports = []
    for k, (lab, semi) in enumerate(zip(_row_labels(scene),
                                        _row_semidias(scene, params))):
        x = hits[k, :, 0][alive]
        y = hits[k, :, 1][alive]
        r_max = float(torch.sqrt(x * x + y * y).max()) if n_alive else 0.0
        reports.append({
            'label': lab, 'x': x, 'y': y, 'w': w,
            'r_max': r_max, 'semi_dia': semi,
            'fill': (r_max / semi) if semi else None,
            'n': n_alive,
        })
    return reports


def footprint_report(reports, top=None):
    """Clearance table: one line per surface, sorted as traced."""
    lines = ['surface            r_max    semi-dia   fill']
    for rp in reports[:top]:
        semi = f"{rp['semi_dia']:8.3f}" if rp['semi_dia'] else '       -'
        fill = f"{100 * rp['fill']:5.1f}%" if rp['fill'] else '     -'
        lines.append(f"{rp['label']:<16s} {rp['r_max']:8.3f} {semi}   "
                     f"{fill}")
    return '\n'.join(lines)
