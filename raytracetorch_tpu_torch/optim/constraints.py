"""Log-barrier manufacturability constraints.

Counterpart of ``raytracetorch_tpu/optim/constraints.py``: differentiable
penalties on surface spacings, inter-element gaps and total system length,
expressed on each element's ``optical_zs(params)`` list.
"""

from __future__ import annotations

import torch


def log_barrier_lb(x, lb):
    """-log(x - lb): penalises x -> lb from above."""
    return -torch.log(x - lb)


def log_barrier_ub(x, ub):
    """-log(ub - x): penalises x -> ub from below."""
    return -torch.log(ub - x)


def log_barrier(x, lb, ub):
    """Two-sided barrier for lb < x < ub."""
    return -torch.log(x - lb) - torch.log(ub - x)


def _zs(scene, params):
    return [el.optical_zs(params[el.name]) for el in scene.elements]


def thickness_constraint(scene, params, t_min, t_max=None, weight=1.0):
    """Barrier on consecutive intra-element surface spacings."""
    terms = []
    for z_list in _zs(scene, params):
        for i in range(len(z_list) - 1):
            t = z_list[i + 1] - z_list[i]
            terms.append(log_barrier_lb(t, t_min) if t_max is None
                         else log_barrier(t, t_min, t_max))
    if not terms:
        return torch.zeros(())
    return weight * sum(terms)


def spacing_constraint(scene, params, d_min, weight=1.0):
    """Barrier on inter-element air gaps."""
    z_lists = _zs(scene, params)
    terms = [log_barrier_lb(z_lists[i + 1][0] - z_lists[i][-1], d_min)
             for i in range(len(z_lists) - 1)]
    if not terms:
        return torch.zeros(())
    return weight * sum(terms)


def system_length_constraint(scene, params, l_max, weight=1.0):
    """Barrier on total first-to-last optical length."""
    z_lists = _zs(scene, params)
    return weight * log_barrier_ub(z_lists[-1][-1] - z_lists[0][0], l_max)
