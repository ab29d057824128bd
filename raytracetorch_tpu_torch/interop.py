"""Carry state across from the JAX package through numpy.

The parity tests build inputs once (with numpy, or with the JAX package and
``np.asarray``) and hand the same numbers to both packages:

- ``params_from_numpy``: a params tree (nested dicts of arrays, e.g.
  ``jax.tree_util.tree_map(np.asarray, params)``) -> dicts of tensors (a
  solid's ``length``, ``width``, ``height`` or ``offsets``, a polyhedron's
  ``ior_glass`` and ``ior_media``, a custom element's ``extra`` leaves and
  ``coat_d`` are leaves like any other);
- ``table_from_numpy``: a SurfaceTable with array leaves (or a dict of its
  fields) -> the port's SurfaceTable (the half-space columns ``hp_n``,
  ``hp_d`` and the bool ``hp_mask`` included);
- ``rays_from_numpy``: a Rays batch with array leaves (or a dict) -> Rays;
- ``meta_from_slots``: the JAX package's StaticRowMeta list -> the port's,
  slot by slot (a freeform row's exponent pairs ride ``ff``; the freeform
  and Zernike lenses' ``xy1``/``xy2``/``z1``/``z2`` leaves are arrays of
  ``params_from_numpy`` like any other).

This module never imports jax: it reads attributes and arrays only.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from .core.static_dispatch import StaticRowMeta
from .core.table import SurfaceTable
from .rays.ray import Rays


def _tensor(a, device):
    # np.array copies: the tensor owns writable, contiguous memory
    return torch.from_numpy(np.array(a)).to(device)


def _field(obj, name):
    return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)


def params_from_numpy(tree, device):
    """Nested dicts of arrays -> nested dicts of tensors (dtypes kept)."""
    if isinstance(tree, Mapping):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return _tensor(tree, device)


def table_from_numpy(table, device):
    """SurfaceTable from an object (or dict) with the same field names."""
    return SurfaceTable(**{f.name: _tensor(_field(table, f.name), device)
                           for f in dataclasses.fields(SurfaceTable)})


def rays_from_numpy(rays, device):
    """Rays from an object (or dict) with px..wavelength arrays."""
    out = {f.name: _tensor(_field(rays, f.name), device)
           for f in dataclasses.fields(Rays)}
    out['ray_id'] = out['ray_id'].to(torch.int32)
    return Rays(**out)


def meta_from_slots(metas):
    """Copy per-row static metadata slot by slot."""
    out = []
    for m in metas:
        fields = {s: getattr(m, s) for s in StaticRowMeta.__slots__}
        out.append(StaticRowMeta(**fields))
    return out
