"""Birefringence dispersion of common waveplate crystals.

Counterpart of ``raytracetorch_tpu/utils/birefringence.py`` (its own copy of
the coefficients: the port imports nothing of the JAX package).  Sellmeier
models of the ordinary and extraordinary indices of the standard retarder
materials, so that a waveplate's retardance follows the physical
delta = dn(lam) t / lam: a quarter-wave plate is quarter-wave only at its
design wavelength (elements/polarization.py, ``Waveplate(material=...)``).

Coefficients (lambda in um, n^2 forms as published):

- ``QUARTZ``: crystalline SiO2, Ghosh, Opt. Commun. 163 (1999) 95:
  n^2 = A + B lam^2 / (lam^2 - C) + D lam^2 / (lam^2 - E).
- ``MGF2``: Dodge, Appl. Opt. 23 (1984) 1980 (3-term Sellmeier,
  n^2 - 1 = sum B_i lam^2 / (lam^2 - C_i^2)).
- ``CALCITE``: Ghosh 1999, the quartz form (negative uniaxial: dn < 0).

The field kernels K1 and K2 carry the same constants
(csrc/field.cuh::crystal_n2; tests/test_torch_field_kernels.py holds the
header to this table).  Every function takes floats or tensors.
"""

from __future__ import annotations

import torch

__all__ = ['WAVEPLATE_MATERIALS', 'crystal_indices', 'birefringence']

# form tags: 'ghosh' n^2 = A + B l2/(l2-C) + D l2/(l2-E)
#            'sell3' n^2 = 1 + sum B_i l2/(l2 - C_i^2)
WAVEPLATE_MATERIALS = {
    'QUARTZ': ('ghosh',
               (1.28604141, 1.07044083, 1.00585997e-2,
                1.10202242, 100.0),
               (1.28851804, 1.09509924, 1.02101864e-2,
                1.15662475, 100.0)),
    'MGF2': ('sell3',
             ((0.48755108, 0.04338408), (0.39875031, 0.09461442),
              (2.3120353, 23.793604)),
             ((0.41344023, 0.03684262), (0.50497499, 0.09076162),
              (2.4904862, 23.771995))),
    'CALCITE': ('ghosh',
                (1.73358749, 0.96464345, 1.94325203e-2,
                 1.82831454, 120.0),
                (1.35859695, 0.82427830, 1.06689543e-2,
                 0.14429128, 120.0)),
}


def _n2(form, c, l2):
    if form == 'ghosh':
        A, B, C, D, E = c
        return A + B * l2 / (l2 - C) + D * l2 / (l2 - E)
    n2 = 1.0
    for B, C in c:
        n2 = n2 + B * l2 / (l2 - C * C)
    return n2


def _sqrt(x):
    return torch.sqrt(x) if torch.is_tensor(x) else x ** 0.5


def crystal_indices(material, lam_um):
    """``(n_o, n_e)`` of ``material`` at ``lam_um`` (a float or a tensor,
    microns; valid over the visible and near-infrared)."""
    form, co, ce = WAVEPLATE_MATERIALS[material.upper()]
    l2 = lam_um * lam_um
    return _sqrt(_n2(form, co, l2)), _sqrt(_n2(form, ce, l2))


def birefringence(material, lam_um):
    """``dn = n_e - n_o`` at ``lam_um`` (negative for calcite)."""
    n_o, n_e = crystal_indices(material, lam_um)
    return n_e - n_o
