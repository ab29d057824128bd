"""Zernike polynomials' Noll ordering.

Counterpart of ``raytracetorch_tpu/geom/zernike.py``, so far only
``noll_nm``, which ``utils/wavefront.py::zernike_basis`` needs; the
monomial expansion of the Zernike-sag surfaces comes with the freeform
lenses (ROADMAP Queue 1 item 14).  Conventions as the JAX package's: Noll
ordering, m >= 0 -> cos(m theta), m < 0 -> sin(|m| theta), no
normalization factor.
"""

from __future__ import annotations


def noll_nm(j):
    """Radial/azimuthal orders (n, m) of Noll index ``j`` (j >= 1).

    Noll's rule: terms sorted by n, then |m| ascending; the sign of m is
    chosen so even j carries cos (m > 0) and odd j carries sin (m < 0).
    """
    if j < 1:
        raise ValueError(f"Noll index starts at 1, got {j}")
    jj = 0
    n = 0
    while True:
        for m_abs in range(n % 2, n + 1, 2):
            reps = 1 if m_abs == 0 else 2
            for _ in range(reps):
                jj += 1
                if jj == j:
                    if m_abs == 0:
                        return n, 0
                    return n, (m_abs if jj % 2 == 0 else -m_abs)
        n += 1
