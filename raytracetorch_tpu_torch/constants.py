"""Numeric constants and kind enums of the trace engine.

Counterpart of ``raytracetorch_tpu/constants.py``.  The values are copied,
not imported: importing the JAX package would import jax.

- ``INTERSECT_EPS``: smallest accepted ray parameter t (self-intersection
  guard; the world-scale term lives in ``geom.surfaces.REL_EPS``).
- ``SOLVER_EPS``: |A| below which the surface quadratic falls back to the
  linear root t = -C / B.
- ``BIG``: finite stand-in for "miss", so masked arithmetic never forms
  inf - inf in the forward or the backward pass.
"""

import enum

INTERSECT_EPS = 1e-6
SOLVER_EPS = 1e-6
SHAPE_EPS = 1e-7
NORMAL_EPS = 1e-8
BIG = 1e30
HIT_THRESHOLD = 1e29

CVX_EPS = 1e-4
CYL_RECT_EPS = 1e-5
CYL_EDGE_EPS = 1e-4

MAX_HALFSPACES = 8
MAX_COAT_LAYERS = 8
MAX_FF_TERMS = 32


class GeomKind(enum.IntEnum):
    """Analytic surface families, all special cases of the diagonal quadric
    ``qx x^2 + qy y^2 + qz z^2 + lz z + q0 = 0`` (see geom/surfaces.py)."""

    PLANE = 0
    SPHERE = 1
    CYLINDER = 2
    QUADRIC = 3
    QUADRIC_ZY = 4
    CONE = 5


class SBKind(enum.IntEnum):
    """Surface-local bounds, applied per candidate root."""

    NONE = 0
    DISK = 1         # params [radius^2, cx, cy]
    RECT = 2         # params [hx, hy]
    ELLIPSE = 3      # params [r_major, r_minor, rot]
    HEMI = 4         # params [c]; |z*c| < 1+eps
    HEMI_APER = 5    # params [c, (D/2)^2]
    CONE_NAPPE = 6   # params [slope]; z*slope >= -eps


class VBKind(enum.IntEnum):
    """Volume bounds, applied to the chosen hit in the element frame."""

    NONE = 0
    APER_R2 = 1      # params [radius^2]
    Z_BETWEEN = 2    # params [z_lo, z_hi]
    RECT = 3         # params [xmin, xmax, ymin, ymax]
    CYL_EDGE = 4     # params [c1, z1, c2, z2, xmin, xmax, ymin, ymax]
    HALFSPACES = 5   # uses the hp_n / hp_d / hp_mask columns


class DispModel(enum.IntEnum):
    """Per-medium chromatic dispersion model of a surface side."""

    NONE = 0
    CAUCHY = 1
    SELLMEIER = 2


class PhysKind(enum.IntEnum):
    """Surface interaction models (semantics in the JAX package's
    constants.py; the port runs the ones core/static_dispatch.py lists)."""

    TRANSMIT = 0
    BLOCK = 1
    REFLECT = 2
    SNELL = 3
    FRESNEL = 4
    LINEAR = 5
    APERTURE = 6
    GRATING = 7
    FRESNEL_W = 8
    REFLECT_W = 9
    SCATTER = 10
    JONES = 11
    GRIN = 12
    DOE = 13
    MLA = 14
    PHASE_GRID = 15
