"""raytracetorch_tpu_torch: the differentiable optical ray tracer on PyTorch
and CUDA.

A port of the JAX package ``raytracetorch_tpu`` (the reference, which stays
beside it) to PyTorch, with the TPU kernels rewritten by hand for NVIDIA
Hopper.  The port covers:

- the sequential main path: a collimated disk source through a singlet
  lens, a circular stop and a disk sensor, traced eagerly with autograd
  (``SequentialScene.simulate``) or by the fused CUDA kernels, K1 forward
  and K2 backward (``SequentialScene.simulate_fused``, ops/fused_trace.py);
- the design loop on top of either: Adam, L-BFGS and Levenberg-Marquardt
  (optim/fit.py) with log-barrier constraints (optim/constraints.py);
- the non-sequential scene (``Scene``), with mirrors that fold rays back: the eager bounce loop (``Scene.simulate``) and the
  fused kernels, K5 forward and K6 backward (``Scene.simulate_fused``,
  ops/fused_nonseq.py), so the design loops run on non-sequential scenes
  too;
- irradiance grids on every sensor (``scene.grid_shape = (H, W)``), binned
  by kernel K3 (ops/grid.py), inside K1 and K5 on the card, with K2 routing
  the grid's cotangent;
- deep optics: the pixelated ``PhaseGridPlate``, whose ``[H, W]`` phase map
  is a trainable parameter, in both scene types, eager and fused; kernel K4
  reads its bilinear corners and scatters their cotangents
  (ops/phase_grid.py), on its own in the eager trace and inside K1, K2, K5
  and K6;
- ``trace_sequential_v1``, the fused trace with every stream off (the
  counterpart of the first TPU kernel, run by K1's kernel);
- the mixed-surface and asphere scenes: the ``CylSingletLens`` (faces
  curved in y, side planes bounded by the faces' sags), the
  ``RectangularAperture``, rectangular sensors and the even-asphere
  ``AsphericLens``, eager and through K1, K2, K5 and K6, which take these
  kinds in an instantiation of their own;
- the single-bounce renderer (``render/camera.py``: ``Camera``,
  ``OrbitCamera``, ``Renderer``), plain torch on either device;
- chromatic dispersion: Abbe/Cauchy and Sellmeier glasses
  (``utils/glass.py``: ``glass``, ``glass_pair``) in ``SingletLens``,
  ``AsphericLens``, the cemented ``DoubletLens`` and ``TripletLens``, each
  ray refracting at the index of its wavelength, eager and through K1, K2,
  K5 and K6 (the instantiation of the extended kinds), which also return
  the wavelength's cotangent;
- the deterministic streams: the optical path length and the final medium
  (``track_opl``), the positions after every row or bounce
  (``record_paths``) and the hit records (``record_hits``), in ``simulate``
  and ``simulate_fused`` of both scene types, eager and through K1, K2, K5
  and K6 (an instantiation of their own), with the wavefront analysis that
  reads them (``utils/wavefront.py``: best focus, the RMS wavefront error,
  Zernike fits, interferograms) and the beam footprints
  (``utils/footprint.py``);
- Fresnel physics on uncoated interfaces: ``fresnel=True`` (the
  Monte-Carlo branch draw, FRESNEL) and ``fresnel='weighted'`` (FRESNEL_W)
  on every lens, and the ghost reflection REFLECT_W of the two-reflection
  ghost tables (``utils/ghosts.py``: ``ghost_pairs``, ``ghost_table``,
  ``ghost_trace``), eager and through K1, K2, K5 and K6; the draws come
  from the caller's generator (``rays/draws.py``: pre-drawn streams
  sequentially, counter-based Philox non-sequentially);
- thin-film coatings and metal mirrors: ``coating=`` stacks (dielectric or
  absorbing, per face or on both faces, trainable thicknesses ``coat_d``)
  on every lens with Fresnel physics, and the mirror family
  (``CylindricalMirror``, ``ParabolicMirror``, ``ParabolicMirrorXZ``,
  ``ConicMirror``, ``AsphericMirror``, ``ManginMirror``,
  ``ParabolicMirrorOffAxis`` beside ``SphericalMirror``) with ``metal=``,
  ``coating=`` and ``metal_dispersion=``, eager and through K1, K2, K5 and
  K6 (an instantiation of their own), with the pure thin-film functions of
  ``utils/coatings.py``;
- the diffractive and ideal elements: the radial-phase kinoform
  ``DiffractiveLens`` (trainable ``phase``, optional efficiency), the
  ``DiffractionGrating``, the ideal ``LinearElement``, ``IdealThinLens``,
  ``IdealCylThinLens`` and ``IdealMirror``, the ``MicrolensArray`` and the
  rotated ``EllipticAperture``, eager and through K1, K2, K5 and K6 (an
  instantiation of their own), with up to 18 bundles in the fused
  kernels;
- fuzzy apodization and the obscured telescope pupil: ``FuzzyAperture``
  (any callable of the surface-local hit, eagerly) and ``ObscuredAperture``
  (outer disk, central obscuration, spider vanes), through K1, K2, K5 and
  K6 (an instantiation of their own) for component-style callables, which
  the fused path traces into programs that the kernels interpret
  (ops/fuzzy_program.py);
- freeform, Zernike and wedge lenses: ``FreeformLens`` (XY-polynomial
  faces, trainable coefficients ``xy1``/``xy2``), ``ZernikeLens`` (Noll
  terms ``z1``/``z2``, expanded exactly into monomials on the host:
  geom/zernike.py) and ``WedgePrism``, eager and through K1, K2, K5 and K6
  (an instantiation of their own, which runs the Newton refinement of the
  freeform roots and, in K2 and K6, its reverse);
- convex solids, custom shapes and the point source: ``BoxElement``,
  ``Box4SideElement`` and ``CvxPolyhedronElement`` (faces bounded by each
  other's half-spaces, HALFSPACES), ``ElementCustom`` on the shape builders
  of elements/shapes.py (``plane`` to ``single_cone``, whose one nappe is
  the CONE_NAPPE bound) with an optional coating, and ``PointSource``, eager
  and through K1, K2, K5 and K6 (the two bounds run in the instantiation
  of the extended kinds and every one built on it).

ROADMAP.md lists what is still to be ported.

Every module mirrors the JAX module of the same path and names it in its
docstring.  Importing the package imports neither jax nor the JAX package.
"""

import torch

# TF32 keeps ~3 decimal digits: ray geometry needs full float32 products
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .constants import DispModel, GeomKind, PhysKind, SBKind, VBKind  # noqa: E402
from .core.sensor import SensorConfig, SensorState  # noqa: E402
from .core.static_dispatch import StaticRowMeta  # noqa: E402
from .core.table import (SurfaceRec, SurfaceTable, flatten_table_rows,  # noqa: E402
                         stack_records)
from .core.trace import trace_nonsequential, trace_sequential  # noqa: E402
from .elements.aperture import (CircularAperture,  # noqa: E402
                                ComponentFuzzy, EllipticAperture,
                                FuzzyAperture, ObscuredAperture,
                                RectangularAperture)
from .elements import shapes  # noqa: E402
from .elements.base import Element, ElementCustom  # noqa: E402
from .elements.diffractive import DiffractiveLens, PhaseGridPlate  # noqa: E402
from .elements.ideal import (DiffractionGrating, IdealCylThinLens,  # noqa: E402
                             IdealMirror, IdealThinLens, LinearElement,
                             paraxial_dist_mat, paraxial_lens_mat,
                             paraxial_mirror_mat, paraxial_refract_mat)
from .elements.lens import (AsphericLens, CylSingletLens,  # noqa: E402
                            DoubletLens, FreeformLens, SingletLens,
                            TripletLens, WedgePrism, ZernikeLens)
from .elements.mirror import (AsphericMirror, ConicMirror,  # noqa: E402
                              CylindricalMirror, ManginMirror,
                              ParabolicMirror, ParabolicMirrorOffAxis,
                              ParabolicMirrorXZ, SphericalMirror)
from .elements.mla import MicrolensArray  # noqa: E402
from .elements.sensor import SensorElement  # noqa: E402
from .elements.shapes import (cone, cylinder, disk, ellipse,  # noqa: E402
                              half_cyl, half_sphere, plane, quadric,
                              quadric_zy, rectangle, single_cone, sphere)
from .elements.solids import (Box4SideElement, BoxElement,  # noqa: E402
                              CvxPolyhedronElement, box_face_recs)
from .geom.transform import Frame, rodrigues  # noqa: E402
from .geom.zernike import (noll_nm, zernike_monomial_map,  # noqa: E402
                           zernike_xy_poly)
from .ops.fused_nonseq import (FusedNonseq, FusedNonseqStreams,  # noqa: E402
                               trace_nonseq_fused)
from .ops.fused_trace import (FusedTrace, FusedTraceStreams,  # noqa: E402
                              trace_sequential_fused, trace_sequential_v1)
from .ops.phase_grid import GridCorners, grid_corners  # noqa: E402
from .optim.constraints import (log_barrier, log_barrier_lb,  # noqa: E402
                                log_barrier_ub, spacing_constraint,
                                system_length_constraint,
                                thickness_constraint)
from .optim.fit import (fit, fit_lbfgs, fit_lm, grad_mask_fn,  # noqa: E402
                        trainable_leaves)
from .optim.goals import (focal_length_loss, spot_size_loss,  # noqa: E402
                          spot_target_loss)
from .rays.ray import Rays  # noqa: E402
from .rays.sources import (Bundle, CollimatedDisk, PointSource,  # noqa: E402
                           cdf_phi, sample_bundles, solid_angle_dirs)
from .scene.scene import Scene, SequentialScene  # noqa: E402
from .utils.coatings import (METAL_GRID_UM, METAL_NK, METALS,  # noqa: E402
                              coating_rt, metal_nk_at, metal_reflectance,
                              parse_coating_entries,
                              unpolarized_metal_reflectance,
                              unpolarized_reflectance)
from .utils.footprint import footprint_report, footprints  # noqa: E402
from .utils.ghosts import ghost_pairs, ghost_table, ghost_trace  # noqa: E402
from .utils.glass import glass, glass_pair  # noqa: E402
from .utils.wavefront import (ZERNIKE_NAMES, best_focus,  # noqa: E402
                              interferogram, opl_to_point, wavefront_rms,
                              zernike_basis, zernike_fit, zernike_name)
