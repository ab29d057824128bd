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
- the non-sequential scene (``Scene``), with the ideal ``SphericalMirror``
  that folds rays back: the eager bounce loop (``Scene.simulate``) and the
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
  counterpart of the first TPU kernel, run by K1's kernel).

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
from .elements.aperture import CircularAperture  # noqa: E402
from .elements.base import Element  # noqa: E402
from .elements.diffractive import PhaseGridPlate  # noqa: E402
from .elements.ideal import (paraxial_dist_mat, paraxial_lens_mat,  # noqa: E402
                             paraxial_mirror_mat, paraxial_refract_mat)
from .elements.lens import SingletLens  # noqa: E402
from .elements.mirror import SphericalMirror  # noqa: E402
from .elements.sensor import SensorElement  # noqa: E402
from .geom.transform import Frame, rodrigues  # noqa: E402
from .ops.fused_nonseq import FusedNonseq, trace_nonseq_fused  # noqa: E402
from .ops.fused_trace import (FusedTrace, trace_sequential_fused,  # noqa: E402
                              trace_sequential_v1)
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
from .rays.sources import Bundle, CollimatedDisk, sample_bundles  # noqa: E402
from .scene.scene import Scene, SequentialScene  # noqa: E402
