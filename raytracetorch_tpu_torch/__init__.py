"""raytracetorch_tpu_torch: the differentiable optical ray tracer on PyTorch
and CUDA.

A port of the JAX package ``raytracetorch_tpu`` (the reference, which stays
beside it) to PyTorch, with the TPU kernels rewritten by hand for NVIDIA
Hopper.  This slice covers the main path: a collimated disk source through a
singlet lens, a circular stop and a disk sensor, traced eagerly with
autograd (``SequentialScene.simulate``) or by the fused CUDA forward kernel
(``SequentialScene.simulate_fused``, ops/fused_trace.py).  ROADMAP.md lists
what is still to be ported.

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
from .core.trace import trace_sequential  # noqa: E402
from .elements.aperture import CircularAperture  # noqa: E402
from .elements.base import Element  # noqa: E402
from .elements.ideal import (paraxial_dist_mat, paraxial_lens_mat,  # noqa: E402
                             paraxial_mirror_mat, paraxial_refract_mat)
from .elements.lens import SingletLens  # noqa: E402
from .elements.sensor import SensorElement  # noqa: E402
from .geom.transform import Frame, rodrigues  # noqa: E402
from .ops.fused_trace import trace_sequential_fused  # noqa: E402
from .optim.goals import (focal_length_loss, spot_size_loss,  # noqa: E402
                          spot_target_loss)
from .rays.ray import Rays  # noqa: E402
from .rays.sources import Bundle, CollimatedDisk, sample_bundles  # noqa: E402
from .scene.scene import SequentialScene  # noqa: E402
