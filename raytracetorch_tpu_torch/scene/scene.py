"""Sequential scene: element specs -> surface table -> trace.

Counterpart of ``SequentialScene`` in ``raytracetorch_tpu/scene/scene.py``
(the non-sequential ``Scene`` is ROADMAP Queue 1 item 13).  The scene holds
static structure; the parameters are a dict of per-element dicts of tensors
keyed by element name.

Two trace entry points share one contract, ``(params, rays) -> (rays,
sensors, aux)``:

- ``simulate`` runs the eager, differentiable trace (core/trace.py);
- ``simulate_fused`` runs the fused forward kernel (ops/fused_trace.py) at
  every N.  The JAX package's auto-dispatch below a crossover N was measured
  on a TPU and is not carried over; gradients through the fused path need
  the backward kernel K2 (ROADMAP Queue 2).
"""

from __future__ import annotations

import torch

from ..core.sensor import SensorConfig
from ..core.static_dispatch import StaticRowMeta
from ..core.table import stack_records
from ..core.trace import trace_sequential
from ..elements.ideal import paraxial_dist_mat
from ..geom.transform import mm
from ..ops.fused_trace import trace_sequential_fused


class SequentialScene:
    """Ordered surface-by-surface propagation: the lens-design workhorse and
    the benchmark configuration."""

    def __init__(self, elements=None):
        self.elements = list(elements or [])
        self._static_meta = None

    # -- parameters --------------------------------------------------------

    def init_params(self, device, dtype=torch.float32):
        """{element name: {param: tensor}} on ``device``.  Names must be
        unique: a duplicate would silently alias two elements onto one
        parameter slot."""
        seen = {}
        for el in self.elements:
            if el.name in seen:
                raise ValueError(
                    f"duplicate element name '{el.name}' "
                    f"({type(seen[el.name]).__name__} and "
                    f"{type(el).__name__}): give each element a unique "
                    f"name= (params are keyed by name)")
            seen[el.name] = el
        return {el.name: el.init_params(device, dtype)
                for el in self.elements}

    def trainable(self):
        return {el.name: el.trainable() for el in self.elements}

    # -- compilation -------------------------------------------------------

    @property
    def n_sensors(self):
        return sum(1 for el in self.elements if el.is_sensor)

    def sensor_config(self, n_bundles=1):
        return SensorConfig(n_sensors=self.n_sensors, n_bundles=n_bundles)

    def build_table(self, params):
        """Flatten all elements into a SurfaceTable on the params' device."""
        first = next(iter(params[self.elements[0].name].values()))
        recs, elem_ids, surf_ids = [], [], []
        slot = 0
        for k, el in enumerate(self.elements):
            el_recs = el.build(params[el.name])
            if el.is_sensor:
                for r in el_recs:
                    r.sensor_slot = slot
                slot += 1
            recs.extend(el_recs)
            elem_ids.extend([k] * len(el_recs))
            surf_ids.extend(range(len(el_recs)))
        return stack_records(recs, elem_ids, surf_ids, dtype=first.dtype,
                             device=first.device)

    def static_meta(self):
        """Per-row kinds, read once off a build with the initial params
        (kinds are structural: they do not depend on parameter values)."""
        if self._static_meta is None:
            meta, slot = [], 0
            for el in self.elements:
                for r in el.build(el.init_params('cpu')):
                    meta.append(StaticRowMeta(
                        r.ph_kind, r.sb_kind, r.vb_kind, r.is_sensor,
                        r.sb_invert, plane=r.is_plane,
                        slot=slot if el.is_sensor else 0,
                        dispm=(0, 0)))     # non-dispersive on both sides
                if el.is_sensor:
                    slot += 1
            self._static_meta = meta
        return self._static_meta

    # -- simulation --------------------------------------------------------

    def simulate(self, params, rays, n_bundles=1):
        """Eager differentiable trace -> (rays, sensors, aux)."""
        return trace_sequential(self.build_table(params), rays,
                                self.sensor_config(n_bundles),
                                self.static_meta())

    def simulate_fused(self, params, rays, n_bundles=1):
        """Fused forward trace (CUDA kernel on the card, its plain version
        on the CPU) -> (rays, sensors, aux).  Forward only: raises while any
        table tensor requires grad instead of routing to ``simulate``."""
        table = self.build_table(params)
        if any(getattr(table, f).requires_grad
               for f in table.__dataclass_fields__):
            raise NotImplementedError(
                'fused backward is ROADMAP Queue 2 K2; use simulate')
        out, sensors = trace_sequential_fused(
            table, rays, self.sensor_config(n_bundles), self.static_meta())
        return out, sensors, {}

    def paraxial(self, params):
        """Full-system 5x5 paraxial matrix: every element's surface matrices
        chained with free-space gaps."""
        all_z, all_m = [], []
        for el in self.elements:
            zs, mats = el.paraxial(params[el.name])
            all_z.extend(zs)
            all_m.extend(mats)
        m_sys = all_m[0]
        for i in range(len(all_m) - 1):
            dz = all_z[i + 1] - all_z[i]
            m_sys = mm(paraxial_dist_mat(dz), m_sys)
            m_sys = mm(all_m[i + 1], m_sys)
        return m_sys
