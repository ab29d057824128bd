"""Scenes: element specs -> surface table -> trace.

Counterpart of ``Scene`` and ``SequentialScene`` in
``raytracetorch_tpu/scene/scene.py``.  A scene holds static structure
(elements, bundles, bounce budget, grid shape); the parameters are a dict of
per-element dicts of tensors keyed by element name.

Both scene types share one contract, ``(params, rays) -> (rays, sensors,
aux)``:

- ``Scene`` is the non-sequential nearest-hit bounce loop within a budget of
  ``n_bounces``.  ``simulate`` runs it eagerly under autograd
  (core/trace.py::trace_nonsequential); ``simulate_fused`` runs kernel K5
  forward and, under grad, kernel K6 backward (ops/fused_nonseq.py).
- ``SequentialScene`` visits every surface once in order.  ``simulate`` is
  the eager chain; ``simulate_fused`` runs kernel K1 forward and, under
  grad, kernel K2 backward (ops/fused_trace.py) at every N.  The JAX
  package's auto-dispatch below a crossover N was measured on a TPU and is
  not carried over.

``grid_shape = (H, W)`` and ``grid_half_extent`` give every sensor an
irradiance grid (``sensors.grid [S, H, W]``), binned by kernel K3 on the
card.  A ``PhaseGridPlate``'s ``[H, W]`` map rides the side channel
``side_grids(params)`` into every trace, eager and fused.

Ray sources are registered with ``add_bundle`` and drawn with
``sample_rays``; the sensor moments keep one column per bundle, so
``n_bundles=None`` means the scene's bundle count, as in the JAX package.
"""

from __future__ import annotations

import torch

from ..core.sensor import SensorConfig
from ..core.static_dispatch import StaticRowMeta
from ..core.table import stack_records
from ..core.trace import nearest_hit, trace_nonsequential, trace_sequential
from ..elements.ideal import paraxial_dist_mat
from ..geom.transform import mm
from ..ops.fused_nonseq import trace_nonseq_fused
from ..ops.fused_trace import trace_sequential_fused
from ..rays.sources import sample_bundles


class Scene:
    """Non-sequential scene: nearest-hit bounce simulation."""

    def __init__(self, elements=None, n_bounces=100):
        self.elements = list(elements or [])
        self.bundles = []          # list of (Bundle, n_rays)
        self.n_bounces = n_bounces
        self.grid_shape = ()
        self.grid_half_extent = 1.0
        self._static_meta = None

    # -- population --------------------------------------------------------

    def add_element(self, element):
        self.elements.append(element)
        self._static_meta = None
        return element

    def add_bundle(self, bundle, n_rays=200):
        self.bundles.append((bundle, n_rays))
        return bundle

    def clear_elements(self):
        self.elements = []
        self._static_meta = None

    def clear_bundles(self):
        self.bundles = []

    def find_element(self, name):
        for el in self.elements:
            if el.name == name:
                return el
        raise KeyError(f'No element named {name!r}')

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

    @property
    def n_bundles(self):
        return max(len(self.bundles), 1)

    def sensor_config(self, n_bundles=None):
        return SensorConfig(
            n_sensors=self.n_sensors,
            n_bundles=self.n_bundles if n_bundles is None else n_bundles,
            grid_shape=tuple(self.grid_shape),
            grid_half_extent=float(self.grid_half_extent))

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

    def sample_rays(self, generator, device, bundles=None, dtype=None):
        """Sample and merge the registered bundles (or ``bundles``, a list
        of (Bundle, n_rays)) from ``generator``, a torch.Generator on
        ``device``."""
        spec = self.bundles if bundles is None else bundles
        return sample_bundles(generator, spec, device,
                              torch.float32 if dtype is None else dtype)

    def ray_cast(self, params, rays):
        """Nearest-hit query without gradients: the winning row per ray
        (``surface``), its ``element`` and ``surf_in_element`` from the
        table's index maps, and the ``hit`` mask."""
        table = self.build_table(params)
        win, hit = nearest_hit(table, rays.pos_c, rays.dir_c,
                               self.static_meta())
        return dict(surface=win, element=table.elem_id[win],
                    surf_in_element=table.surf_id[win], hit=hit)

    def side_grids(self, params):
        """{flat row: [H, W] map} of the PHASE_GRID rows (pixelated phase
        plates): the maps do not fit the fixed-width table row.  Built from
        params on every call, so gradients reach every pixel."""
        out, k = {}, 0
        for el in self.elements:
            hook = getattr(el, 'phase_grid', None)
            if hook is not None:
                out[k] = hook(params[el.name])
            k += el.n_surfaces
        return out

    def simulate(self, params, rays, n_bundles=None, **kw):
        """Eager differentiable bounce loop -> (rays, sensors, aux).  The
        JAX bounce loop's optional streams (``record_paths``, ``track_opl``, ...)
        raise NotImplementedError naming their ROADMAP item."""
        kw.setdefault('grids', self.side_grids(params))
        return trace_nonsequential(self.build_table(params), rays,
                                   self.n_bounces,
                                   self.sensor_config(n_bundles),
                                   self.static_meta(), **kw)

    def simulate_fused(self, params, rays, n_bundles=None):
        """Fused bounce loop -> (rays, sensors, aux): kernel K5 on the card,
        its plain version on the CPU.  Each ray leaves the loop at its first
        bounce with no hit, so the default budget of 100 costs what the
        scene needs.  Differentiable with respect to the params (phase maps
        included) and the ray streams px..intensity (K6 in backward on the
        card); first order only."""
        out, sensors = trace_nonseq_fused(
            self.build_table(params), rays, self.sensor_config(n_bundles),
            self.static_meta(), self.n_bounces,
            grids=self.side_grids(params))
        return out, sensors, {}

    # -- conversions -------------------------------------------------------

    def to_sequential(self, params=None):
        """A SequentialScene of the same elements, sorted by their z."""
        params = params or self.init_params('cpu')
        order = sorted(self.elements,
                       key=lambda el: float(params[el.name]['trans'][2]))
        seq = SequentialScene(order, n_bounces=self.n_bounces)
        seq.bundles = list(self.bundles)
        seq.grid_shape = self.grid_shape
        seq.grid_half_extent = self.grid_half_extent
        return seq


class SequentialScene(Scene):
    """Ordered surface-by-surface propagation: the lens-design workhorse and
    the benchmark configuration."""

    def simulate(self, params, rays, n_bundles=None):
        """Eager differentiable trace -> (rays, sensors, aux)."""
        return trace_sequential(self.build_table(params), rays,
                                self.sensor_config(n_bundles),
                                self.static_meta(),
                                grids=self.side_grids(params))

    def simulate_fused(self, params, rays, n_bundles=None):
        """Fused trace -> (rays, sensors, aux): the CUDA kernels on the card
        (K1 forward, K2 backward under grad), their plain versions on the
        CPU.  Differentiable with respect to the params (phase maps
        included) and the ray streams px..intensity; first order only."""
        out, sensors = trace_sequential_fused(
            self.build_table(params), rays, self.sensor_config(n_bundles),
            self.static_meta(), grids=self.side_grids(params))
        return out, sensors, {}

    def to_base(self):
        """A non-sequential Scene of the same elements."""
        base = Scene(self.elements, n_bounces=self.n_bounces)
        base.bundles = list(self.bundles)
        base.grid_shape = self.grid_shape
        base.grid_half_extent = self.grid_half_extent
        return base

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
