"""Ray batch state as a structure of planar ``[N]`` tensors.

Counterpart of ``raytracetorch_tpu/rays/ray.py``.  The compute core reads
the component tuples ``pos_c`` / ``dir_c``; ``pos`` / ``dir`` materialize
``[N, 3]`` views for user code.  Updates are functional
(``masked_update`` returns a new batch), so autograd sees every step.
"""

from __future__ import annotations

import dataclasses

import torch

from ..geom import vec3 as v3


@dataclasses.dataclass
class Rays:
    px: torch.Tensor           # [N]
    py: torch.Tensor
    pz: torch.Tensor
    dx: torch.Tensor           # [N] unit direction components
    dy: torch.Tensor
    dz: torch.Tensor
    intensity: torch.Tensor    # [N]
    ray_id: torch.Tensor       # [N] int32 bundle tag
    wavelength: torch.Tensor   # [N] um; 0 = unset

    @classmethod
    def create(cls, pos, direction, intensity=None, ray_id=0,
               wavelength=None, dtype=torch.float32, device=None):
        """From [N, 3] position and direction (directions are normalized
        here); every component is stored as its own contiguous [N] tensor."""
        pos = torch.atleast_2d(torch.as_tensor(pos, dtype=dtype,
                                               device=device))
        direction = torch.atleast_2d(torch.as_tensor(direction, dtype=dtype,
                                                     device=device))
        device = pos.device
        n = pos.shape[0]
        intensity = (torch.ones(n, dtype=dtype, device=device)
                     if intensity is None
                     else torch.as_tensor(intensity, dtype=dtype,
                                          device=device))
        wavelength = (torch.zeros(n, dtype=dtype, device=device)
                      if wavelength is None
                      else torch.as_tensor(wavelength, dtype=dtype,
                                           device=device))
        ray_id = torch.as_tensor(ray_id, dtype=torch.int32, device=device)
        if ray_id.ndim == 0:
            ray_id = ray_id.expand(n).contiguous()
        d = v3.from_array(direction)
        inv = 1.0 / torch.sqrt(torch.clamp(v3.norm2(d), min=1e-12))
        px, py, pz = (c.contiguous() for c in v3.from_array(pos))
        return cls(px=px, py=py, pz=pz, dx=d[0] * inv, dy=d[1] * inv,
                   dz=d[2] * inv, intensity=intensity, ray_id=ray_id,
                   wavelength=wavelength)

    @property
    def pos(self):
        """[N, 3] position view (materialized on access)."""
        return v3.to_array(self.pos_c)

    @property
    def dir(self):
        """[N, 3] direction view (materialized on access)."""
        return v3.to_array(self.dir_c)

    @property
    def pos_c(self):
        return (self.px, self.py, self.pz)

    @property
    def dir_c(self):
        return (self.dx, self.dy, self.dz)

    @property
    def n(self):
        return self.px.shape[0]

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    def to(self, device):
        return Rays(**{f.name: getattr(self, f.name).to(device)
                       for f in dataclasses.fields(self)})

    def masked_update(self, mask, new_pos, new_dir, intensity_mod):
        """where(mask, new, old) on position and direction; intensity is
        multiplied by ``intensity_mod`` where ``mask`` holds."""
        p = v3.where(mask, new_pos, self.pos_c)
        d = v3.where(mask, new_dir, self.dir_c)
        return self.replace(
            px=p[0], py=p[1], pz=p[2], dx=d[0], dy=d[1], dz=d[2],
            intensity=torch.where(mask, self.intensity * intensity_mod,
                                  self.intensity))

    @staticmethod
    def concatenate(batches):
        return Rays(**{f.name: torch.cat([getattr(b, f.name)
                                          for b in batches])
                       for f in dataclasses.fields(Rays)})
