"""Ray sources (bundles) sampled from an explicit ``torch.Generator``.

Counterpart of ``raytracetorch_tpu/rays/sources.py`` (``Bundle``,
``CollimatedDisk`` and ``PointSource`` with ``solid_angle_dirs`` and
``cdf_phi``; the other sources are ROADMAP Queue 1 item 14).  The JAX
package threads PRNG keys; here the caller passes a generator that lives on
the device the rays are drawn on.  The two give different numbers for the
same seed, so parity tests feed both packages the same rays; where a run
must trace a reference example's very rays, rays/reference_prng.py draws
them from the reference's key (``collimated_disk``, ``point_source``).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..geom.transform import Frame
from .ray import Rays

TWO_PI = 2.0 * math.pi


def _uniform(generator, n, lo, hi, dtype, device):
    u = torch.rand(n, generator=generator, dtype=dtype, device=device)
    return lo + (hi - lo) * u


@dataclasses.dataclass
class Bundle:
    """All rays at the local origin pointing +z, placed into the world by the
    bundle frame.  ``wavelength`` (um) tags every ray; 0 means unset."""

    frame: Frame
    ray_id: int = 0
    wavelength: float = 0.0

    @classmethod
    def make(cls, ray_id=0, rotation=None, translation=None,
             device=None, **kw):
        return cls(frame=Frame.create(rotation, translation, device=device),
                   ray_id=ray_id, **kw)

    def sample_pos(self, generator, n, dtype, device):
        return torch.zeros(n, 3, dtype=dtype, device=device)

    def sample_dir(self, generator, n, dtype, device):
        d = torch.zeros(n, 3, dtype=dtype, device=device)
        d[:, 2] = 1.0
        return d

    def sample(self, generator, n, device, dtype=torch.float32) -> Rays:
        """Draw n rays on ``device`` from ``generator`` (a torch.Generator
        on the same device)."""
        device = torch.device(device)
        pos = self.sample_pos(generator, n, dtype, device)
        direction = self.sample_dir(generator, n, dtype, device)
        frame = Frame(self.frame.rot_vec.to(device, dtype),
                      self.frame.trans.to(device, dtype))
        pos_g, dir_g = frame.place(pos, direction)
        wl = torch.full((n,), float(self.wavelength), dtype=dtype,
                        device=device)
        return Rays.create(pos_g, dir_g, ray_id=self.ray_id, wavelength=wl,
                           dtype=dtype, device=device)


def disk_sample(generator, n, r_inner2, r_outer2, dtype, device,
                theta_min=0.0, theta_max=TWO_PI):
    """Uniform annulus via the sqrt-of-uniform-radius^2 mapping."""
    r = torch.sqrt(_uniform(generator, n, r_inner2, r_outer2, dtype, device))
    theta = _uniform(generator, n, theta_min, theta_max, dtype, device)
    x, y = r * torch.cos(theta), r * torch.sin(theta)
    return torch.stack([x, y, torch.zeros_like(x)], dim=1)


@dataclasses.dataclass
class CollimatedDisk(Bundle):
    """Parallel +z rays over a disk of ``radius``."""

    radius: float = 1.0

    def sample_pos(self, generator, n, dtype, device):
        r = float(self.radius)
        return disk_sample(generator, n, 0.0, r * r, dtype, device)


def solid_angle_dirs(generator, n, cos_cap_F, dtype, device):
    """Uniform directions in a cone about +z: the polar angle from the
    inverse CDF acos(1 - 2F) with F ~ U(0, cos_cap_F), the azimuth
    uniform."""
    F = _uniform(generator, n, 0.0, cos_cap_F, dtype, device)
    phi = torch.arccos(torch.clamp(1.0 - 2.0 * F, -1.0, 1.0))
    theta = _uniform(generator, n, 0.0, TWO_PI, dtype, device)
    dr = torch.sin(phi)
    return torch.stack([torch.cos(theta) * dr, torch.sin(theta) * dr,
                        torch.cos(phi)], dim=1)


def cdf_phi(phi):
    """The solid-angle CDF of the polar angle phi, (1 - cos phi) / 2."""
    return (1.0 - math.cos(phi)) / 2.0


@dataclasses.dataclass
class PointSource(Bundle):
    """A diverging cone from the bundle origin about +z, its half angle
    asin(``na``), uniform in solid angle."""

    na: float = 0.1

    def sample_dir(self, generator, n, dtype, device):
        return solid_angle_dirs(generator, n,
                                cdf_phi(math.asin(float(self.na))), dtype,
                                device)


def sample_bundles(generator, bundles_with_counts, device,
                   dtype=torch.float32):
    """Sample each (bundle, n) in turn from one generator and concatenate."""
    batches = [b.sample(generator, n, device, dtype)
               for b, n in bundles_with_counts]
    return batches[0] if len(batches) == 1 else Rays.concatenate(batches)
