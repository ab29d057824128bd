"""Gradient-index rod element (SELFOC / radial-GRIN lens).

Counterpart of ``raytracetorch_tpu/elements/grin.py``.  A cylindrical rod
whose squared index follows

    n^2(r, z) = n0^2 (1 - A r^2) + a4 r^4 + az z

traced by fixed-step RK4 (core/grin.py; ``PhysKind.GRIN``).  ``n0``, ``A``
(``grin_A``), ``a4``, ``az`` and the thickness ``t`` are ordinary
parameters: pitch, focal length and profile shape are designable by
gradient.

For the pure parabolic profile (a4 = az = 0) every ray is sinusoidal with
conserved axial momentum pz:

    x(z) = x0 cos(w z) + (px0 / (pz w)) sin(w z),   w = n0 sqrt(A) / pz

the classic pitch P = 2 pi / w; a quarter-pitch rod (L = P/4) focuses a
collimated beam onto its exit face.  These closed forms are the regression
anchors and the basis of the paraxial matrix below.
"""

from __future__ import annotations

import math

import torch

from ..constants import PhysKind, SBKind
from ..core.table import SurfaceRec
from ..geom.surfaces import q_plane
from ..geom.transform import mm
from .base import Element, compose_world, frame_params
from .ideal import _mat, paraxial_dist_mat, paraxial_refract_mat


class GrinRod(Element):
    """Radial-GRIN rod: entry face at local z = -t/2, exit at +t/2 (centred
    like the lens elements), disk radius ``radius``.

    ``grin_A`` is the radial constant A in n^2 = n0^2 (1 - A r^2)
    [1/length^2]; the on-axis quarter pitch is pi / (2 sqrt(A)).  ``a4``
    adds an r^4 term to n^2, ``az`` a linear axial term.  ``n_steps``
    (static) sets the RK4 resolution; 64 resolves a quarter pitch to
    ~1e-7.  Rays that leave the radius mid-rod, turn around or are totally
    reflected at the exit face die (intensity 0): the barrel absorbs."""

    def __init__(self, radius, thickness, n0=1.6, grin_A=0.01, a4=0.0,
                 az=0.0, n_ambient=1.0, n_steps=64, n0_grad=False,
                 grin_A_grad=False, a4_grad=False, az_grad=False,
                 t_grad=False, name='grin', **kw):
        super().__init__(name=name, **kw)
        if float(radius) <= 0 or float(thickness) <= 0:
            raise ValueError('radius and thickness must be positive')
        if float(n0) <= 0:
            raise ValueError(f'n0 must be positive, got {n0}')
        edge = float(n0) ** 2 * (1.0 - float(grin_A) * float(radius) ** 2)
        if edge <= 0:
            raise ValueError('n^2 must stay positive across the rod: '
                             f'n0^2 (1 - A R^2) = {edge}')
        self._r_init = float(radius)
        self._t_init = float(thickness)
        self._n0_init = float(n0)
        self._A_init = float(grin_A)
        self._a4_init = float(a4)
        self._az_init = float(az)
        self._namb_init = float(n_ambient)
        self.n_steps = int(n_steps)
        self._grads = {'n0': bool(n0_grad), 'grin_A': bool(grin_A_grad),
                       'a4': bool(a4_grad), 'az': bool(az_grad),
                       't': bool(t_grad)}

    @property
    def n_surfaces(self):
        return 1        # the entry plane carries the whole interaction

    def extra_params(self):
        return {'radius': self._r_init, 't': self._t_init,
                'n0': self._n0_init, 'grin_A': self._A_init,
                'a4': self._a4_init, 'az': self._az_init,
                'n_ambient': self._namb_init}

    def extra_trainable(self):
        return {'radius': False, 't': self._grads['t'],
                'n0': self._grads['n0'], 'grin_A': self._grads['grin_A'],
                'a4': self._grads['a4'], 'az': self._grads['az'],
                'n_ambient': False}

    def build(self, p):
        Re, te = frame_params(p)
        q, sign = q_plane(te.dtype, te.device)
        zero = torch.zeros_like(p['t'])
        ts_entry = torch.stack([zero, zero, -0.5 * p['t']])
        Rw, tw, Rs, ts = compose_world(Re, te, ts=ts_entry)
        c0 = p['n0'] ** 2
        c2 = -c0 * p['grin_A']
        return [SurfaceRec(q=q, n_sign=sign, Rw=Rw, tw=tw, Rs=Rs, ts=ts,
                           sb_kind=SBKind.DISK, sb=(p['radius'] ** 2,),
                           is_plane=True, ph_kind=PhysKind.GRIN,
                           ph=(p['n_ambient'], c0, c2, p['a4'], p['az'],
                               p['t']),
                           grin_steps=self.n_steps)]

    def paraxial(self, p):
        """The exact parabolic-rod 5x5 chain: the entry face's flat
        refraction at z0 - t/2, then a closing matrix at z0 + t/2 chosen so
        that M_out @ dist(t) @ M_in is the closed-form GRIN ABCD

            A = cos(g t)            B = sin(g t) / (n0 g)
            C = -n0 g sin(g t)      D = cos(g t)        g = sqrt(A_grin)

        (true-angle convention, the ambient index on both sides; the a4
        and az terms are beyond paraxial and ignored here)."""
        f = self.frame(p)
        t, t_inv = f.paraxial(), f.paraxial_inv()
        z0 = p['trans'][2]
        L = p['t']
        n0, namb = p['n0'], p['n_ambient']
        g = torch.sqrt(torch.clamp(p['grin_A'], min=1e-30))
        cg, sg = torch.cos(g * L), torch.sin(g * L)
        b, c = namb * sg / (n0 * g), -n0 * g * sg / namb
        m = _mat({(0, 0): cg, (0, 1): b, (1, 0): c, (1, 1): cg,
                  (2, 2): cg, (2, 3): b, (3, 2): c, (3, 3): cg}, L)
        m_in = paraxial_refract_mat(torch.zeros_like(L), torch.zeros_like(L),
                                    namb, n0)
        # closing matrix: undo the chain's in-rod gap and the entry
        # refraction, then apply the exact rod matrix
        m_out = mm(m, torch.linalg.inv(mm(paraxial_dist_mat(L), m_in)))
        return ([z0 - 0.5 * L, z0 + 0.5 * L],
                [mm(t_inv, mm(m_in, t)), mm(t_inv, mm(m_out, t))])

    def optical_zs(self, p):
        z0 = p['trans'][2]
        return [z0 - 0.5 * p['t'], z0 + 0.5 * p['t']]

    def pitch(self):
        """The nominal on-axis pitch 2 pi / sqrt(A) (initial values)."""
        return 2.0 * math.pi / math.sqrt(self._A_init)
