"""Entry points of the port on the flagship model: a forward step and one
training step.

Counterpart of ``__graft_entry__.py``: ``entry`` is the twin of its
``entry``, and ``train_step`` is the body of its ``_dryrun_multichip_impl``
without the mesh (the multi-device dry run is ROADMAP Queue 1 item 20).
"""

from __future__ import annotations

import torch

from .elements.aperture import CircularAperture
from .elements.lens import SingletLens
from .elements.sensor import SensorElement
from .optim.goals import spot_size_loss
from .rays.sources import CollimatedDisk
from .scene.scene import SequentialScene

N_RAYS = 8192


def flagship_scene():
    """The bench singlet with c1 and c2 trainable."""
    return SequentialScene([
        SingletLens(c1=0.05, c2=-0.05, d=10.0, t=3.0, ior_glass=1.5,
                    ior_media=1.0, c1_grad=True, c2_grad=True, name='lens'),
        CircularAperture(radius=5.0, name='stop'),
        SensorElement(radius=6.0, translation=[0.0, 0.0, 19.0],
                      name='sensor'),
    ])


def entry(device):
    """-> ``(forward, (params, rays))``: ``forward(params, rays)`` traces the
    flagship scene and returns the spot RMS per bundle, at 8192 rays on
    ``device``."""
    scene = flagship_scene()
    params = scene.init_params(device)
    gen = torch.Generator(device=device).manual_seed(0)
    rays = CollimatedDisk.make(radius=4.0,
                               translation=[0.0, 0.0, -10.0]).sample(
        gen, N_RAYS, device)

    def forward(params, rays):
        _, sensors, _ = scene.simulate(params, rays)
        return sensors.spot_rms(0)

    return forward, (params, rays)


def train_step(scene, params, opt, rays, mask):
    """One design step: ``simulate_fused`` -> ``spot_size_loss`` ->
    ``backward`` -> ``mask(params)`` -> ``opt.step()``.

    ``opt`` optimizes the trainable leaves of ``params`` (see
    ``optim.fit.trainable_leaves``) and ``mask`` is
    ``optim.fit.grad_mask_fn(scene.trainable())``.  Returns the loss before
    the step."""
    opt.zero_grad()
    _, sensors, _ = scene.simulate_fused(params, rays)
    loss = spot_size_loss(sensors)
    loss.backward()
    mask(params)
    opt.step()
    return loss.detach()
