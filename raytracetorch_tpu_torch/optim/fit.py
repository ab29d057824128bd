"""Design loops: torch optimizers over the scene's parameter dict, masked by
the scene's ``trainable()`` tree.

Counterpart of ``raytracetorch_tpu/optim/fit.py``.  The optax transforms
become ``torch.optim`` optimizers, and the masked gradient pytree becomes a
mask applied to each leaf's ``.grad`` after ``backward()``.

- Non-trainable leaves never enter an optimizer: every function returns
  them as they came, bit for bit, with or without ``scales``.
- There is no ``jit=`` argument.  In the JAX package it traced the whole
  loop into one compiled program; PyTorch runs eagerly, and each loop here is
  a Python loop around ``loss_fn``, so there is nothing to compile.
"""

from __future__ import annotations

import numpy as np
import torch


def _items(tree):
    """(element, key, tensor) of every leaf; a dict-valued parameter (a
    per-face ``coat_d``) gives one leaf per entry, keyed ``(key, entry)``."""
    for el, d in tree.items():
        for k, v in d.items():
            if isinstance(v, dict):
                for kk, vv in v.items():
                    yield el, (k, kk), vv
            else:
                yield el, k, v


def _lookup(tree, el, k):
    """The entry of ``tree`` (a trainable mask or a scales tree) for leaf
    ``(el, k)`` of ``_items``; a dict-valued parameter's mask may be one
    flag for all its entries."""
    if isinstance(k, tuple):
        v = tree[el][k[0]]
        return v[k[1]] if isinstance(v, dict) else v
    return tree[el][k]


def _nest(pairs):
    """``{el: {key: tensor}}`` from ``_items``-style (el, key, tensor)."""
    out = {}
    for el, k, v in pairs:
        d = out.setdefault(el, {})
        if isinstance(k, tuple):
            d.setdefault(k[0], {})[k[1]] = v
        else:
            d[k] = v
    return out


def _is_trainable(m):
    if isinstance(m, bool):
        return m
    return bool(torch.as_tensor(m, dtype=torch.float64).ne(0).any())


def grad_mask_fn(trainable):
    """Build ``mask(params)`` from a scene ``trainable()`` tree of
    True/False/float-mask leaves: after ``backward()`` it zeroes the
    ``.grad`` of False leaves and multiplies that of float-mask leaves by
    their mask, in place."""

    def apply(params):
        for el, k, p in _items(params):
            if p.grad is None:
                continue
            m = _lookup(trainable, el, k)
            if isinstance(m, bool):
                if not m:
                    p.grad.zero_()
            else:
                p.grad.mul_(torch.as_tensor(m, dtype=p.grad.dtype,
                                            device=p.grad.device))
    return apply


def trainable_leaves(params, trainable=None):
    """Set ``requires_grad`` on the trainable leaves of ``params`` (every
    leaf when ``trainable`` is None) and return them as a list, ready for a
    ``torch.optim`` optimizer."""
    leaves = [p for el, k, p in _items(params)
              if trainable is None
              or _is_trainable(_lookup(trainable, el, k))]
    for p in leaves:
        p.requires_grad_(True)
    return leaves


def _apply_scales(params, scales, trainable=None):
    """Reparameterize p = s * y, so optimizers see O(1)-scaled variables.

    ``scales`` is a (possibly partial) tree matching ``params``; missing
    leaves default to 1.  Returns ``(y, to_p)``: ``y`` holds each trainable
    leaf as a fresh leaf tensor p / s that requires grad, and each
    non-trainable leaf as the original tensor; ``to_p(y)`` maps back."""
    ys, s = [], {}
    for el, k, p in _items(params):
        if trainable is None or _is_trainable(_lookup(trainable, el, k)):
            sc = (_lookup(scales, el, k)
                  if scales and el in scales and
                  (k[0] if isinstance(k, tuple) else k) in scales[el]
                  else 1.0)
            s[(el, k)] = torch.as_tensor(sc, dtype=p.dtype, device=p.device)
            ys.append((el, k, (p.detach() / s[(el, k)]).requires_grad_(True)))
        else:
            ys.append((el, k, p))

    def to_p(y_):
        return _nest((el, k, v * s[(el, k)] if (el, k) in s else v)
                     for el, k, v in _items(y_))
    return _nest(ys), to_p


def _detached(tree):
    return _nest((el, k, v.detach()) for el, k, v in _items(tree))


def _setup(params, scales, trainable):
    """-> (y, to_p, leaves to optimize, gradient mask or None)."""
    y, to_p = _apply_scales(params, scales, trainable)
    leaves = [v for _, _, v in _items(y) if v.requires_grad]
    mask = grad_mask_fn(trainable) if trainable is not None else None
    return y, to_p, leaves, mask


def _run(opt_step, loss_fn, y, to_p, leaves, mask, steps):
    """Shared loop: ``opt_step(closure)`` once per step -> (params, losses
    [steps]), ``losses[i]`` the loss before step i."""
    def closure():
        for v in leaves:
            v.grad = None
        loss = loss_fn(to_p(y))
        loss.backward()
        if mask is not None:
            mask(y)
        return loss

    losses = [opt_step(closure).detach() for _ in range(steps)]
    return _detached(to_p(y)), torch.stack(losses)


def fit(loss_fn, params, trainable=None, optimizer=None, steps=100,
        lr=1e-3, scales=None):
    """Minimize ``loss_fn(params) -> scalar`` with a first-order optimizer.

    Returns ``(params, losses [steps])``, ``losses[i]`` the loss before step
    i.  ``optimizer`` is a callable ``leaves -> torch.optim.Optimizer``
    (default ``torch.optim.Adam(leaves, lr=lr)``).  Float-mask leaves
    receive a masked gradient, so Adam leaves their masked entries exactly
    where they were (zero gradient, zero moments).  ``scales``: optional
    partial tree of per-parameter magnitudes; the optimizer works on
    p / scale."""
    y, to_p, leaves, mask = _setup(params, scales, trainable)
    opt = (torch.optim.Adam(leaves, lr=lr) if optimizer is None
           else optimizer(leaves))

    def step(closure):
        loss = closure()
        opt.step()
        return loss
    return _run(step, loss_fn, y, to_p, leaves, mask, steps)


def fit_lbfgs(loss_fn, params, trainable=None, steps=50, **lbfgs_kw):
    """L-BFGS design loop: ``torch.optim.LBFGS`` with a strong-Wolfe line
    search, one iteration per step, masked like :func:`fit`.  The defaults
    follow optax's ``lbfgs``: history 10, at most 20 line-search evaluations
    per step (``max_eval=21``: torch counts the step's first evaluation and
    otherwise caps the line search at ``max_iter * 5 // 4 - 1`` evaluations,
    which is 0 for one iteration), and no stopping rule (torch's defaults end
    every later step once the loss moves by less than 1e-9 or no gradient
    entry exceeds 1e-7, which a loss of 1e-5 mm^2, such as an achromat's
    spot, meets long before it converges).  ``lbfgs_kw`` overrides the
    optimizer's arguments.  Returns ``(params, losses [steps])``."""
    y, to_p, leaves, mask = _setup(params, None, trainable)
    kw = dict(lr=1.0, max_iter=1, max_eval=21, history_size=10,
              tolerance_grad=0.0, tolerance_change=0.0,
              line_search_fn='strong_wolfe')
    kw.update(lbfgs_kw)
    opt = torch.optim.LBFGS(leaves, **kw)
    return _run(opt.step, loss_fn, y, to_p, leaves, mask, steps)


def fit_lm(residual_fn, params, trainable=None, steps=30, lam0=1e-3,
           lam_up=4.0, lam_down=0.5, scales=None):
    """Levenberg-Marquardt (damped least squares) over a residual vector,
    in the JAX package's ``mode='eager'`` form.

    ``residual_fn(params) -> [m]``; the merit is ``0.5 * sum(r^2)``.  Per
    step: the Jacobian of the residuals over the TRAINABLE entries only, by
    forward mode (``torch.func.jacfwd``: the parameters are dozens of
    scalars), the normal equations ``(J^T J + lam diag(J^T J)) dp = J^T r``
    solved on the host in float64, and accept/reject with lam down/up.
    Rejected steps keep the parameters.

    ``residual_fn`` must be built on the eager ``SequentialScene.simulate``:
    the fused trace's autograd Function has no forward-mode rule, as the
    JAX package's ``custom_vjp`` cannot be ``jacfwd``'d.

    Returns ``(params, costs [steps])`` (float64)."""
    entries = list(_items(params))
    base = [p.detach().reshape(-1) for _, _, p in entries]
    pos = []                     # (leaf, index, scale) of trainable entries
    for li, (el, k, p) in enumerate(entries):
        def flat(v):
            return torch.as_tensor(v, dtype=torch.float64).broadcast_to(
                p.shape).reshape(-1)
        m = flat(True if trainable is None else _lookup(trainable, el, k))
        sc = flat(_lookup(scales, el, k) if scales and el in scales and
                  (k[0] if isinstance(k, tuple) else k) in scales[el]
                  else 1.0)
        pos += [(li, j, float(sc[j]))
                for j in torch.nonzero(m != 0).reshape(-1).tolist()]
    if not pos:
        raise ValueError('fit_lm: no trainable parameter')
    ref = base[0]
    yt = torch.stack([base[li][j] / sc for li, j, sc in pos])

    def embed(yt_):
        vals = [list(b.unbind()) for b in base]
        for n, (li, j, sc) in enumerate(pos):
            vals[li][j] = yt_[n] * sc
        return _nest((el, k, torch.stack(v).reshape(p.shape))
                     for (el, k, p), v in zip(entries, vals))

    def res_flat(yt_):
        return residual_fn(embed(yt_)).reshape(-1)

    def host(t):
        return t.detach().to('cpu', torch.float64).numpy()

    jac_fn = torch.func.jacfwd(res_flat)
    lam = float(lam0)
    r = host(res_flat(yt))
    cost = 0.5 * float(r @ r)
    costs = []
    for _ in range(steps):
        jac = host(jac_fn(yt))
        jtj = jac.T @ jac
        jtr = jac.T @ r
        diag = np.maximum(np.diag(jtj), 1e-12)
        dp = np.linalg.solve(jtj + lam * np.diag(diag), jtr)
        y_new = yt - torch.as_tensor(dp, dtype=ref.dtype, device=ref.device)
        r_new = host(res_flat(y_new))
        cost_new = 0.5 * float(r_new @ r_new)
        if cost_new < cost:
            yt, r, cost = y_new, r_new, cost_new
            lam *= lam_down
        else:
            lam *= lam_up
        costs.append(cost)
    return _detached(embed(yt)), torch.tensor(costs, dtype=torch.float64)
