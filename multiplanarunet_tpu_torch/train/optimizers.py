"""The JAX package's nine optimizers, computing what optax computes.

`multiplanarunet_tpu/train/utils.py` builds `optax.inject_hyperparams(
optax.<name>)(**kwargs)`. The classes here apply the same update rules in
the same order (optax 0.2.6: `scale_by_adam`, `scale_by_adamax`,
`scale_by_rms`, `scale_by_rss`, `scale_by_lion`, `add_decayed_weights`,
`scale_by_trust_ratio`, `trace`, `scale_by_learning_rate`,
`apply_updates`), with optax's defaults rather than torch.optim's:

- AdamW's weight_decay defaults to 1e-4 (torch: 1e-2);
- RMSprop takes eps inside the square root and its decay defaults to 0.9;
- Adagrad starts its accumulator at 0.1 and takes eps 1e-7 inside the
  root;
- Lamb (eps 1e-6) and Lion (b2 0.99, weight_decay 1e-3) have no
  torch.optim class.

Every hyperparameter is held as a float32 value, as inject_hyperparams
holds it, and the learning rate is settable between steps
(`learning_rate`), as ReduceLROnPlateau needs.

The parameters are packed into one contiguous float32 vector (each
parameter a view into it, at a 256-byte aligned offset), so a step is a
handful of elementwise kernels over that vector whatever the number of
parameter tensors. `Optimizer.step()` copies the parameters' .grad into
the packed gradient (zeros for a parameter that got none, as
jax.grad gives) and updates the packed parameters in place.
"""

from __future__ import annotations

import numpy as np
import torch

# Packed offsets are multiples of this many float32 elements (256 bytes)
_ALIGN = 64


def _f32(x):
    """x rounded to float32, as a Python float (exact in a float32 op)."""
    return float(np.float32(x))


def _bias_correction(decay, count):
    """1 - decay**count in float32, as optax computes it."""
    return _f32(np.float32(1.0) - np.power(np.float32(decay),
                                           np.float32(count)))


class UnsupportedOptimizerOptionError(ValueError):
    """An optax option the port does not implement (a non-default dtype, a
    weight-decay mask, centered RMSprop)."""


class PackedParameters:
    """A list of parameters re-homed as views of one float32 vector, with a
    gradient vector of the same layout."""

    def __init__(self, params):
        self.params = list(params)
        if not self.params:
            raise ValueError("no parameters to optimise")
        device = self.params[0].device
        offsets, total = [], 0
        for p in self.params:
            if p.dtype != torch.float32 or p.device != device:
                raise ValueError("parameters must be float32 on one device")
            offsets.append(total)
            total += -(-p.numel() // _ALIGN) * _ALIGN
        self.offsets = offsets
        self.data = torch.zeros(total, dtype=torch.float32, device=device)
        self.grad = torch.zeros_like(self.data)
        self.param_views, self.grad_views = [], []
        with torch.no_grad():
            for p, off in zip(self.params, offsets):
                view = self.data[off:off + p.numel()].view_as(p)
                view.copy_(p)
                p.data = view
                self.param_views.append(view)
                self.grad_views.append(
                    self.grad[off:off + p.numel()].view_as(p))

    def gather_grads(self):
        """Copy every parameter's .grad into the packed gradient."""
        have = [(v, p.grad) for v, p in zip(self.grad_views, self.params)
                if p.grad is not None]
        missing = [v for v, p in zip(self.grad_views, self.params)
                   if p.grad is None]
        if have:
            torch._foreach_copy_([v for v, _ in have], [g for _, g in have])
        if missing:
            torch._foreach_zero_(missing)
        return self.grad


class Optimizer:
    """Base: holds the packed parameters, the float32 hyperparameters and
    the step count; subclasses define `_init_state` and `_updates`, which
    returns the update before the learning rate (optax's chain up to
    scale_by_learning_rate)."""

    name = None
    # optax's parameter names of this optimizer (inspect.signature of the
    # optax function), for the Keras -> optax kwarg translation
    accepted = ()

    def __init__(self, params, learning_rate):
        self.packed = PackedParameters(params)
        self.learning_rate = learning_rate
        self.count = 0
        self.state = self._init_state(self.packed.data)

    @property
    def learning_rate(self):
        return self._lr

    @learning_rate.setter
    def learning_rate(self, lr):
        self._lr = _f32(lr)

    def _init_state(self, p):
        return {}

    def _updates(self, g, p):
        raise NotImplementedError

    def _scaled(self, u):
        """scale_by_learning_rate (and what optax chains after it)."""
        return u * (-self._lr)

    @torch.no_grad()
    def step(self):
        """One update of the packed parameters from their .grad."""
        g = self.packed.gather_grads()
        p = self.packed.data
        u = self._scaled(self._updates(g, p))
        self.count += 1
        p.add_(u)

    def zero_grad(self):
        for p in self.packed.params:
            p.grad = None


def _check_none(name, value):
    if value is not None:
        raise UnsupportedOptimizerOptionError(
            f"{name}={value!r} is not supported by the PyTorch port "
            f"(float32 state, no mask)")


class Adam(Optimizer):
    name = "Adam"
    accepted = ("learning_rate", "b1", "b2", "eps", "eps_root", "mu_dtype",
                "nesterov")
    _nesterov = False

    def __init__(self, params, learning_rate, b1=0.9, b2=0.999, eps=1e-8,
                 eps_root=0.0, mu_dtype=None, nesterov=None):
        _check_none("mu_dtype", mu_dtype)
        self.b1, self.b2 = _f32(b1), _f32(b2)
        self.eps, self.eps_root = _f32(eps), _f32(eps_root)
        self.nesterov = self._nesterov if nesterov is None else bool(nesterov)
        super().__init__(params, learning_rate)

    def _init_state(self, p):
        return {"mu": torch.zeros_like(p), "nu": torch.zeros_like(p)}

    def _decay_weights(self, u, p):
        return u

    def _updates(self, g, p):
        b1, b2 = self.b1, self.b2
        mu, nu = self.state["mu"], self.state["nu"]
        mu.copy_(_f32(1 - np.float32(b1)) * g + b1 * mu)
        nu.copy_(_f32(1 - np.float32(b2)) * (g * g) + b2 * nu)
        count = self.count + 1
        if self.nesterov:
            mu_hat = (b1 * (mu / _bias_correction(b1, count + 1))
                      + _f32(1 - np.float32(b1))
                      * (g / _bias_correction(b1, count)))
        else:
            mu_hat = mu / _bias_correction(b1, count)
        nu_hat = nu / _bias_correction(b2, count)
        u = mu_hat / (torch.sqrt(nu_hat + self.eps_root) + self.eps)
        return self._decay_weights(u, p)


class Nadam(Adam):
    """optax.nadam: optax.adam with nesterov=True."""

    name = "Nadam"
    _nesterov = True


class AdamW(Adam):
    name = "AdamW"
    accepted = ("learning_rate", "b1", "b2", "eps", "eps_root", "mu_dtype",
                "weight_decay", "mask", "nesterov")

    def __init__(self, params, learning_rate, weight_decay=1e-4, mask=None,
                 **kwargs):
        _check_none("mask", mask)
        self.weight_decay = _f32(weight_decay)
        super().__init__(params, learning_rate, **kwargs)

    def _decay_weights(self, u, p):
        return u + self.weight_decay * p


class SGD(Optimizer):
    name = "SGD"
    accepted = ("learning_rate", "momentum", "nesterov", "accumulator_dtype")

    def __init__(self, params, learning_rate, momentum=None, nesterov=False,
                 accumulator_dtype=None):
        _check_none("accumulator_dtype", accumulator_dtype)
        self.momentum = None if momentum is None else _f32(momentum)
        self.nesterov = bool(nesterov)
        super().__init__(params, learning_rate)

    def _init_state(self, p):
        return {} if self.momentum is None else {"trace": torch.zeros_like(p)}

    def _updates(self, g, p):
        if self.momentum is None:
            return g
        return _trace(g, self.state["trace"], self.momentum, self.nesterov)


def _trace(u, trace, decay, nesterov):
    """optax.trace: trace = u + decay * trace; the update is the new trace
    (nesterov: u + decay * new trace)."""
    trace.copy_(u + decay * trace)
    return u + decay * trace if nesterov else trace.clone()


class RMSprop(Optimizer):
    name = "RMSprop"
    accepted = ("learning_rate", "decay", "eps", "initial_scale",
                "eps_in_sqrt", "centered", "momentum", "nesterov",
                "bias_correction")

    def __init__(self, params, learning_rate, decay=0.9, eps=1e-8,
                 initial_scale=0.0, eps_in_sqrt=True, centered=False,
                 momentum=None, nesterov=False, bias_correction=False):
        if centered:
            raise UnsupportedOptimizerOptionError(
                "centered RMSprop is not supported by the PyTorch port")
        self.decay, self.eps = _f32(decay), _f32(eps)
        self.initial_scale = _f32(initial_scale)
        self.eps_in_sqrt = bool(eps_in_sqrt)
        self.momentum = None if momentum is None else _f32(momentum)
        self.nesterov = bool(nesterov)
        self.bias_correction = bool(bias_correction)
        super().__init__(params, learning_rate)

    def _init_state(self, p):
        state = {"nu": torch.full_like(p, self.initial_scale)}
        if self.momentum is not None:
            state["trace"] = torch.zeros_like(p)
        return state

    def _updates(self, g, p):
        nu = self.state["nu"]
        d = self.decay
        nu.copy_(_f32(1 - np.float32(d)) * (g * g) + d * nu)
        nu_hat = (nu / _bias_correction(d, self.count + 1)
                  if self.bias_correction else nu)
        if self.eps_in_sqrt:
            scaling = torch.rsqrt(nu_hat + self.eps)
        else:
            scaling = 1.0 / (torch.sqrt(nu_hat) + self.eps)
        return scaling * g

    def _scaled(self, u):
        # optax.rmsprop chains its momentum trace after the learning rate
        u = u * (-self._lr)
        if self.momentum is None:
            return u
        return _trace(u, self.state["trace"], self.momentum, self.nesterov)


class Adagrad(Optimizer):
    name = "Adagrad"
    accepted = ("learning_rate", "initial_accumulator_value", "eps")

    def __init__(self, params, learning_rate, initial_accumulator_value=0.1,
                 eps=1e-7):
        self.initial = _f32(initial_accumulator_value)
        self.eps = _f32(eps)
        super().__init__(params, learning_rate)

    def _init_state(self, p):
        return {"sum_of_squares": torch.full_like(p, self.initial)}

    def _updates(self, g, p):
        sos = self.state["sum_of_squares"]
        sos.copy_(g * g + sos)
        inv = torch.where(sos > 0, torch.rsqrt(sos + self.eps),
                          torch.zeros_like(sos))
        return inv * g


class Adamax(Optimizer):
    name = "Adamax"
    accepted = ("learning_rate", "b1", "b2", "eps")

    def __init__(self, params, learning_rate, b1=0.9, b2=0.999, eps=1e-8):
        self.b1, self.b2, self.eps = _f32(b1), _f32(b2), _f32(eps)
        super().__init__(params, learning_rate)

    def _init_state(self, p):
        return {"mu": torch.zeros_like(p), "nu": torch.zeros_like(p)}

    def _updates(self, g, p):
        mu, nu = self.state["mu"], self.state["nu"]
        mu.copy_(_f32(1 - np.float32(self.b1)) * g + self.b1 * mu)
        nu.copy_(torch.maximum(torch.abs(g) + self.eps, self.b2 * nu))
        mu_hat = mu / _bias_correction(self.b1, self.count + 1)
        return mu_hat / nu


class Lamb(Adam):
    """optax.lamb: scale_by_adam, add_decayed_weights, then each parameter
    tensor's update scaled by ||p|| / ||u|| (1 where either is 0)."""

    name = "Lamb"
    accepted = ("learning_rate", "b1", "b2", "eps", "eps_root",
                "weight_decay", "mask")

    def __init__(self, params, learning_rate, b1=0.9, b2=0.999, eps=1e-6,
                 eps_root=0.0, weight_decay=0.0, mask=None):
        _check_none("mask", mask)
        self.weight_decay = _f32(weight_decay)
        super().__init__(params, learning_rate, b1=b1, b2=b2, eps=eps,
                         eps_root=eps_root)

    def _decay_weights(self, u, p):
        u = u + self.weight_decay * p
        packed = self.packed
        for view, off in zip(packed.param_views, packed.offsets):
            seg = u[off:off + view.numel()]
            p_norm = torch.linalg.vector_norm(view)
            u_norm = torch.linalg.vector_norm(seg)
            ratio = torch.where((p_norm == 0) | (u_norm == 0),
                                torch.ones_like(p_norm), p_norm / u_norm)
            seg.mul_(ratio)
        return u


class Lion(Optimizer):
    name = "Lion"
    accepted = ("learning_rate", "b1", "b2", "mu_dtype", "weight_decay",
                "mask")

    def __init__(self, params, learning_rate, b1=0.9, b2=0.99, mu_dtype=None,
                 weight_decay=1e-3, mask=None):
        _check_none("mu_dtype", mu_dtype)
        _check_none("mask", mask)
        self.b1, self.b2 = _f32(b1), _f32(b2)
        self.weight_decay = _f32(weight_decay)
        super().__init__(params, learning_rate)

    def _init_state(self, p):
        return {"mu": torch.zeros_like(p)}

    def _updates(self, g, p):
        mu = self.state["mu"]
        u = torch.sign(_f32(1 - np.float32(self.b1)) * g + self.b1 * mu)
        mu.copy_(_f32(1 - np.float32(self.b2)) * g + self.b2 * mu)
        return u + self.weight_decay * p


OPTIMIZERS = {cls.name: cls for cls in (Adam, AdamW, Nadam, SGD, RMSprop,
                                        Adagrad, Adamax, Lamb, Lion)}
