"""Distribution nodes: priors for NUTS/HMC-updated free RVs and observation
likelihoods (PyTorch).

Counterpart of ``pymc_bart_tpu/models/distributions.py``.  Each family
provides ``logp(value, *params)`` (broadcasting, differentiable),
``random(gen, shape, *params)`` for prior / posterior-predictive draws from
a ``torch.Generator``, and ``support_point``; free RVs carry a bijective
transform to unconstrained space.  Parameters may be tensors or Python
scalars.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

_LOG_2PI = 1.8378770664093453
_HALF_LOG_2_OVER_PI = -0.22579135264472741  # log(sqrt(2/pi))
_NEG_INF = float("-inf")


def _t(x, like=None):
    """Tensor view of a parameter (Python scalars become 0-d float32)."""
    if isinstance(x, torch.Tensor):
        return x
    dev = like.device if isinstance(like, torch.Tensor) else None
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def _gen_device(gen: torch.Generator):
    return gen.device


def _randn(gen, shape):
    return torch.randn(tuple(shape), generator=gen, device=_gen_device(gen))


def _rand(gen, shape):
    return torch.rand(tuple(shape), generator=gen, device=_gen_device(gen))


def _gamma(gen, shape, alpha):
    a = torch.broadcast_to(_t(alpha).to(_gen_device(gen)),
                           tuple(shape)).contiguous()
    return torch._standard_gamma(a, generator=gen)


# ---------------------------------------------------------------------------
# transforms (unconstrained <-> constrained), with log|Jacobian|
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Transform:
    name: str

    def forward(self, u):  # unconstrained -> constrained
        raise NotImplementedError

    def log_jac(self, u):  # log|d constrained / d u|
        raise NotImplementedError

    def inverse(self, x):  # constrained -> unconstrained
        raise NotImplementedError


class IdentityTransform(Transform):
    def __init__(self):
        super().__init__("identity")

    def forward(self, u):
        return u

    def log_jac(self, u):
        return torch.zeros_like(u)

    def inverse(self, x):
        return x


class LogTransform(Transform):
    """positive support: x = exp(u)."""

    def __init__(self):
        super().__init__("log")

    def forward(self, u):
        return torch.exp(u)

    def log_jac(self, u):
        return u

    def inverse(self, x):
        return torch.log(x)


class IntervalTransform(Transform):
    """bounded support (a, b): x = a + (b-a)*sigmoid(u)."""

    def __init__(self, lower, upper):
        super().__init__("interval")
        object.__setattr__(self, "lower", float(lower))
        object.__setattr__(self, "upper", float(upper))

    def forward(self, u):
        return self.lower + (self.upper - self.lower) * torch.sigmoid(u)

    def log_jac(self, u):
        return (math.log(self.upper - self.lower)
                + F.logsigmoid(u) + F.logsigmoid(-u))

    def inverse(self, x):
        z = (x - self.lower) / (self.upper - self.lower)
        z = torch.clamp(z, 1e-6, 1 - 1e-6)
        return torch.log(z) - torch.log1p(-z)


IDENTITY = IdentityTransform()
LOG = LogTransform()


# ---------------------------------------------------------------------------
# distribution families
# ---------------------------------------------------------------------------


class Dist:
    """Static family descriptor; subclasses define logp/random/etc."""

    transform: Transform = IDENTITY
    discrete = False

    @staticmethod
    def logp(value, *params):
        raise NotImplementedError

    @staticmethod
    def random(gen, shape, *params):
        raise NotImplementedError

    @staticmethod
    def support_point(shape, *params):
        raise NotImplementedError


def _bcast(x, shape):
    return torch.broadcast_to(_t(x), tuple(shape))


class NormalDist(Dist):
    @staticmethod
    def logp(value, mu, sigma):
        sigma = _t(sigma, value).clamp_min(1e-12)
        return (-0.5 * ((value - mu) / sigma) ** 2 - torch.log(sigma)
                - 0.5 * _LOG_2PI)

    @staticmethod
    def random(gen, shape, mu, sigma):
        return mu + sigma * _randn(gen, shape)

    @staticmethod
    def support_point(shape, mu, sigma):
        return _bcast(mu, shape)


class HalfNormalDist(Dist):
    transform = LOG

    @staticmethod
    def logp(value, sigma):
        sigma = _t(sigma, value).clamp_min(1e-12)
        lp = (_HALF_LOG_2_OVER_PI - torch.log(sigma)
              - 0.5 * (value / sigma) ** 2)
        return torch.where(value >= 0, lp, _NEG_INF)

    @staticmethod
    def random(gen, shape, sigma):
        return torch.abs(sigma * _randn(gen, shape))

    @staticmethod
    def support_point(shape, sigma):
        return _bcast(_t(sigma) * 0.8, shape)


class ExponentialDist(Dist):
    transform = LOG

    @staticmethod
    def logp(value, lam):
        lam = _t(lam, value).clamp_min(1e-12)
        return torch.where(value >= 0, torch.log(lam) - lam * value, _NEG_INF)

    @staticmethod
    def random(gen, shape, lam):
        return -torch.log1p(-_rand(gen, shape)) / lam

    @staticmethod
    def support_point(shape, lam):
        return _bcast(1.0 / _t(lam), shape)


class GammaDist(Dist):
    transform = LOG

    @staticmethod
    def logp(value, alpha, beta):
        alpha, beta = _t(alpha, value), _t(beta, value)
        lp = (alpha * torch.log(beta) - torch.lgamma(alpha)
              + (alpha - 1.0) * torch.log(value.clamp_min(1e-38))
              - beta * value)
        return torch.where(value > 0, lp, _NEG_INF)

    @staticmethod
    def random(gen, shape, alpha, beta):
        return _gamma(gen, shape, alpha) / beta

    @staticmethod
    def support_point(shape, alpha, beta):
        return _bcast(_t(alpha) / _t(beta), shape)


class LogNormalDist(Dist):
    transform = LOG

    @staticmethod
    def logp(value, mu, sigma):
        sigma = _t(sigma, value).clamp_min(1e-12)
        logv = torch.log(value.clamp_min(1e-38))
        lp = (-0.5 * ((logv - mu) / sigma) ** 2 - logv - torch.log(sigma)
              - 0.5 * _LOG_2PI)
        return torch.where(value > 0, lp, _NEG_INF)

    @staticmethod
    def random(gen, shape, mu, sigma):
        return torch.exp(mu + sigma * _randn(gen, shape))

    @staticmethod
    def support_point(shape, mu, sigma):
        return _bcast(torch.exp(_t(mu) + 0.5 * _t(sigma) ** 2), shape)


class UniformDist(Dist):
    @staticmethod
    def logp(value, lower, upper):
        lower, upper = _t(lower, value), _t(upper, value)
        inside = (value >= lower) & (value <= upper)
        return torch.where(inside, -torch.log(upper - lower), _NEG_INF)

    @staticmethod
    def random(gen, shape, lower, upper):
        return lower + (upper - lower) * _rand(gen, shape)

    @staticmethod
    def support_point(shape, lower, upper):
        return _bcast((_t(lower) + _t(upper)) / 2.0, shape)


class StudentTDist(Dist):
    @staticmethod
    def logp(value, nu, mu, sigma):
        nu = _t(nu, value)
        sigma = _t(sigma, value).clamp_min(1e-12)
        z = (value - mu) / sigma
        return (torch.lgamma((nu + 1) / 2) - torch.lgamma(nu / 2)
                - 0.5 * torch.log(nu * math.pi) - torch.log(sigma)
                - (nu + 1) / 2 * torch.log1p(z**2 / nu))

    @staticmethod
    def random(gen, shape, nu, mu, sigma):
        nu = _t(nu)
        chi2 = 2.0 * _gamma(gen, shape, nu / 2.0)
        return mu + sigma * _randn(gen, shape) / torch.sqrt(
            chi2 / nu.to(chi2.device))

    @staticmethod
    def support_point(shape, nu, mu, sigma):
        return _bcast(mu, shape)


class BernoulliDist(Dist):
    discrete = True

    @staticmethod
    def logp(value, p):
        p = torch.clamp(_t(p, value), 1e-7, 1 - 1e-7)
        return value * torch.log(p) + (1 - value) * torch.log1p(-p)

    @staticmethod
    def random(gen, shape, p):
        return (_rand(gen, shape) < p).to(torch.float32)

    @staticmethod
    def support_point(shape, p):
        return _bcast((_t(p) > 0.5).to(torch.float32), shape)


class PoissonDist(Dist):
    discrete = True

    @staticmethod
    def logp(value, mu):
        mu = _t(mu, value).clamp_min(1e-12)
        return value * torch.log(mu) - mu - torch.lgamma(value + 1.0)

    @staticmethod
    def random(gen, shape, mu):
        rate = torch.broadcast_to(_t(mu).to(_gen_device(gen)),
                                  tuple(shape)).contiguous()
        return torch.poisson(rate, generator=gen)

    @staticmethod
    def support_point(shape, mu):
        return _bcast(torch.floor(_t(mu)), shape)


class NegativeBinomialDist(Dist):
    """PyMC (mu, alpha) parameterization."""

    discrete = True

    @staticmethod
    def logp(value, mu, alpha):
        mu = _t(mu, value).clamp_min(1e-12)
        alpha = _t(alpha, value).clamp_min(1e-12)
        return (torch.lgamma(value + alpha) - torch.lgamma(alpha)
                - torch.lgamma(value + 1.0)
                + alpha * (torch.log(alpha) - torch.log(alpha + mu))
                + value * (torch.log(mu) - torch.log(alpha + mu)))

    @staticmethod
    def random(gen, shape, mu, alpha):
        lam = _gamma(gen, shape, alpha) * (_t(mu) / _t(alpha)).to(
            _gen_device(gen))
        return torch.poisson(lam, generator=gen)

    @staticmethod
    def support_point(shape, mu, alpha):
        return _bcast(torch.floor(_t(mu)), shape)


class CategoricalDist(Dist):
    """p has categories on the LAST axis; value holds integer labels."""

    discrete = True

    @staticmethod
    def logp(value, p):
        p = torch.clamp(p, 1e-12, 1.0)
        logp_all = torch.log(p / p.sum(dim=-1, keepdim=True))
        v = value.to(torch.int64)
        return torch.gather(logp_all, -1, v.unsqueeze(-1)).squeeze(-1)

    @staticmethod
    def random(gen, shape, p):
        flat = torch.clamp(p, 1e-12, 1.0).reshape(-1, p.shape[-1])
        draw = torch.multinomial(flat, 1, generator=gen)
        return draw.reshape(p.shape[:-1]).to(torch.float32)

    @staticmethod
    def support_point(shape, p):
        return _bcast(torch.argmax(p, dim=-1).to(torch.float32), shape)


# registry keyed by user-facing class name
FAMILIES = {
    "Normal": NormalDist,
    "HalfNormal": HalfNormalDist,
    "Exponential": ExponentialDist,
    "Gamma": GammaDist,
    "LogNormal": LogNormalDist,
    "Uniform": UniformDist,
    "StudentT": StudentTDist,
    "Bernoulli": BernoulliDist,
    "Poisson": PoissonDist,
    "NegativeBinomial": NegativeBinomialDist,
    "Categorical": CategoricalDist,
}
