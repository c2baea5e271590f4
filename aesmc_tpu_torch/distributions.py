"""The distribution interface the engine consumes, and the distributions.

Counterpart of `aesmc_tpu.distributions`: `Normal`,
`MultivariateNormalDiag`, `MultivariateNormalTriL`, `Independent`,
`Categorical`, `OneHotCategorical`, `Bernoulli`, `Deterministic`,
`Laplace`, `LogNormal`, `TransformedDistribution` and `Uniform`. It does
not wrap `torch.distributions`: the engine needs the optional
`batch_shape_mode` tag (see `state`), and draws that take their noise
from the caller (the engine's `noise.NoiseSource`), so that tests can
replay the reference's draws.

Each distribution names the kind of noise it is drawn from
(`noise_kind`: 'normal', 'uniform', 'gumbel', or None for none) and
`state.sample` draws it:

- a reparameterized distribution (`has_rsample`) maps its noise ``eps``
  of shape ``sample_shape + batch_shape + event_shape`` to a sample with
  `rsample(sample_shape, eps)`: standard normals for the normal family,
  uniforms in [0, 1) for `Laplace` (inverse CDF) and `Uniform`;
- the others are drawn detached with `sample(sample_shape, noise)`, from
  noise of `noise_shape(sample_shape)`: Gumbel noise ``sample_shape +
  batch_shape + (D,)`` for the categoricals (the shape in which
  `jax.random.categorical` draws it), uniforms for `Bernoulli` (as
  `jax.random.bernoulli` draws them).

Parameters are tensors or Python numbers; a number becomes a fill on the
device of the tensor it meets (a copy from the host would wait for the
card and could not be captured in a CUDA graph).

Shapes follow the torch/tfp convention:
    rsample(sample_shape)  -> sample_shape + batch_shape + event_shape
    log_prob(value)        -> broadcast(value batch dims, batch_shape)
"""

from __future__ import annotations

import math as _stdmath
from typing import Tuple

import torch
import torch.nn.functional as F

_HALF_LOG_2PI = 0.5 * _stdmath.log(2.0 * _stdmath.pi)


def _shape(x) -> Tuple[int, ...]:
    return tuple(x.shape) if isinstance(x, torch.Tensor) else ()


def _like(x, like: torch.Tensor) -> torch.Tensor:
    """``x`` (a tensor or a Python number) as a tensor of ``like``'s dtype
    on its device; a number becomes a fill there."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype=like.dtype, device=like.device)
    return torch.full((), x, dtype=like.dtype, device=like.device)


def cholesky(covariance: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of ``covariance`` `[..., D, D]`, with the JAX
    package's answer where a matrix is not positive definite: NaN on and
    below the diagonal, zeros above (what `jnp.linalg.cholesky` returns).
    `torch.linalg.cholesky` would raise there instead, and it reads its
    error flag on the host, a wait for the card that a CUDA graph capture
    refuses; `cholesky_ex` leaves the flag on the device."""
    tril, info = torch.linalg.cholesky_ex(covariance)
    failed = (info > 0)[..., None, None]
    return torch.where(failed, torch.full_like(tril, float("nan")).tril(),
                       tril)


def cho_solve(chol: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """``A^{-1} rhs`` for ``A = chol chol^T``, ``chol`` `[..., n, n]` lower
    and ``rhs`` `[..., n, m]` (`jax.scipy.linalg.cho_solve`): two
    triangular solves, cuBLAS' trsm on the card, which a CUDA graph
    captures. `torch.cholesky_solve` is not used: captured on an H100, it
    aborts the process in MAGMA."""
    half = torch.linalg.solve_triangular(chol, rhs, upper=False)
    return torch.linalg.solve_triangular(chol.transpose(-1, -2), half,
                                         upper=True)


def _float(x) -> torch.Tensor:
    """A tensor or a Python number as a floating-point tensor (a number as
    a 0-d float32 tensor on the CPU, to be broadcast)."""
    if isinstance(x, torch.Tensor):
        return x if x.is_floating_point() else x.to(torch.float32)
    return torch.tensor(float(x))


class Distribution:
    """Interface: `batch_shape`, `event_shape`, `rsample` or `sample`,
    `log_prob`.

    `batch_shape_mode` is an optional `state.BatchShapeMode` tag read by
    `state.sample` and `state.get_batch_shape_mode`.
    """

    batch_shape_mode = None
    # Whether `rsample` exists; `state.sample` draws the others detached.
    has_rsample = True
    # The kind of noise a draw takes from the `NoiseSource`.
    noise_kind = "normal"

    @property
    def batch_shape(self) -> Tuple[int, ...]:
        raise NotImplementedError

    @property
    def event_shape(self) -> Tuple[int, ...]:
        return ()

    def noise_shape(self, sample_shape) -> Tuple[int, ...]:
        """The shape of the noise one draw of ``sample_shape`` takes."""
        return tuple(sample_shape) + self.batch_shape + self.event_shape

    def _check_noise(self, noise, sample_shape, name):
        shape = self.noise_shape(sample_shape)
        if tuple(noise.shape) != shape:
            raise ValueError(f"{type(self).__name__}: {name} has shape "
                             f"{tuple(noise.shape)}, expected {shape}")

    def rsample(self, sample_shape, eps: torch.Tensor):
        raise ValueError(f"{type(self).__name__} is not reparameterizable")

    def sample(self, sample_shape, noise: torch.Tensor):
        """A draw of a distribution that is not reparameterized, from
        noise of `noise_shape(sample_shape)`."""
        raise NotImplementedError

    def log_prob(self, value):
        raise NotImplementedError


class Normal(Distribution):
    """Univariate normal, elementwise over broadcast(loc, scale)."""

    def __init__(self, loc, scale, batch_shape_mode=None):
        self.loc = loc
        self.scale = scale
        self.batch_shape_mode = batch_shape_mode

    @property
    def batch_shape(self):
        return tuple(torch.broadcast_shapes(_shape(self.loc),
                                            _shape(self.scale)))

    def rsample(self, sample_shape, eps):
        """``loc + scale * eps`` for standard-normal noise ``eps`` of shape
        ``sample_shape + batch_shape`` (see `state.sample`)."""
        self._check_noise(eps, sample_shape, "eps")
        return _like(self.loc, eps) + _like(self.scale, eps) * eps

    def log_prob(self, value):
        loc = _like(self.loc, value)
        scale = _like(self.scale, value)
        z = (value - loc) / scale
        return -0.5 * z * z - torch.log(scale) - _HALF_LOG_2PI

    @property
    def mean(self):
        return _float(self.loc).expand(self.batch_shape)

    @property
    def stddev(self):
        return _float(self.scale).expand(self.batch_shape)

    @property
    def variance(self):
        return self.stddev ** 2


class MultivariateNormalDiag(Distribution):
    """Multivariate normal with diagonal covariance; event_shape = (D,)."""

    def __init__(self, loc, scale_diag, batch_shape_mode=None):
        self.loc = loc
        self.scale_diag = scale_diag
        self.batch_shape_mode = batch_shape_mode

    @property
    def _param_shape(self):
        return tuple(torch.broadcast_shapes(_shape(self.loc),
                                            _shape(self.scale_diag)))

    @property
    def batch_shape(self):
        return self._param_shape[:-1]

    @property
    def event_shape(self):
        return self._param_shape[-1:]

    def rsample(self, sample_shape, eps):
        self._check_noise(eps, sample_shape, "eps")
        return _like(self.loc, eps) + _like(self.scale_diag, eps) * eps

    def log_prob(self, value):
        loc = _like(self.loc, value)
        scale = _like(self.scale_diag, value)
        z = (value - loc) / scale
        return torch.sum(-0.5 * z * z - torch.log(scale) - _HALF_LOG_2PI,
                         dim=-1)

    @property
    def mean(self):
        return _float(self.loc).expand(self._param_shape)


class MultivariateNormalTriL(Distribution):
    """Full-covariance multivariate normal, parameterized by the lower
    Cholesky factor ``scale_tril`` `[..., D, D]` of the covariance;
    event_shape = (D,). Reparameterized: x = loc + L eps."""

    def __init__(self, loc, scale_tril, batch_shape_mode=None):
        self.loc = loc
        self.scale_tril = scale_tril
        self.batch_shape_mode = batch_shape_mode

    @classmethod
    def from_covariance(cls, loc, covariance, **kwargs):
        cov = _float(covariance)
        cov = 0.5 * (cov + cov.transpose(-1, -2))
        return cls(loc, cholesky(cov), **kwargs)

    @property
    def batch_shape(self):
        return tuple(torch.broadcast_shapes(_shape(self.loc)[:-1],
                                            _shape(self.scale_tril)[:-2]))

    @property
    def event_shape(self):
        return _shape(self.scale_tril)[-1:]

    def rsample(self, sample_shape, eps):
        self._check_noise(eps, sample_shape, "eps")
        tril = _like(self.scale_tril, eps)
        if tril.ndim == 2:
            # One factor for every batch entry: one matmul.
            return _like(self.loc, eps) + eps @ tril.T
        shape = tuple(eps.shape)
        return _like(self.loc, eps) + torch.einsum(
            "...ij,...j->...i", tril.expand(shape + self.event_shape), eps)

    def log_prob(self, value):
        loc = _like(self.loc, value)
        tril = _like(self.scale_tril, value)
        diff = value - loc
        d = diff.shape[-1]
        if tril.ndim == 2:
            # One factor: one triangular solve with every entry a column.
            z = torch.linalg.solve_triangular(
                tril, diff.reshape(-1, d).T, upper=False).T.reshape(
                    diff.shape)
        else:
            batch = torch.broadcast_shapes(tuple(diff.shape[:-1]),
                                           tuple(tril.shape[:-2]))
            diff = diff.expand(tuple(batch) + (d,))
            tril = tril.expand(tuple(batch) + (d, d))
            z = torch.linalg.solve_triangular(tril, diff.unsqueeze(-1),
                                              upper=False).squeeze(-1)
        half_logdet = torch.log(torch.diagonal(tril, dim1=-2,
                                               dim2=-1)).sum(dim=-1)
        return -0.5 * (z * z).sum(dim=-1) - half_logdet - d * _HALF_LOG_2PI

    @property
    def mean(self):
        return _float(self.loc).expand(self.batch_shape + self.event_shape)

    @property
    def covariance(self):
        tril = _float(self.scale_tril)
        return tril @ tril.transpose(-1, -2)


class Independent(Distribution):
    """Reinterprets the rightmost ``reinterpreted_batch_ndims`` batch dims
    of ``base`` as event dims; draws as ``base`` does."""

    def __init__(self, base, reinterpreted_batch_ndims: int,
                 batch_shape_mode=None):
        self.base = base
        self.reinterpreted_batch_ndims = reinterpreted_batch_ndims
        self.batch_shape_mode = batch_shape_mode

    @property
    def has_rsample(self):
        return self.base.has_rsample

    @property
    def noise_kind(self):
        return self.base.noise_kind

    @property
    def batch_shape(self):
        n = self.reinterpreted_batch_ndims
        return self.base.batch_shape[:len(self.base.batch_shape) - n]

    @property
    def event_shape(self):
        cut = len(self.base.batch_shape) - self.reinterpreted_batch_ndims
        return self.base.batch_shape[cut:] + self.base.event_shape

    def noise_shape(self, sample_shape):
        return self.base.noise_shape(sample_shape)

    def rsample(self, sample_shape, eps):
        return self.base.rsample(sample_shape, eps)

    def sample(self, sample_shape, noise):
        return self.base.sample(sample_shape, noise)

    def log_prob(self, value):
        logp = self.base.log_prob(value)
        n = self.reinterpreted_batch_ndims
        if n == 0:
            return logp
        return logp.sum(dim=tuple(range(-n, 0)))


class Categorical(Distribution):
    """Categorical over the last axis of ``logits``; not reparameterizable.

    ``logits`` is a float tensor `[..., D]`; `batch_shape` is its shape
    without the last axis.
    """

    has_rsample = False
    noise_kind = "gumbel"

    def __init__(self, logits, batch_shape_mode=None):
        self.logits = logits
        self.batch_shape_mode = batch_shape_mode

    @classmethod
    def from_probs(cls, probs, **kwargs):
        return cls(logits=torch.log(torch.as_tensor(probs)), **kwargs)

    @property
    def batch_shape(self):
        return tuple(self.logits.shape[:-1])

    @property
    def num_categories(self) -> int:
        return self.logits.shape[-1]

    def noise_shape(self, sample_shape):
        return (tuple(sample_shape) + self.batch_shape +
                (self.num_categories,))

    def sample(self, sample_shape, gumbel):
        """``argmax(logits + gumbel, -1)`` as int32 (the first maximum on a
        tie, as `jnp.argmax`), for standard Gumbel noise ``gumbel`` of shape
        ``sample_shape + batch_shape + (D,)``: the shape in which
        `jax.random.categorical` draws it."""
        self._check_noise(gumbel, sample_shape, "gumbel")
        logits = self.logits.to(gumbel.dtype)
        return torch.argmax(gumbel + logits, dim=-1).to(torch.int32)

    def log_prob(self, value):
        """Log-probability of integer categories ``value``, broadcast both
        ways against the batch shape. A negative value wraps once (``value
        + D``); a value still outside [0, D) scores NaN, as the JAX
        package's gather route does."""
        log_probs = torch.log_softmax(self.logits, dim=-1)
        value = torch.as_tensor(value, device=log_probs.device).long()
        batch = torch.broadcast_shapes(tuple(value.shape),
                                       tuple(log_probs.shape[:-1]))
        log_probs = log_probs.expand(batch + tuple(log_probs.shape[-1:]))
        value = value.expand(batch)
        d = log_probs.shape[-1]
        value = torch.where(value < 0, value + d, value)
        outside = (value < 0) | (value >= d)
        out = torch.gather(log_probs, -1,
                           value.clamp(0, d - 1).unsqueeze(-1)).squeeze(-1)
        return torch.where(outside, torch.full_like(out, float("nan")), out)


class OneHotCategorical(Categorical):
    """One-hot categorical; event_shape = (num_categories,). Drawn as
    `Categorical` is (the same Gumbel noise), then one-hot in float32."""

    @property
    def event_shape(self):
        return (self.num_categories,)

    def sample(self, sample_shape, gumbel):
        idx = super().sample(sample_shape, gumbel)
        return F.one_hot(idx.long(), self.num_categories).to(torch.float32)

    def log_prob(self, value):
        log_probs = torch.log_softmax(self.logits, dim=-1)
        return torch.sum(value * log_probs, dim=-1)


class Bernoulli(Distribution):
    """Bernoulli over {0, 1} parameterized by logits; not
    reparameterizable. A draw is ``u < sigmoid(logits)`` in float32 for a
    uniform ``u`` of shape ``sample_shape + batch_shape``."""

    has_rsample = False
    noise_kind = "uniform"

    def __init__(self, logits, batch_shape_mode=None):
        self.logits = logits
        self.batch_shape_mode = batch_shape_mode

    @classmethod
    def from_probs(cls, probs, **kwargs):
        probs = _float(probs)
        return cls(logits=torch.log(probs) - torch.log1p(-probs), **kwargs)

    @property
    def batch_shape(self):
        return _shape(self.logits)

    def sample(self, sample_shape, u):
        self._check_noise(u, sample_shape, "u")
        p = torch.sigmoid(_like(self.logits, u))
        return (u < p).to(torch.float32)

    def log_prob(self, value):
        logits = _float(self.logits)
        return (value * F.logsigmoid(logits) +
                (1.0 - value) * F.logsigmoid(-logits))

    @property
    def mean(self):
        return torch.sigmoid(_float(self.logits))


class Deterministic(Distribution):
    """A point mass: a draw is ``loc``, and `log_prob` is 0.

    Carries deterministic state (a recurrent hidden vector) through an SMC
    latent: transition and proposal emit the same point mass, which adds
    nothing to the weights while it rides the resampling. `rsample` is
    the identity in ``loc``, so gradients flow through it; it takes no
    noise.
    """

    noise_kind = None

    def __init__(self, loc, event_ndims: int = 0, batch_shape_mode=None):
        self.loc = loc
        self.event_ndims = event_ndims
        self.batch_shape_mode = batch_shape_mode

    @property
    def batch_shape(self):
        shape = _shape(self.loc)
        return shape[:len(shape) - self.event_ndims]

    @property
    def event_shape(self):
        shape = _shape(self.loc)
        return shape[len(shape) - self.event_ndims:]

    def rsample(self, sample_shape, eps=None):
        loc = _float(self.loc)
        return loc.expand(tuple(sample_shape) + tuple(loc.shape))

    def log_prob(self, value):
        n = self.event_ndims
        shape = value.shape[:value.ndim - n] if n else value.shape
        dtype = (value.dtype if value.is_floating_point()
                 else torch.float32)
        return torch.zeros(shape, dtype=dtype, device=value.device)


class Laplace(Distribution):
    """Laplace(loc, scale); reparameterized by the inverse CDF of a
    uniform: ``u' = u - 1/2``, ``x = loc - scale sign(u') log1p(-2|u'|)``
    for ``u`` uniform in [0, 1)."""

    noise_kind = "uniform"

    def __init__(self, loc, scale, batch_shape_mode=None):
        self.loc = loc
        self.scale = scale
        self.batch_shape_mode = batch_shape_mode

    @property
    def batch_shape(self):
        return tuple(torch.broadcast_shapes(_shape(self.loc),
                                            _shape(self.scale)))

    def rsample(self, sample_shape, u):
        self._check_noise(u, sample_shape, "u")
        # As jax.random.uniform(minval=-0.5, maxval=0.5) forms it (exact).
        centered = u - 0.5
        eps = -torch.sign(centered) * torch.log1p(-2.0 * centered.abs())
        return _like(self.loc, u) + _like(self.scale, u) * eps

    def log_prob(self, value):
        loc = _like(self.loc, value)
        scale = _like(self.scale, value)
        return -(value - loc).abs() / scale - torch.log(2.0 * scale)

    @property
    def mean(self):
        return _float(self.loc).expand(self.batch_shape)


class LogNormal(Distribution):
    """exp(N(loc, scale^2)); reparameterized."""

    def __init__(self, loc, scale, batch_shape_mode=None):
        self.loc = loc
        self.scale = scale
        self.batch_shape_mode = batch_shape_mode

    @property
    def batch_shape(self):
        return tuple(torch.broadcast_shapes(_shape(self.loc),
                                            _shape(self.scale)))

    def rsample(self, sample_shape, eps):
        self._check_noise(eps, sample_shape, "eps")
        return torch.exp(_like(self.loc, eps) + _like(self.scale, eps) * eps)

    def log_prob(self, value):
        loc = _like(self.loc, value)
        scale = _like(self.scale, value)
        logv = torch.log(value)
        z = (logv - loc) / scale
        return -0.5 * z * z - torch.log(scale) - _HALF_LOG_2PI - logv

    @property
    def mean(self):
        return torch.exp(_float(self.loc) + 0.5 * _float(self.scale) ** 2)


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


class TransformedDistribution(Distribution):
    """Pushforward of ``base`` through an elementwise bijector, one of
    'exp', 'sigmoid', 'tanh' and 'softplus'; draws as ``base`` does."""

    _FORWARD = {
        "exp": torch.exp,
        "sigmoid": torch.sigmoid,
        "tanh": torch.tanh,
        "softplus": _softplus,
    }
    _INVERSE = {
        "exp": torch.log,
        "sigmoid": lambda y: torch.log(y) - torch.log1p(-y),
        "tanh": torch.atanh,
        "softplus": lambda y: torch.log(-torch.expm1(-y)) + y,
    }
    # log |d forward(x) / dx| at x.
    _FLDJ = {
        "exp": lambda x: x,
        "sigmoid": lambda x: -_softplus(-x) - _softplus(x),
        "tanh": lambda x: 2.0 * (_stdmath.log(2.0) - x - _softplus(-2.0 * x)),
        "softplus": lambda x: -_softplus(-x),
    }

    def __init__(self, base, bijector: str, batch_shape_mode=None):
        if bijector not in self._FORWARD:
            raise ValueError(f"bijector must be one of "
                             f"{tuple(self._FORWARD)}. currently = "
                             f"{bijector}")
        self.base = base
        self.bijector = bijector
        self.batch_shape_mode = batch_shape_mode

    @property
    def has_rsample(self):
        return self.base.has_rsample

    @property
    def noise_kind(self):
        return self.base.noise_kind

    @property
    def batch_shape(self):
        return self.base.batch_shape

    @property
    def event_shape(self):
        return self.base.event_shape

    def noise_shape(self, sample_shape):
        return self.base.noise_shape(sample_shape)

    def rsample(self, sample_shape, eps):
        return self._FORWARD[self.bijector](
            self.base.rsample(sample_shape, eps))

    def sample(self, sample_shape, noise):
        return self._FORWARD[self.bijector](
            self.base.sample(sample_shape, noise))

    def log_prob(self, value):
        x = self._INVERSE[self.bijector](value)
        return self.base.log_prob(x) - self._FLDJ[self.bijector](x)


class Uniform(Distribution):
    """Uniform on [low, high); reparameterized: ``low + (high - low) u``
    for ``u`` uniform in [0, 1)."""

    noise_kind = "uniform"

    def __init__(self, low, high, batch_shape_mode=None):
        self.low = low
        self.high = high
        self.batch_shape_mode = batch_shape_mode

    @property
    def batch_shape(self):
        return tuple(torch.broadcast_shapes(_shape(self.low),
                                            _shape(self.high)))

    def rsample(self, sample_shape, u):
        self._check_noise(u, sample_shape, "u")
        low = _like(self.low, u)
        return low + (_like(self.high, u) - low) * u

    def log_prob(self, value):
        low = _like(self.low, value)
        high = _like(self.high, value)
        inside = (value >= low) & (value < high)
        return torch.where(inside, -torch.log(high - low),
                           torch.full_like(value, -float("inf")))
