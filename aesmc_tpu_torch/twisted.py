"""Twisted (controlled) sequential Monte Carlo.

Counterpart of `aesmc_tpu.twisted`. SMC runs on a *twisted* model: each
step's target is reweighted by a positive twisting function psi_t(x_t),
and the proposal absorbs the twist, so that the incremental weights become
``g_t(y_t | x_t) * psitilde_{t+1}(x_t) / psi_t(x_t)`` (times ``mu(psi_0)``
at t = 0), with ``psitilde_t(x) = int f(x' | x) psi_t(x') dx'``. At the
optimal twist ``psi_t(x) = p(y_{t:T-1} | x_t)`` every particle carries the
same weight and the evidence estimate is exact (Guarniero, Johansen & Lee
2017; Heng, Bishop, Deligiannidis & Doucet 2020).

Twists are log-quadratic and diagonal (`QuadraticTwist`) for transitions
``x_t ~ N(mean_fn(x_{t-1}, t), diag(scale^2))`` with any mean function
(`GaussianSSMSpec`), so the twisted kernels stay Gaussian with closed-form
moments: elementwise math, no per-particle solve. On a finite state space
(`DiscreteSSMSpec`, the HMM family) the twist is a table (`TabularTwist`)
and every integral is an exact log-matrix-vector product.

The twisted model is four ordinary engine components handed to
`inference.infer`, so every resampling method and route (K1 on the card,
K1's indices and K5 for the HMM's int32 particles), the ESS-adaptive
criteria and every return option come along unchanged. The twisted
transition and proposal are the same distribution, so their log-densities
cancel exactly in the weight, and the emission (`LogCorrectedDistribution`)
carries ``log g + log psitilde_{t+1} - log psi_t``.

Time: the engine's eager loop passes the int 0 and then
`inference.TimeIndex` ints, and the components take the static final-step
branch for those. Under the streaming filter the time is an
`inference.DeviceTimeIndex`: tables are indexed with its tensor
(`index_select`, no read of the device), and the next step's time is
clamped to T - 1 as the JAX package clamps a traced time.

Also here: `exact_lgssm_twist` and `exact_hmm_twist` (the optimal twists by
the backward recursions), and `learn_twist` (iterated approximate dynamic
programming: run the twisted filter, regress ``log g_t + log
psitilde_{t+1}`` on quadratic features of the particles backward in time,
repeat). The regressions are one batched solve of the `[B, F, F]` Gram
matrices a step (`torch.linalg.solve_ex`, whose error flag stays on the
device). `learn_twist` runs under `torch.no_grad`.

Several ranks: `twisted_smc(mesh=...)` runs `infer(mesh=...)` on this
rank's rows, with the twist's `[T, batch, ...]` tables cut to them.
`learn_twist(mesh=...)` runs its twisted runs so, refits this rank's rows
on their particles gathered over the particle group, and gathers the
twists and scores over the data group.

Draws: the twisted run draws as `infer` does; the refit's design points
(``fit_jitter > 0``) draw, for t = T-1 down to 0, `[B, K, K]` Gumbel noise
(one `jax.random.categorical(k, lw_t, shape=(K,))` a row) and then the
jitter's normals.
"""

from __future__ import annotations

import dataclasses
import math as _stdmath
from typing import Any, Callable, Optional

import torch

from . import device as _device
from . import distributions as dists
from . import inference as _inference
from . import math as amath
from . import state
from .distributions import _like
from .inference import DeviceTimeIndex, TimeIndex
from .noise import NoiseSource
from .state import BatchShapeMode

__all__ = [
    "QuadraticTwist",
    "TabularTwist",
    "GaussianSSMSpec",
    "DiscreteSSMSpec",
    "LogCorrectedDistribution",
    "make_twisted_components",
    "make_discrete_twisted_components",
    "twisted_smc",
    "exact_lgssm_twist",
    "exact_hmm_twist",
    "learn_twist",
]


def _float_dtype(x):
    return x.dtype if x.is_floating_point() else torch.float32


@dataclasses.dataclass
class QuadraticTwist:
    """log psi_t(x) = sum_d [-A[t, ..., d] / 2 x_d^2 + b[t, ..., d] x_d] +
    c[t].

    Shapes: scalar latents `A, b, c: [T, batch]`; vector latents `A, b:
    [T, batch, D]`, `c: [T, batch]` (`batch` may be 1 and broadcasts).
    ``A >= 0`` keeps the twisted Gaussian kernels proper for any transition
    variance; the learners clamp at 0.
    """

    A: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor

    @classmethod
    def zeros(cls, num_timesteps: int, batch_size: int,
              dim: Optional[int] = None, dtype=torch.float32, device=None):
        """The zero twist (the bootstrap filter), on ``device`` (default:
        the card; raises without one)."""
        device = _device.resolve(device)
        shape = ((num_timesteps, batch_size) if dim is None
                 else (num_timesteps, batch_size, dim))
        return cls(A=torch.zeros(shape, dtype=dtype, device=device),
                   b=torch.zeros(shape, dtype=dtype, device=device),
                   c=torch.zeros((num_timesteps, batch_size), dtype=dtype,
                                 device=device))

    @property
    def vector(self) -> bool:
        return self.A.ndim == 3


@dataclasses.dataclass
class TabularTwist:
    """A twist over a finite state space: ``log psi_t(x = d)`` as a table
    `logpsi` `[T, batch, D]` (`batch` may be 1 and broadcasts)."""

    logpsi: torch.Tensor

    @classmethod
    def zeros(cls, num_timesteps: int, batch_size: int, num_states: int,
              dtype=torch.float32, device=None):
        device = _device.resolve(device)
        return cls(logpsi=torch.zeros(
            (num_timesteps, batch_size, num_states), dtype=dtype,
            device=device))

    @property
    def num_states(self) -> int:
        return self.logpsi.shape[-1]


@dataclasses.dataclass
class DiscreteSSMSpec:
    """The HMM family's structure: `initial_logits` `[D]` and
    `transition_logits` `[D, D]` (rows log-softmax-normalized here), as
    `models.hmm.Initial`/`Transition` hold them. The emission is any."""

    initial_logits: torch.Tensor
    transition_logits: torch.Tensor


@dataclasses.dataclass
class GaussianSSMSpec:
    """The transition and initial structure twisted SMC needs in closed
    form: ``x_t ~ N(mean_fn(x_{t-1}, t), diag(transition_scale^2))`` and
    ``x_0 ~ N(initial_loc, diag(initial_scale^2))``. Each of the three
    numbers is a tensor (0-d, or `[D]` for vector latents) or a Python
    number.

    `mean_fn(previous_latent, time)` receives `[batch, K(, D)]` latents and
    the index of the state being generated (an int, or an
    `inference.DeviceTimeIndex`). `scale_fn(previous_latent, time)`, when
    given, makes the diagonal transition scale state-dependent; then
    `transition_scale` is only the representative scale of `learn_twist`'s
    ``fit_jitter`` and ``max_precision_ratio``.
    """

    initial_loc: Any
    initial_scale: Any
    transition_scale: Any
    mean_fn: Callable
    scale_fn: Optional[Callable] = None


class LogCorrectedDistribution(dists.Distribution):
    """A base distribution plus a value-independent log term per particle.

    The twisted emission: `log_prob(y)` is the base log-density summed over
    any event or extra dims, plus ``log psitilde_{t+1}(x) - log psi_t(x)``
    (the `[batch, K]` ``log_correction``). `batch_shape` is the
    correction's shape, so that `state.log_prob` takes its direct branch
    for `[batch, K(, event)]` values. Sampling falls through to the base.
    """

    def __init__(self, base, log_correction, batch_shape_mode=None):
        self.base = base
        self.log_correction = log_correction
        self.batch_shape_mode = batch_shape_mode

    @property
    def batch_shape(self):
        return tuple(self.log_correction.shape)

    @property
    def event_shape(self):
        return self.base.event_shape

    @property
    def has_rsample(self):
        return self.base.has_rsample

    @property
    def noise_kind(self):
        return self.base.noise_kind

    def noise_shape(self, sample_shape):
        return self.base.noise_shape(sample_shape)

    def rsample(self, sample_shape, eps):
        return self.base.rsample(sample_shape, eps)

    def sample(self, sample_shape, noise):
        return self.base.sample(sample_shape, noise)

    def log_prob(self, value):
        lp = self.base.log_prob(value)
        if lp.ndim > 2:
            lp = lp.reshape(lp.shape[0], lp.shape[1], -1).sum(dim=2)
        return lp + self.log_correction


def _quad_terms(m, s2, a, b):
    """Per-dim ``log int N(x'; m, s2) exp(-a/2 x'^2 + b x') dx'``,
    elementwise with broadcasting. With a = b = 0 it is 0 up to rounding,
    so a zero row of the twist is psitilde = 1."""
    p = 1.0 / s2 + a
    return (-0.5 * torch.log(s2 * p) + torch.square(m / s2 + b) / (2.0 * p)
            - torch.square(m) / (2.0 * s2))


def _reduce(x, vector: bool):
    return torch.sum(x, dim=-1) if vector else x


def _pexpand(x):
    """Inserts the particle axis: `[B(, D)]` -> `[B, 1(, D)]`."""
    return x.unsqueeze(1)


def _at(table, time):
    """``table[time]`` for an int time, or the row at a
    `DeviceTimeIndex`'s tensor (an `index_select`, no read of the
    device)."""
    if isinstance(time, DeviceTimeIndex):
        return torch.index_select(table, 0,
                                  time.value.reshape(1).long())[0]
    return table[time]


def _next_time(time, num_steps):
    """The next step's time, as the emission asks for psitilde_{t+1}: an
    int, or for a device time the clamp ``min(time + 1, T - 1)``, under
    which the zero padding row multiplies any value mean_fn gives."""
    if isinstance(time, DeviceTimeIndex):
        return DeviceTimeIndex(torch.clamp(time.value + 1,
                                           max=num_steps - 1))
    return TimeIndex(time + 1)


def _broadcast_twist(twist: QuadraticTwist, batch_size: int
                     ) -> QuadraticTwist:
    A, b, c = twist.A, twist.b, twist.c
    shape = (A.shape[0], batch_size) + tuple(A.shape[2:])
    return QuadraticTwist(A=A.expand(shape), b=b.expand(shape),
                          c=c.expand(c.shape[0], batch_size))


def make_twisted_components(spec: GaussianSSMSpec, emission,
                            twist: QuadraticTwist, batch_size: int,
                            num_timesteps=None):
    """Engine components (initial, transition, emission, proposal) of the
    psi-twisted model.

    transition and proposal are the same closed-form twisted Gaussian, so
    the engine's ``transition_lp - proposal_lp`` cancels exactly and the
    weight is the twisted increment held by the corrected emission.
    ``num_timesteps`` (`twisted_smc` passes it) checks that the twist
    covers exactly T steps.
    """
    a_rows = twist.A.shape[0]
    if twist.b.shape[0] != a_rows or twist.c.shape[0] != a_rows:
        raise ValueError(
            "twist.A/b/c must share their leading (time) length. "
            f"currently = {twist.A.shape[0]}/{twist.b.shape[0]}/"
            f"{twist.c.shape[0]}")
    if num_timesteps is not None and a_rows != num_timesteps:
        raise ValueError(
            f"twist covers {a_rows} steps but the observation sequence "
            f"has {num_timesteps} - build the twist for this T "
            "(exact_lgssm_twist / learn_twist on the same observations)")
    twist = _broadcast_twist(twist, batch_size)
    num_steps = a_rows
    vector = twist.vector
    like = twist.A
    s2 = torch.square(_like(spec.transition_scale, like))
    s02 = torch.square(_like(spec.initial_scale, like))
    m0 = _like(spec.initial_loc, like)

    # Row T is zero: psitilde_T = 1 falls out of _quad_terms.
    a_pad = torch.cat([twist.A, torch.zeros_like(twist.A[:1])], dim=0)
    b_pad = torch.cat([twist.b, torch.zeros_like(twist.b[:1])], dim=0)
    c_pad = torch.cat([twist.c, torch.zeros_like(twist.c[:1])], dim=0)

    # log mu(psi_0), the t = 0 evidence constant, [batch].
    log_mu_psi0 = (_reduce(_quad_terms(m0, s02, twist.A[0], twist.b[0]),
                           vector) + twist.c[0])

    def _s2_of(prev, time):
        """The transition variance: constant, or scale_fn^2 per particle."""
        if spec.scale_fn is None:
            return s2
        return torch.square(spec.scale_fn(prev, time))

    def _twisted_gaussian(m, a, b, s2t, mode):
        p = 1.0 / s2t + a
        loc = (m / s2t + b) / p
        scale = torch.rsqrt(p)
        if vector:
            return dists.MultivariateNormalDiag(
                loc, scale.expand(loc.shape), batch_shape_mode=mode)
        return dists.Normal(loc, scale.expand(loc.shape),
                            batch_shape_mode=mode)

    def initial_():
        return _twisted_gaussian(m0, twist.A[0], twist.b[0], s02,
                                 BatchShapeMode.BATCH_EXPANDED)

    def transition_(previous_latents=None, time=None,
                    previous_observations=None):
        del previous_observations
        prev = previous_latents[-1]
        return _twisted_gaussian(
            spec.mean_fn(prev, time), _pexpand(_at(a_pad, time)),
            _pexpand(_at(b_pad, time)), _s2_of(prev, time),
            BatchShapeMode.FULLY_EXPANDED)

    def proposal_(previous_latents=None, time=None, observations=None):
        del observations
        if isinstance(time, int) and time == 0:
            return initial_()
        return transition_(previous_latents=previous_latents, time=time)

    def emission_(latents=None, time=None, previous_observations=None):
        base = emission(latents=latents, time=time,
                        previous_observations=previous_observations)
        x = latents[-1]
        static = isinstance(time, int)
        # log psitilde_{t+1}(x) integrates the next kernel against
        # psi_{t+1}. At the final step it is 0: an int time skips the term
        # (mean_fn is never asked for the time T); a device time clamps
        # mean_fn's time to T - 1 over the zero row.
        if static and time + 1 >= num_steps:
            lp_tilde = torch.zeros(x.shape[:2], dtype=like.dtype,
                                   device=x.device)
        else:
            t_next = _next_time(time, num_steps)
            row = (time + 1 if static
                   else DeviceTimeIndex(_inference._unwrap_time(time) + 1))
            lp_tilde = (_reduce(_quad_terms(
                spec.mean_fn(x, t_next), _s2_of(x, t_next),
                _pexpand(_at(a_pad, row)), _pexpand(_at(b_pad, row))),
                vector) + _pexpand(_at(c_pad, row)))
        lp_psi = (_reduce(-0.5 * _pexpand(_at(a_pad, time)) * torch.square(x)
                          + _pexpand(_at(b_pad, time)) * x, vector)
                  + _pexpand(_at(c_pad, time)))
        corr = lp_tilde - lp_psi
        if static and time == 0:
            corr = corr + _pexpand(log_mu_psi0)
        return LogCorrectedDistribution(
            base, corr, batch_shape_mode=BatchShapeMode.FULLY_EXPANDED)

    return initial_, transition_, emission_, proposal_


def _per_batch(table_bd, idx):
    """``out[b, k] = table_bd[b, idx[b, k]]`` for `table_bd [B, D]`, with
    `math.table_lookup`'s index rules (a negative index wraps once, then
    every index is clamped into [0, D - 1])."""
    d = table_bd.shape[-1]
    idx = idx.long()
    idx = torch.clamp(torch.where(idx < 0, idx + d, idx), 0, d - 1)
    return torch.take_along_dim(table_bd, idx, dim=1)


def make_discrete_twisted_components(spec: DiscreteSSMSpec, emission,
                                     twist: TabularTwist, batch_size: int,
                                     num_timesteps=None):
    """Engine components of the psi-twisted discrete model (HMM family).

    The twisted transition is the renormalized Categorical with logits
    ``logP[x_{t-1}] + log psi_t``; transition and proposal cancel exactly;
    the emission carries ``log g + log psitilde_{t+1} - log psi_t`` (plus
    ``log mu(psi_0)`` at t = 0), with psitilde an exact log-matrix-vector
    product. Particles are int32 and take the HMM family's paths.
    """
    logpsi = twist.logpsi
    if logpsi.ndim != 3:
        raise ValueError(
            "TabularTwist.logpsi must be [T, batch, D], got "
            f"{tuple(logpsi.shape)}")
    if num_timesteps is not None and logpsi.shape[0] != num_timesteps:
        raise ValueError(
            f"twist covers {logpsi.shape[0]} steps but the observation "
            f"sequence has {num_timesteps} - build the twist for this T "
            "(exact_hmm_twist on the same observations)")
    num_steps, _, num_states = logpsi.shape
    logpsi = logpsi.expand(num_steps, batch_size, num_states)
    log_p = torch.log_softmax(_like(spec.transition_logits, logpsi), dim=-1)
    log_pi0 = torch.log_softmax(_like(spec.initial_logits, logpsi), dim=-1)
    if tuple(log_p.shape) != (num_states, num_states):
        raise ValueError(
            f"transition_logits {tuple(log_p.shape)} vs twist "
            f"D={num_states}")

    # psi_pad row T = log 1; psitilde_pad[t](i) = lse_j logP[i, j] +
    # psi_pad[t, b, j], its last row exactly 0.
    psi_pad = torch.cat([logpsi, torch.zeros_like(logpsi[:1])], dim=0)
    psitilde = torch.logsumexp(log_p[None, None] + psi_pad[:, :, None, :],
                               dim=-1)
    psitilde_pad = torch.cat([psitilde[:-1], torch.zeros_like(psitilde[:1])],
                             dim=0)
    log_mu_psi0 = torch.logsumexp(log_pi0[None, :] + logpsi[0], dim=-1)

    def initial_():
        return dists.Categorical(
            log_pi0[None, :] + logpsi[0],
            batch_shape_mode=BatchShapeMode.BATCH_EXPANDED)

    def transition_(previous_latents=None, time=None,
                    previous_observations=None):
        del previous_observations
        logits = (amath.table_lookup(log_p, previous_latents[-1])
                  + _at(psi_pad, time)[:, None, :])            # [B, K, D]
        return dists.Categorical(
            logits, batch_shape_mode=BatchShapeMode.FULLY_EXPANDED)

    def proposal_(previous_latents=None, time=None, observations=None):
        del observations
        if isinstance(time, int) and time == 0:
            return initial_()
        return transition_(previous_latents=previous_latents, time=time)

    def emission_(latents=None, time=None, previous_observations=None):
        base = emission(latents=latents, time=time,
                        previous_observations=previous_observations)
        x = latents[-1]                                        # [B, K]
        row = (time + 1 if isinstance(time, int)
               else DeviceTimeIndex(_inference._unwrap_time(time) + 1))
        corr = (_per_batch(_at(psitilde_pad, row), x)
                - _per_batch(_at(psi_pad, time), x))
        if isinstance(time, int) and time == 0:
            corr = corr + log_mu_psi0[:, None]
        return LogCorrectedDistribution(
            base, corr, batch_shape_mode=BatchShapeMode.FULLY_EXPANDED)

    return initial_, transition_, emission_, proposal_


def _twist_rows(twist, rows, global_batch):
    """The twist's tables cut to this rank's rows of the global batch (a
    batch axis of 1 broadcasts and stays)."""
    def cut(table):
        if table.shape[1] == 1:
            return table
        if table.shape[1] != global_batch:
            raise ValueError(
                f"the twist's batch axis is {table.shape[1]}; on a mesh it "
                f"must be 1 or the global batch {global_batch}")
        return table[:, rows]

    return dataclasses.replace(twist, **{
        f.name: cut(getattr(twist, f.name))
        for f in dataclasses.fields(twist)})


def twisted_smc(observations, spec, emission, twist, num_particles: int,
                noise=None, mesh=None, **infer_kwargs) -> dict:
    """SMC on the psi-twisted model, through `inference.infer('smc', ...)`:
    the same keyword arguments and return vocabulary
    (``return_log_marginal_likelihood`` defaults to True).

    ``spec`` selects the family: `GaussianSSMSpec` with a `QuadraticTwist`
    (continuous latents) or `DiscreteSSMSpec` with a `TabularTwist` (HMM).
    The log-evidence estimate is unbiased in Z for the original model at
    any twist, and exact at the optimal twist.

    ``mesh`` (with ``data_axis`` and ``particle_axis`` among the keyword
    arguments) runs `infer(mesh=...)`: the observations are this rank's
    rows, the twist's tables are built over the global batch (or a batch
    of 1) and cut here to this rank's rows, and the outputs are this
    rank's blocks.
    """
    stacked = _inference.stack_observations(observations)
    lead = _inference._first_leaf(stacked)
    batch_size = lead.shape[1]
    if mesh is not None:
        from .sharding_utils import Cloud
        cloud = Cloud(mesh, infer_kwargs.get("data_axis", "data"),
                      infer_kwargs.get("particle_axis", "particle"))
        global_batch = batch_size * cloud.n_data
        twist = _twist_rows(twist, cloud.rows(global_batch), global_batch)
        infer_kwargs["mesh"] = mesh
    maker = (make_discrete_twisted_components
             if isinstance(spec, DiscreteSSMSpec)
             else make_twisted_components)
    initial_, transition_, emission_, proposal_ = maker(
        spec, emission, twist, batch_size, num_timesteps=lead.shape[0])
    infer_kwargs.setdefault("return_log_marginal_likelihood", True)
    return _inference.infer(
        "smc", stacked, initial_, transition_, emission_, proposal_,
        num_particles=num_particles, noise=noise, **infer_kwargs)


def exact_lgssm_twist(observations, initial_mean, initial_scale,
                      transition_mult, transition_scale, emission_mult,
                      emission_scale) -> QuadraticTwist:
    """The optimal twist psi_t(x) = p(y_{t:T-1} | x_t) of a linear-Gaussian
    SSM (numbers, or `[D]` tensors for independent dimensions), by the
    backward information filter: psi_{T-1} = g_{T-1}, psi_t = g_t
    psitilde_{t+1}. In the observations' dtype (float32 for integer ones)
    on their device. `initial_mean`/`initial_scale` are unused (the t = 0
    twist acts through the twisted initial), kept for symmetry with the
    Kalman oracles.
    """
    del initial_mean, initial_scale
    y = _inference.stack_observations(observations)
    y = y.to(_float_dtype(y))
    vector = y.ndim == 3
    a = _like(transition_mult, y)
    s2 = torch.square(_like(transition_scale, y))
    ce = _like(emission_mult, y)
    e2 = torch.square(_like(emission_scale, y))
    a_til = b_til = c_til = torch.zeros_like(y[0] * (ce * 0 + 1))
    rows = []
    for t in range(y.shape[0] - 1, -1, -1):
        y_t = y[t]
        # psi_t = g_t * psitilde_{t+1}, expanded in x.
        a_t = torch.square(ce) / e2 + a_til
        b_t = y_t * ce / e2 + b_til
        c_t = (-0.5 * torch.square(y_t) / e2
               - 0.5 * torch.log(2.0 * _stdmath.pi * e2) + c_til)
        rows.append((a_t, b_t, c_t))
        # psitilde_t(x) = int N(x'; a x, s2) psi_t(x') dx', quadratic in x.
        p = 1.0 / s2 + a_t
        a_til = (torch.square(a) / s2
                 - torch.square(a) / (torch.square(s2) * p))
        b_til = a * b_t / (s2 * p)
        c_til = (torch.square(b_t) / (2.0 * p) + c_t
                 - 0.5 * torch.log(s2 * p))
    A, b, c = (torch.stack(list(x)[::-1]) for x in zip(*rows))
    if vector:
        c = torch.sum(c, dim=-1)
    return QuadraticTwist(A=A, b=b, c=c)


def exact_hmm_twist(observations, initial_logits, transition_logits,
                    locs=None, scale=None, *, emission_logliks=None
                    ) -> TabularTwist:
    """The optimal twist ``psi_t(x) = p(y_{t:T-1} | x_t = x)`` of a discrete
    HMM by the backward (beta) recursion ``psi_{T-1} = g_{T-1}``,
    ``psi_t = g_t (P psi_{t+1})``.

    Pass the Gaussian emission's `locs` `[D]` and `scale` (as
    `models.hmm.Emission` holds them), or `emission_logliks` `[T, B, D]`
    (log g_t(y_t | d)) for any emission. The table is in the float dtype
    of the observations (or of the log-likelihoods), on their device.
    `initial_logits` is unused (kept for symmetry with
    `models.hmm.hmm_forward`).
    """
    del initial_logits
    if emission_logliks is None:
        if locs is None or scale is None:
            raise ValueError("pass (locs, scale) or emission_logliks=")
        y = _inference.stack_observations(observations)
        y = y.to(_float_dtype(y))
        ll = dists.Normal(_like(locs, y)[None, None, :], _like(scale, y)
                          ).log_prob(y[:, :, None])            # [T, B, D]
    else:
        ll = emission_logliks.to(_float_dtype(emission_logliks))
    log_p = torch.log_softmax(_like(transition_logits, ll), dim=-1)
    psi = torch.zeros_like(ll[0])
    psis = []
    for t in range(ll.shape[0] - 1, -1, -1):
        # psitilde_{t+1}(i) = lse_j logP[i, j] + psi_{t+1}(j); the zero
        # start makes psi_{T-1} = g_{T-1} exactly.
        psi = ll[t] + torch.logsumexp(log_p[None] + psi[:, None, :], dim=-1)
        psis.append(psi)
    return TabularTwist(logpsi=torch.stack(psis[::-1]))


def _solve_or_zero(gram, rhs):
    """Batched ``solve(gram, rhs)`` `[B, F]` for `[B, F, F]` Gram matrices;
    a row whose factorization failed or whose solution is not finite
    becomes zeros (the zero twist row). `solve_ex` keeps its error flag on
    the device."""
    sol, info = torch.linalg.solve_ex(gram, rhs.unsqueeze(-1))
    sol = sol.squeeze(-1)
    ok = (info == 0) & torch.isfinite(sol).all(dim=-1)
    return torch.where(ok[:, None], sol, torch.zeros_like(sol))


def _fit_quadratic(x, target, ridge, weights=None):
    """Least-squares fits of ``target`` `[B, K]` on quadratic features of
    ``x`` (`[B, K]` scalar or `[B, K, D]` vector latents), one a batch row:
    (A `[B(, D)]`, b `[B(, D)]`, c `[B]`), A clamped >= 0 so that the
    twisted kernels stay proper.

    ``weights`` `[B, K]` (normalized) make it weighted least squares, the
    regression under the filter distribution. A (near-)singular Gram, or
    a solution that is not finite, gives the zero row; (b, c) are refit
    with A held at its clamped value, so the triple is the constrained
    fit where the clamp binds (the joint fit where it does not). One
    batched solve of the `[B, 2D + 1, 2D + 1]` Gram matrices, then of the
    `[B, D + 1, D + 1]` ones.
    """
    xm = x.unsqueeze(-1) if x.ndim == 2 else x                  # [B, K, D]
    num_particles, d = xm.shape[1], xm.shape[-1]
    if weights is not None:
        # sqrt-weight rows, scaled so that the ridge keeps its unweighted
        # meaning (the weights sum to 1).
        sw = torch.sqrt(weights * num_particles).unsqueeze(-1)
    else:
        sw = torch.ones_like(xm[..., :1])
    ones = torch.ones_like(xm[..., :1])
    phi = torch.cat([torch.square(xm), xm, ones], dim=-1) * sw  # [B, K, F]
    tgt = target * sw[..., 0]
    eye = torch.eye(phi.shape[-1], dtype=x.dtype, device=x.device)
    gram = phi.transpose(1, 2) @ phi + ridge * eye
    theta = _solve_or_zero(gram, (phi.transpose(1, 2) @ tgt.unsqueeze(-1)
                                  ).squeeze(-1))
    a_fit = torch.clamp(-2.0 * theta[:, :d], min=0.0)
    # Refit (b, c) given A: target + A/2 x^2 ~= b x + c.
    resid = ((target + 0.5 * torch.sum(torch.square(xm) * a_fit[:, None, :],
                                       dim=-1)) * sw[..., 0])
    phi2 = torch.cat([xm, ones], dim=-1) * sw
    eye2 = torch.eye(d + 1, dtype=x.dtype, device=x.device)
    gram2 = phi2.transpose(1, 2) @ phi2 + ridge * eye2
    theta2 = _solve_or_zero(gram2, (phi2.transpose(1, 2) @ resid.unsqueeze(-1)
                                    ).squeeze(-1))
    b_fit, c_fit = theta2[:, :d], theta2[:, -1]
    if x.ndim == 2:
        return a_fit[:, 0], b_fit[:, 0], c_fit
    return a_fit, b_fit, c_fit


def _adp_refit(observations, spec: GaussianSSMSpec, emission, xs, ridge,
               log_weights=None, fit_jitter: float = 0.0,
               noise=None) -> QuadraticTwist:
    """One backward ADP pass: fits log psi_t to ``log g_t + log
    psitilde_{t+1}`` at the particles `xs` `[T, B, K(, D)]`, t from T-1
    down to 0 (the emission sees the int 0 at t = 0 and `TimeIndex` ints
    after).

    ``log_weights`` `[T, B, K]` (the twisted run's pre-resampling weights)
    make the regressions weighted by the filter distribution.
    ``fit_jitter > 0`` instead chooses the design points: the cloud
    resampled multinomially by those weights (one Gumbel-argmax a slot:
    `[B, K, K]` Gumbel noise a step) plus ``fit_jitter * scale`` normal
    noise, fitted unweighted, the targets evaluated there. The draws come
    from ``noise``, t = T-1 first.
    """
    y = _inference.stack_observations(observations)
    num_timesteps, batch_size, num_particles = xs.shape[:3]
    vector = xs.ndim == 4
    like = xs
    s2 = torch.square(_like(spec.transition_scale, like))
    lw = (log_weights if log_weights is not None
          else torch.zeros(xs.shape[:3], dtype=xs.dtype, device=xs.device))
    w = amath.exponentiate_and_normalize(lw, dim=-1)
    jitter = float(fit_jitter)
    if jitter and noise is None:
        raise ValueError("fit_jitter > 0 draws design points: pass noise")

    def design(x_t, lw_t, scale):
        """`[B, K(, D)]` design points: resampled by weight, jittered."""
        gumbel = noise.gumbel((batch_size, num_particles, num_particles))
        idx = torch.argmax(gumbel.to(lw_t.dtype) + lw_t[:, None, :], dim=-1)
        xd = state.resample(x_t, idx)
        eps = noise.normal(tuple(xd.shape)).to(xd.dtype)
        return xd + jitter * _like(scale, like) * eps

    a_n = b_n = torch.zeros_like(xs[0, :, 0])                  # [B(, D)]
    c_n = torch.zeros(batch_size, dtype=xs.dtype, device=xs.device)
    fits = []
    for t in range(num_timesteps - 1, -1, -1):
        x_t, w_t = xs[t], w[t]
        if jitter:
            x_t = design(x_t, lw[t], spec.transition_scale if t
                         else spec.initial_scale)
            w_t = torch.full_like(w_t, 1.0 / num_particles)
        time = TimeIndex(t) if t else 0
        g = state.log_prob(emission(latents=[x_t], time=time),
                           state.expand_observation(y[t], num_particles))
        # psitilde_T = 1 at t = T-1 (a zero carry); the time mean_fn sees
        # there is clamped to T - 1.
        t_next = TimeIndex(min(t + 1, num_timesteps - 1))
        s2_next = (s2 if spec.scale_fn is None
                   else torch.square(spec.scale_fn(x_t, t_next)))
        lp_tilde = (_reduce(_quad_terms(spec.mean_fn(x_t, t_next), s2_next,
                                        _pexpand(a_n), _pexpand(b_n)),
                            vector) + _pexpand(c_n))
        a_n, b_n, c_n = _fit_quadratic(x_t, g + lp_tilde, ridge, w_t)
        fits.append((a_n, b_n, c_n))
    A, b, c = (torch.stack(list(v)[::-1]) for v in zip(*fits))
    return QuadraticTwist(A=A, b=b, c=c)


@torch.no_grad()
def learn_twist(observations, spec: GaussianSSMSpec, emission,
                num_particles: int, noise=None, num_iterations: int = 2,
                init_twist: Optional[QuadraticTwist] = None,
                ridge: float = 1e-6, weighted: bool = True,
                damping: float = 0.0,
                max_precision_ratio: Optional[float] = None,
                fit_jitter: float = 0.0, keep: str = "last",
                keep_num_particles: Optional[int] = None,
                keep_num_seeds: int = 1, **smc_kwargs):
    """Iterated ADP twist learning (psi-APF, Guarniero et al. 2017).

    Each iteration runs twisted SMC under the current twist (at
    ``num_particles``) and refits all T twists by backward regression on
    quadratic features of its pre-resampling particles (`_adp_refit`).
    Returns ``(twist, info)`` with the per-iteration evidence estimates in
    ``info['log_marginal_likelihood']`` `[iters, batch]`.

    Controls for models whose optimal twist is not log-quadratic, as in
    the JAX package: ``weighted`` (regress under the filter distribution),
    ``damping`` (the new twist is ``(1 - damping) fitted + damping
    previous``), ``fit_jitter`` (design points resampled by weight plus
    ``fit_jitter * scale`` normal noise), ``max_precision_ratio`` kappa
    (A capped at ``kappa / scale^2``, the initial scale for row 0, with b
    rescaled so that the twist's mode b / A stays), and ``keep='best'``:
    every candidate (the init twist and each iteration's fit) is scored by
    the mean log-evidence of ``keep_num_seeds`` twisted runs at
    ``keep_num_particles`` particles, and each batch row takes its best
    candidate (``info['scores']`` `[iters + 1, batch]`,
    ``info['selected']`` `[batch]`, 0 = the init twist). The selection
    stays on the device.

    Draws from ``noise`` (default `NoiseSource.seeded(0)` on the
    observations' device), per iteration the twisted run's and then the
    refit's; with 'best', per candidate the seeds' runs in order.

    ``mesh`` among the keyword arguments (as the JAX package's reach
    `infer`): the observations are this rank's rows and ``init_twist`` is
    built over the global batch (or a batch of 1). Each twisted run is
    `twisted_smc(mesh=...)`; the refit regresses this rank's rows on their
    particles gathered over the particle group (`[T, B_l, K, ...]` a rank,
    the same fit on every rank of the group) and draws its rows' block of
    the design-point noise. The fitted twists, the evidence estimates and
    the scores are gathered over the data group, so every rank returns the
    global result of the single-device call.
    """
    if keep not in ("last", "best"):
        raise ValueError(f"keep must be 'last' or 'best', got {keep!r}")
    y = _inference.stack_observations(observations)
    lead = _inference._first_leaf(y)
    if noise is None:
        noise = NoiseSource.seeded(0, lead.device)
    num_timesteps, batch_size = lead.shape[0], lead.shape[1]
    cloud, refit_noise = None, noise
    if smc_kwargs.get("mesh") is not None:
        from .sharding_utils import Cloud
        cloud = Cloud(smc_kwargs["mesh"],
                      smc_kwargs.get("data_axis", "data"),
                      smc_kwargs.get("particle_axis", "particle"))
        batch_size *= cloud.n_data
        refit_noise = cloud.noise(noise).along(0, None)

    def rows(x, dim=0):
        """``x`` over the global batch (gathered over the data group)."""
        return x if cloud is None else cloud.gather_rows(x, dim)

    loc = spec.initial_loc
    dim = (loc.shape[-1] if isinstance(loc, torch.Tensor) and loc.ndim
           else None)
    twist = (init_twist if init_twist is not None else QuadraticTwist.zeros(
        num_timesteps, batch_size, dim, dtype=_float_dtype(lead),
        device=lead.device))
    need_lw = weighted or fit_jitter > 0

    def one_iteration(tw):
        out = twisted_smc(
            y, spec, emission, tw, num_particles, noise=noise,
            return_latents=False, return_original_latents=True,
            return_log_weights=need_lw, **smc_kwargs)
        xs = out["original_latents"]
        lw = out["log_weights"] if need_lw else None
        if cloud is not None:
            xs = cloud.gather_particles(xs, dim=2)
            lw = None if lw is None else cloud.gather_particles(lw, dim=2)
        fitted = _adp_refit(y, spec, emission, xs, ridge, log_weights=lw,
                            fit_jitter=fit_jitter, noise=refit_noise)
        fitted = QuadraticTwist(A=rows(fitted.A, 1), b=rows(fitted.b, 1),
                                c=rows(fitted.c, 1))
        if damping:
            fitted = QuadraticTwist(
                A=(1.0 - damping) * fitted.A + damping * tw.A,
                b=(1.0 - damping) * fitted.b + damping * tw.b,
                c=(1.0 - damping) * fitted.c + damping * tw.c)
        if max_precision_ratio is not None:
            # Row 0 twists the initial kernel (scale s0), rows 1..T-1 the
            # transition kernel (scale s).
            like = fitted.A
            s2 = torch.square(_like(spec.transition_scale, like))
            s02 = torch.square(_like(spec.initial_scale, like))
            kap = float(max_precision_ratio)
            a_cap = torch.cat([(kap / s02).expand(fitted.A[:1].shape),
                               (kap / s2).expand(fitted.A[1:].shape)], dim=0)
            a_new = torch.minimum(fitted.A, a_cap)
            # b scales with A, so that the twist's mode b / A stays where
            # the cap binds.
            scale = torch.where(fitted.A > 0,
                                a_new / torch.clamp(fitted.A, min=1e-30),
                                torch.ones_like(fitted.A))
            fitted = QuadraticTwist(A=a_new, b=fitted.b * scale, c=fitted.c)
        return fitted, rows(out["log_marginal_likelihood"])

    log_zs, twists = [], []
    for _ in range(num_iterations):
        twists.append(twist)
        twist, log_z = one_iteration(twist)
        log_zs.append(log_z)
    if keep == "last":
        return twist, {"log_marginal_likelihood": torch.stack(log_zs)}
    # keep='best': each candidate scored at the deploy particle count, then
    # a selection per batch row.
    twists.append(twist)
    k_score = (num_particles if keep_num_particles is None
               else keep_num_particles)
    scores = []
    for tw in twists:
        runs = [twisted_smc(y, spec, emission, tw, k_score, noise=noise,
                            return_latents=False, return_log_weight=False,
                            **smc_kwargs)["log_marginal_likelihood"]
                for _ in range(int(keep_num_seeds))]
        scores.append(rows(torch.stack(runs).mean(dim=0)))
    scores = torch.stack(scores)                               # [n, B]
    sel = torch.argmax(scores, dim=0)                          # [B]

    def pick(field):                                           # [n, T, B(,D)]
        stacked = torch.stack([getattr(tw, field).expand(
            getattr(twist, field).shape) for tw in twists])
        idx = sel.reshape((1, 1, -1) + (1,) * (stacked.ndim - 3))
        return torch.take_along_dim(stacked, idx, dim=0)[0]

    best = QuadraticTwist(A=pick("A"), b=pick("b"), c=pick("c"))
    return best, {"log_marginal_likelihood": torch.stack(log_zs),
                  "scores": scores, "selected": sel}
