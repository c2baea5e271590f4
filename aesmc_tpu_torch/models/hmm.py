"""Discrete-latent hidden Markov model, as `nn.Module`s, with exact
oracles.

Counterpart of `aesmc_tpu.models.hmm`: latent x_t in {0..D-1} (int32
particles), sticky categorical transitions, Gaussian emissions with
per-state means (`Emission.locs`, trainable), and the exact locally
optimal proposal

    q(x_t = j | x_{t-1} = i, y_t) propto P[i, j] * N(y_t; mu_j, sigma),

closed-form because the state space is finite (the fully adapted particle
filter). Each module's `forward` returns a `distributions.Categorical` or
`Normal` tagged with its batch-shape mode, with the JAX components' call
contract. `from_numpy` builds the modules from the JAX components' fields,
so that both packages compute the same model in the tests.

The oracles (`hmm_forward`, `hmm_smoother`, `hmm_viterbi`,
`hmm_pairwise_marginals`) are the log-domain recursions in float64 numpy,
for one sequence at a time, the role `models.kalman` plays for the LGSSM.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .. import device as _device
from ..distributions import Categorical, Normal
from ..math import table_lookup
from ..state import BatchShapeMode


def _tensor(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x, dtype=np.float32))


class Initial(nn.Module):
    """p(x_0) = Categorical(softmax(logits)), logits `[D]`."""

    def __init__(self, logits):
        super().__init__()
        self.register_buffer("logits", _tensor(logits))

    def forward(self):
        return Categorical(self.logits)


class Transition(nn.Module):
    """p(x_t = j | x_{t-1} = i) = softmax(logits[i])_j, logits `[D, D]`.

    Row lookup by the integer parents: `[B, K]` parents give a `[B, K, D]`
    -logit Categorical (and `[B, K, 1]` parents a `[B, K, 1, D]` one, which
    broadcasts against `[B, 1, M]` children).
    """

    def __init__(self, logits):
        super().__init__()
        self.register_buffer("logits", _tensor(logits))

    def forward(self, previous_latents=None, time=None,
                previous_observations=None):
        return Categorical(table_lookup(self.logits, previous_latents[-1]),
                           batch_shape_mode=BatchShapeMode.FULLY_EXPANDED)

    def log_bound(self, prev_latent, time=None, previous_observations=None):
        """The largest log-probability over (parent, child), `[B]`: the
        exact `transition_log_bound` of rejection smoothing."""
        bound = torch.log_softmax(self.logits, dim=-1).max()
        return bound.expand(prev_latent.shape[0])


class Emission(nn.Module):
    """p(y_t | x_t = j) = N(locs[j], scale^2); `locs` `[D]` trainable."""

    def __init__(self, locs, scale: float):
        super().__init__()
        self.locs = nn.Parameter(_tensor(locs))
        self.scale = float(scale)

    def forward(self, latents=None, time=None, previous_observations=None):
        return Normal(table_lookup(self.locs, latents[-1]), self.scale,
                      batch_shape_mode=BatchShapeMode.FULLY_EXPANDED)


class Proposal(nn.Module):
    """The exact locally optimal proposal (the fully adapted filter): the
    transition row (the prior at t = 0) times every state's emission
    likelihood of y_t, normalized."""

    def __init__(self, initial_logits, transition_logits, emission_locs,
                 emission_scale: float):
        super().__init__()
        self.register_buffer("initial_logits", _tensor(initial_logits))
        self.register_buffer("transition_logits", _tensor(transition_logits))
        self.register_buffer("emission_locs", _tensor(emission_locs))
        self.emission_scale = float(emission_scale)

    def _state_loglik(self, obs_t):
        # [B, D]: log N(y_t; mu_j, sigma) for every state j.
        return Normal(self.emission_locs[None, :],
                      self.emission_scale).log_prob(obs_t[:, None])

    def forward(self, previous_latents=None, time=None, observations=None):
        loglik = self._state_loglik(observations[time])        # [B, D]
        if time == 0:
            return Categorical(self.initial_logits[None, :] + loglik,
                               batch_shape_mode=BatchShapeMode.BATCH_EXPANDED)
        logits = (table_lookup(self.transition_logits, previous_latents[-1])
                  + loglik[:, None, :])                          # [B, K, D]
        return Categorical(logits,
                           batch_shape_mode=BatchShapeMode.FULLY_EXPANDED)


class BootstrapProposal(nn.Module):
    """Proposes from the model: the prior at t = 0, the transition row
    after."""

    def __init__(self, initial_logits, transition_logits):
        super().__init__()
        self.register_buffer("initial_logits", _tensor(initial_logits))
        self.register_buffer("transition_logits", _tensor(transition_logits))

    def forward(self, previous_latents=None, time=None, observations=None):
        if time == 0:
            return Categorical(self.initial_logits)
        return Categorical(
            table_lookup(self.transition_logits, previous_latents[-1]),
            batch_shape_mode=BatchShapeMode.FULLY_EXPANDED)


def sticky_transition_logits(num_states: int, stay_prob: float = 0.9):
    """Sticky chain: stay with ``stay_prob``, else uniform; `[D, D]`
    float32 numpy log-probabilities."""
    off = (1.0 - stay_prob) / max(num_states - 1, 1)
    p = np.full((num_states, num_states), off)
    np.fill_diagonal(p, stay_prob)
    return np.log(p.astype(np.float32))


def make_model(num_states: int = 3, locs=None, emission_scale: float = 0.5,
               stay_prob: float = 0.9, proposal: str = "optimal",
               device=None):
    """(initial, transition, emission, proposal) for a sticky HMM, on
    ``device`` (default: the card; raises without one).

    Default emission means are equispaced on [-(D-1), D-1], so that the
    states are distinguishable at ``emission_scale=0.5`` but overlap.
    """
    if proposal not in ("optimal", "bootstrap"):
        raise ValueError(f"proposal must be 'optimal' or 'bootstrap'. "
                         f"currently = {proposal}")
    device = _device.resolve(device)
    if locs is None:
        locs = np.linspace(-(num_states - 1.0), num_states - 1.0, num_states)
    locs = np.asarray(locs, np.float32)
    pi = np.zeros((num_states,), np.float32)
    trans = sticky_transition_logits(num_states, stay_prob)
    if proposal == "optimal":
        prop = Proposal(pi, trans, locs, emission_scale)
    else:
        prop = BootstrapProposal(pi, trans)
    return tuple(module.to(device) for module in (
        Initial(pi), Transition(trans), Emission(locs, emission_scale),
        prop))


def from_numpy(params: dict, device=None):
    """Builds (initial, transition, emission, proposal) from numpy fields,
    on ``device`` (default: the card; raises without one).

    ``params`` maps 'initial', 'transition', 'emission' and 'proposal' to
    dicts of the JAX components' fields: {'logits'}, {'logits'}, {'locs',
    'scale'}, and either {'initial_logits', 'transition_logits',
    'emission_locs', 'emission_scale'} (the optimal proposal) or
    {'initial_logits', 'transition_logits'} (the bootstrap proposal).
    """
    device = _device.resolve(device)
    init, tr, em, prop = (params[k] for k in
                          ("initial", "transition", "emission", "proposal"))
    if "emission_locs" in prop:
        proposal = Proposal(prop["initial_logits"], prop["transition_logits"],
                            prop["emission_locs"],
                            float(prop["emission_scale"]))
    else:
        proposal = BootstrapProposal(prop["initial_logits"],
                                     prop["transition_logits"])
    return tuple(module.to(device) for module in (
        Initial(init["logits"]), Transition(tr["logits"]),
        Emission(em["locs"], float(em["scale"])), proposal))


# ---------------------------------------------------------------------
# Exact oracles: float64 numpy, one sequence at a time.
# ---------------------------------------------------------------------

def log_softmax(x, axis=-1):
    """``x - logsumexp(x)`` along ``axis``, in float64."""
    x = np.asarray(x, dtype=np.float64)
    shifted = x - np.max(x, axis=axis, keepdims=True)
    return shifted - np.log(np.sum(np.exp(shifted), axis=axis,
                                   keepdims=True))


def _logsumexp(a, axis=None):
    m = np.max(a, axis=axis, keepdims=True)
    out = m + np.log(np.sum(np.exp(a - m), axis=axis, keepdims=True))
    return np.squeeze(out, axis=axis) if axis is not None else out


def _log_emission_matrix(obs, locs, scale):
    obs = np.asarray(obs, dtype=np.float64).reshape(-1)
    locs = np.asarray(locs, dtype=np.float64)
    return (-0.5 * ((obs[:, None] - locs[None, :]) / scale) ** 2
            - 0.5 * np.log(2.0 * np.pi * scale ** 2))         # [T, D]


def _forward_backward(obs, initial_logits, transition_logits, locs, scale,
                      backward=True):
    """(log_a `[D, D]`, log_b `[T, D]`, log_alpha `[T, D]`, log_beta
    `[T, D]` or None)."""
    log_pi = log_softmax(initial_logits)
    log_a = log_softmax(transition_logits, axis=-1)
    log_b = _log_emission_matrix(obs, locs, scale)
    t_len, d = log_b.shape
    log_alpha = np.zeros((t_len, d))
    log_alpha[0] = log_pi + log_b[0]
    for t in range(1, t_len):
        log_alpha[t] = log_b[t] + _logsumexp(
            log_alpha[t - 1][:, None] + log_a, axis=0)
    if not backward:
        return log_a, log_b, log_alpha, None
    log_beta = np.zeros((t_len, d))
    for t in range(t_len - 2, -1, -1):
        log_beta[t] = _logsumexp(
            log_a + (log_b[t + 1] + log_beta[t + 1])[None, :], axis=1)
    return log_a, log_b, log_alpha, log_beta


def hmm_forward(obs, initial_logits, transition_logits, locs, scale):
    """Log-domain forward recursion for ONE sequence.

    Returns:
        (filtered `[T, D]`: p(x_t | y_{0:t}), log-likelihood float).
    """
    _, _, log_alpha, _ = _forward_backward(
        obs, initial_logits, transition_logits, locs, scale, backward=False)
    loglik = float(_logsumexp(log_alpha[-1], axis=0))
    filtered = np.exp(log_alpha - _logsumexp(log_alpha, axis=1)[:, None])
    return filtered, loglik


def hmm_smoother(obs, initial_logits, transition_logits, locs, scale):
    """Forward-backward smoothed marginals `[T, D]` for ONE sequence."""
    _, _, log_alpha, log_beta = _forward_backward(
        obs, initial_logits, transition_logits, locs, scale)
    log_gamma = log_alpha + log_beta
    return np.exp(log_gamma - _logsumexp(log_gamma, axis=1)[:, None])


def hmm_viterbi(obs, initial_logits, transition_logits, locs, scale):
    """Exact MAP state path (Viterbi) for ONE sequence: (`[T]` int path,
    joint log-probability of the path)."""
    log_pi = log_softmax(initial_logits)
    log_a = log_softmax(transition_logits, axis=-1)
    log_b = _log_emission_matrix(obs, locs, scale)            # [T, D]
    t_len, d = log_b.shape
    delta = log_pi + log_b[0]
    back = np.zeros((t_len, d), dtype=np.int64)
    for t in range(1, t_len):
        scores = delta[:, None] + log_a                       # [D, D]
        back[t] = np.argmax(scores, axis=0)
        delta = scores[back[t], np.arange(d)] + log_b[t]
    path = np.zeros(t_len, dtype=np.int64)
    path[-1] = int(np.argmax(delta))
    for t in range(t_len - 2, -1, -1):
        path[t] = back[t + 1][path[t + 1]]
    return path, float(np.max(delta))


def hmm_pairwise_marginals(obs, initial_logits, transition_logits, locs,
                           scale):
    """Exact smoothed pairwise marginals xi_t[i, j] = p(x_t = i,
    x_{t+1} = j | y_{0:T-1}), `[T-1, D, D]`: the Baum-Welch E-step
    statistic."""
    log_a, log_b, log_alpha, log_beta = _forward_backward(
        obs, initial_logits, transition_logits, locs, scale)
    loglik = _logsumexp(log_alpha[-1], axis=0)
    t_len, d = log_b.shape
    xi = np.zeros((t_len - 1, d, d))
    for t in range(t_len - 1):
        xi[t] = np.exp(log_alpha[t][:, None] + log_a +
                       (log_b[t + 1] + log_beta[t + 1])[None, :] - loglik)
    return xi
