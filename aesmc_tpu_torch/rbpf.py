"""Rao-Blackwellised particle filter (the marginalized particle filter).

Counterpart of `aesmc_tpu.rbpf`. For conditionally linear-Gaussian
state-space models

    u_t ~ f(. | u_{t-1})                      (nonlinear latent)
    x_t = A(u_t) x_{t-1} + b(u_t) + N(0, Q(u_t))
    y_t = C(u_t) x_t     + d(u_t) + N(0, R(u_t))

the linear substate x is marginalized exactly per particle: each particle
carries (u, m, P), the Kalman filtering moments of x given its u-history,
and its weight is the exact predictive likelihood N(y_t; C m_pred + d,
C P_pred C^T + R) (Doucet, de Freitas, Murphy, Russell, UAI 2000; Schon,
Gustafsson, Nordlund 2005). Only u is sampled.

The per-particle Kalman recursion is batched `[B, K]` products. The
innovation covariance is inverted in closed form for Do <= 3 and by an
exact 2x2-block Schur recursion on those closed forms for 4 <= Do <= 8
(`_psd_inverse_small`); above 8 it takes `distributions.cholesky`
(`cholesky_ex`, whose error flag stays on the device) and
`distributions.cho_solve`. None of these reads
the device, so a call can be captured in a CUDA graph. ESS-triggered
resampling mixes identity and resampled rows per batch row; the ancestors
come from the port's resampling router (on the card systematic runs K1
with indices only, stratified and multinomial run K4), and the regime,
mean and covariance gathers are `take_along_dim`.

Several ranks (``mesh``, or a distributed ``resampling_implementation``,
whose mesh is then used): every rank runs its block, the observations'
rows of its data shard and K / n particles of each; the draws are its
block of the single-device run's (`noise.ShardNoise`). The moments (m,
P) ride the distributed exchange beside u (`parallel.dist_resampling`;
K3 on the card for the default fused exchange), and log-Z, the ESS test
and the filtered means reduce over the particle group.
"""

from __future__ import annotations

import math as _stdmath
from typing import Optional

import torch

from . import distributions as dists
from . import inference as _inference
from . import resampling, state
from .noise import NoiseSource
from .sharding_utils import (cloud_of, particle_logsumexp,
                             particle_softmax)

__all__ = ["rbpf"]


def _sample_dist(distribution, batch_size, num_particles, noise):
    """`state.sample`, detached: the nonlinear latents may be discrete
    (categorical regimes, Bernoulli switches), and the filter is not
    differentiated through its u-samples."""
    with torch.no_grad():
        return state.sample(distribution, batch_size, num_particles, noise)


def _tag_mode(distribution, batch_size, num_particles):
    """Tags `[B, K, ...]`-batched component distributions FULLY_EXPANDED:
    inside the filter the leading axes are unambiguous, so the inference
    of the mode (and its warning) is not needed."""
    if isinstance(distribution, dict):
        return {k: _tag_mode(v, batch_size, num_particles)
                for k, v in distribution.items()}
    if getattr(distribution, "batch_shape_mode", None) is None:
        bs = tuple(distribution.batch_shape)
        if len(bs) >= 2 and bs[0] == batch_size and \
                bs[1] == num_particles:
            return state.set_batch_shape_mode(
                distribution, state.BatchShapeMode.FULLY_EXPANDED)
    return distribution


def _as_tensor(x, like):
    """``x`` as a float tensor on ``like``'s device (a number as a fill: a
    copy from the host could not be captured in a CUDA graph)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=like.device, dtype=like.dtype)
    return torch.full((), float(x), dtype=like.dtype, device=like.device)


def _bc(x, shape, like):
    return torch.broadcast_to(_as_tensor(x, like), shape)


def _mv(a, v):
    """Batched matrix @ vector over any leading dims."""
    return torch.einsum("...ij,...j->...i", a, v)


def _mm(a, b):
    return torch.einsum("...ij,...jk->...ik", a, b)


def _t(x):
    return x.transpose(-1, -2)


def _psd_inverse_small(s):
    """(log_det `[...]`, inverse `[..., Do, Do]`) of batched symmetric
    positive-definite matrices.

    Closed form for Do <= 3. For 4 <= Do <= 8 a recursion on symmetric
    2x2-block Schur complements, S = [[A, B], [B^T, D]] with A the leading
    h x h block, h = ceil(Do / 2): the inverses and log-determinants of A
    and of D - B^T A^-1 B come from the closed forms, so it is exact and
    made of batched products only. Above 8, `distributions.cholesky` and
    `distributions.cho_solve` (two triangular solves; a captured
    `torch.cholesky_solve` aborts the process). Nothing reads the
    device.
    """
    do = s.shape[-1]
    if 4 <= do <= 8:
        h = (do + 1) // 2
        a, b = s[..., :h, :h], s[..., :h, h:]
        d = s[..., h:, h:]
        log_det_a, inv_a = _psd_inverse_small(a)
        inv_a_b = _mm(inv_a, b)                              # [..,h,do-h]
        schur = d - _mm(_t(b), inv_a_b)
        schur = 0.5 * (schur + _t(schur))
        log_det_sc, inv_sc = _psd_inverse_small(schur)
        tr = -_mm(inv_a_b, inv_sc)                           # [..,h,do-h]
        tl = inv_a - _mm(tr, _t(inv_a_b))
        inv = torch.cat([torch.cat([tl, tr], dim=-1),
                         torch.cat([_t(tr), inv_sc], dim=-1)], dim=-2)
        return log_det_a + log_det_sc, inv
    if do == 1:
        det = s[..., 0, 0]
        return torch.log(det), (1.0 / det)[..., None, None]
    if do == 2:
        a, b = s[..., 0, 0], s[..., 0, 1]
        c, d = s[..., 1, 0], s[..., 1, 1]
        det = a * d - b * c
        inv = torch.stack([
            torch.stack([d, -b], dim=-1),
            torch.stack([-c, a], dim=-1)], dim=-2) / det[..., None, None]
        return torch.log(det), inv
    if do == 3:
        a, b, c = s[..., 0, 0], s[..., 0, 1], s[..., 0, 2]
        d, e, f = s[..., 1, 0], s[..., 1, 1], s[..., 1, 2]
        g, h, i = s[..., 2, 0], s[..., 2, 1], s[..., 2, 2]
        ca = e * i - f * h
        cb = -(d * i - f * g)
        cc = d * h - e * g
        det = a * ca + b * cb + c * cc
        adj = torch.stack([
            torch.stack([ca, -(b * i - c * h), b * f - c * e], dim=-1),
            torch.stack([cb, a * i - c * g, -(a * f - c * d)], dim=-1),
            torch.stack([cc, -(a * h - b * g), a * e - b * d], dim=-1)],
            dim=-2)
        return torch.log(det), adj / det[..., None, None]
    chol = dists.cholesky(s)
    log_det = 2.0 * torch.sum(
        torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1)
    eye = torch.eye(do, dtype=s.dtype, device=s.device).expand(s.shape)
    return log_det, dists.cho_solve(chol, eye)


def _gaussian_update(m_pred, p_pred, c, d, r, y):
    """One batched Kalman measurement update.

    m_pred [B,K,D], p_pred [B,K,D,D], c [B,K,Do,D], d [B,K,Do],
    r [B,K,Do,Do], y [B,Do] -> (log_lik [B,K], m [B,K,D], p [B,K,D,D]).
    """
    do = c.shape[-2]
    innovation = y[:, None, :] - (_mv(c, m_pred) + d)       # [B,K,Do]
    pc_t = _mm(p_pred, _t(c))                                # [B,K,D,Do]
    s = _mm(c, pc_t) + r                                     # [B,K,Do,Do]
    s = 0.5 * (s + _t(s))
    log_det, s_inv = _psd_inverse_small(s)
    solve = _mv(s_inv, innovation)                           # [B,K,Do]
    gain = _mm(pc_t, s_inv)                                  # [B,K,D,Do]
    log_lik = -0.5 * (log_det + torch.sum(innovation * solve, dim=-1) +
                      do * _stdmath.log(2.0 * _stdmath.pi))
    m = m_pred + _mv(gain, innovation)
    p = p_pred - _mm(gain, _t(pc_t))
    p = 0.5 * (p + _t(p))
    return log_lik, m, p


def _gather_particles(x, idx):
    """``x`` `[B, K, ...]` gathered along the particle axis by ``idx``
    `[B, K]`."""
    return torch.take_along_dim(
        x, idx.long().reshape(tuple(idx.shape) + (1,) * (x.ndim - 2)),
        dim=1)


def rbpf(observations, initial, transition, linear_initial,
         linear_dynamics, linear_emission, num_particles: int,
         noise: Optional[NoiseSource] = None, proposal=None,
         ess_threshold: float = 1.0,
         resampling_method: str = "systematic",
         resampling_implementation="auto",
         return_history: bool = False,
         mesh=None, data_axis: str = "data",
         particle_axis: str = "particle"):
    """Runs the Rao-Blackwellised particle filter.

    Args:
        observations: `[T, B, Do]` (or `[T, B]`, Do = 1) tensor, or a
            list of `[B, Do]` values.
        initial: `() -> Distribution` over u_0 (any distribution:
            categorical regimes too; no reparameterization needed).
        transition: `(previous_latents=[u_prev], time) -> Distribution`
            over u_t given `u_prev` `[B, K, ...]`.
        linear_initial: `(u0) -> (m0, P0)`, broadcastable to `[B, K, D]`
            and `[B, K, D, D]`.
        linear_dynamics: `(u, time) -> (A, b, Q)`, broadcastable to
            `[B, K, D, D]`, `[B, K, D]`, `[B, K, D, D]`.
        linear_emission: `(u, time) -> (C, d, R)`, broadcastable to
            `[B, K, Do, D]`, `[B, K, Do]`, `[B, K, Do, Do]`.
        num_particles: K.
        noise: the source of every draw; default `NoiseSource.seeded(0)`
            on the observations' device. t = 0 draws u_0; each later step
            draws the resampling noise, then u_t.
        proposal: optional u-proposal with the engine's proposal contract;
            the prior/proposal density correction is applied. None:
            bootstrap (propose from `initial` / `transition`).
        ess_threshold: resample a batch row when its ESS <= threshold * K.
            1.0 (the default) resamples every step, 0.0 never.
        resampling_method: 'systematic' | 'stratified' | 'multinomial'.
        resampling_implementation: 'auto' | 'torch' | 'cuda' (see
            `resampling`), or a callable resampler (a distributed one of
            `parallel.dist_resampling` runs the filter on its mesh, with
            or without ``mesh``); every row goes through the resampling
            launch at every step, so the noise drawn does not depend on
            the weights.
        return_history: also return the per-step particles and moments.
        mesh, data_axis, particle_axis: a `DeviceMesh` and its axis
            names: this rank runs its block (module docstring): the
            observations are this rank's rows, ``num_particles`` the
            whole cloud's K, and the outputs this rank's blocks (the
            filtered means `[T, B_l, D]`, the same on every particle
            rank).

    Returns:
        dict: log_marginal_likelihood `[B]`, nonlinear_latents u_T `[B, K,
        ...]`, linear_means / linear_covs `[B, K, D]` / `[B, K, D, D]`,
        log_weight `[B, K]`, filtered_means `[T, B, D]` (the weighted
        particle means); with ``return_history``
        nonlinear_latents_history `[T, B, K, ...]`, linear_means_history
        `[T, B, K, D]` and log_weights_history `[T, B, K]`.
    """
    if num_particles < 1:
        raise ValueError(
            f"num_particles must be >= 1. currently = {num_particles}")
    if not 0.0 <= float(ess_threshold) <= 1.0:
        raise ValueError(
            f"ess_threshold must be in [0, 1]. "
            f"currently = {ess_threshold}")
    obs_arr = _inference._first_leaf(
        _inference.stack_observations(observations))
    if obs_arr.ndim == 2:
        obs_arr = obs_arr[..., None]
    if obs_arr.ndim != 3:
        raise ValueError(
            f"rbpf observations must be [T, B, Do] or [T, B]. "
            f"got shape {tuple(obs_arr.shape)}")
    num_timesteps, batch_size, obs_dim = obs_arr.shape
    obs_seq = _inference.ObservationSequence(obs_arr)
    if noise is None:
        noise = NoiseSource.seeded(0, obs_arr.device)
    cloud = cloud_of(mesh, resampling_implementation, data_axis,
                     particle_axis)
    total_particles = num_particles
    log_k = _stdmath.log(total_particles)
    if cloud is None:
        implementation = resampling.resolve_implementation(
            obs_arr.device, resampling_method, resampling_implementation)
    else:
        num_particles = cloud.local_particles(total_particles)
        implementation = _inference._resolve_implementation(
            obs_arr.device, resampling_method, resampling_implementation,
            cloud)
        noise = cloud.noise(noise)
    k_shape = (batch_size, num_particles)
    like = obs_arr if obs_arr.is_floating_point() else obs_arr.float()

    def propose(dist_prior, dist_q):
        """u from q (or the prior), and the log density correction."""
        dist_prior = _tag_mode(dist_prior, batch_size, num_particles)
        if dist_q is None:
            u = _sample_dist(dist_prior, batch_size, num_particles, noise)
            return u, torch.zeros(k_shape, dtype=like.dtype,
                                  device=like.device)
        dist_q = _tag_mode(dist_q, batch_size, num_particles)
        u = _sample_dist(dist_q, batch_size, num_particles, noise)
        return u, (state.log_prob(dist_prior, u) -
                   state.log_prob(dist_q, u))

    def emission_terms(u, time):
        c, d, r = linear_emission(u, time)
        return (_bc(c, k_shape + (obs_dim, lin_dim), like),
                _bc(d, k_shape + (obs_dim,), like),
                _bc(r, k_shape + (obs_dim, obs_dim), like))

    # ---- t = 0.
    u, correction = propose(
        initial(),
        proposal(time=0, observations=obs_seq) if proposal else None)
    m0, p0 = linear_initial(u)
    lin_dim = _as_tensor(m0, like).shape[-1]
    m = _bc(m0, k_shape + (lin_dim,), like)
    p = _bc(p0, k_shape + (lin_dim, lin_dim), like)
    inc, m, p = _gaussian_update(m, p, *emission_terms(u, 0), obs_arr[0])
    log_w = inc + correction                                 # [B, K]
    def lse(x):
        return particle_logsumexp(x, cloud)

    def filtered_mean(log_w, m):
        local = torch.einsum("bk,bkd->bd", particle_softmax(log_w, cloud),
                             m)
        return local if cloud is None else cloud.particle_sum(local)

    def resample(log_w, u, m, p):
        """(u, m, p) at the step's ancestors `[B, K]`."""
        if not callable(implementation):
            idx = resampling.sample_indices(
                log_w, noise, resampling_method, implementation).long()
            return (state.tree_map(lambda x: _gather_particles(x, idx), u),
                    _gather_particles(m, idx), _gather_particles(p, idx))
        # A callable: the moments ride the exchange as leaves.
        _, out = resampling.callable_resample(
            implementation, log_w.detach(), noise,
            {"u": u, "m": m, "p": p}, lse(log_w).detach())
        return out["u"], out["m"], out["p"]

    log_z = lse(log_w) - log_k                               # [B]
    fmeans = [filtered_mean(log_w, m)]
    history = [(u, m, log_w)]

    for t in range(1, num_timesteps):
        # ---- per-row adaptive resampling (identity rows mix in).
        ess = torch.exp(2.0 * lse(log_w) - lse(2.0 * log_w))  # [B]
        do_res = ess <= ess_threshold * total_particles
        u_s, m_s, p_s = resample(log_w, u, m, p)
        u_r = _inference._where_rows(do_res, u_s, u)
        m_r = _inference._where_rows(do_res, m_s, m)
        p_r = _inference._where_rows(do_res, p_s, p)
        log_w = torch.where(do_res[:, None], torch.zeros_like(log_w), log_w)

        # ---- propose u_t; Kalman predict and update.
        time = _inference.TimeIndex(t)
        prior_dist = transition(previous_latents=[u_r], time=time)
        q_dist = (proposal(previous_latents=[u_r], time=time,
                           observations=obs_seq) if proposal else None)
        u, correction = propose(prior_dist, q_dist)
        a, b, q = linear_dynamics(u, time)
        a = _bc(a, k_shape + (lin_dim, lin_dim), like)
        b = _bc(b, k_shape + (lin_dim,), like)
        q = _bc(q, k_shape + (lin_dim, lin_dim), like)
        m_pred = _mv(a, m_r) + b
        p_pred = _mm(_mm(a, p_r), _t(a)) + q
        inc, m, p = _gaussian_update(m_pred, p_pred,
                                     *emission_terms(u, time), obs_arr[t])
        new_log_w = log_w + inc + correction
        log_z = log_z + (lse(new_log_w) - lse(log_w))
        log_w = new_log_w
        fmeans.append(filtered_mean(log_w, m))
        if return_history:
            history.append((u, m, log_w))

    out = {
        "log_marginal_likelihood": log_z,
        "nonlinear_latents": u,
        "linear_means": m,
        "linear_covs": p,
        "log_weight": log_w,
        "filtered_means": torch.stack(fmeans, dim=0),
    }
    if return_history:
        out["nonlinear_latents_history"] = _inference._stack_time(
            [h[0] for h in history])
        out["linear_means_history"] = torch.stack([h[1] for h in history])
        out["log_weights_history"] = torch.stack([h[2] for h in history])
    return out
