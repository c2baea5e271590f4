"""SMC samplers for static targets: annealed resample-move and waste-free.

Counterpart of `aesmc_tpu.samplers` (Del Moral, Doucet & Jasra 2006; Neal
2001): a particle cloud is carried from a prior p0 to the target
pi(x) ∝ p0(x) exp(L(x)) along pi_b ∝ p0 exp(b L), b: 0 -> 1. Each rung
reweights by (b' - b) L(x), resamples and rejuvenates with random-walk
Metropolis sweeps targeting pi_b'; the product of the rung normalizers is
an unbiased estimate of Z = ∫ p0 exp(L). The ladder is either given
(``betas``) or chosen on the fly by bisecting each increment so that the
incremental ESS hits ``ess_target`` K (40 bisection steps on the device,
no read inside). ``waste_free_chains=M`` switches each rung to waste-free
SMC (Dau & Chopin 2022): M chain roots, each run for K/M - 1 states, all
kept as particles.

`log_prior` and `log_likelihood` take ONE particle and return a scalar, as
in the JAX package; they run under `torch.func.vmap` over the cloud, so
they must be pure tensor functions (no `bool()` or `.item()` on values).
Particles are a `[K, ...]` tensor or a dict of them.

Resampling: a resample-move rung makes one call of the shared resampler
on the `[1, K]` weights (on the card one K1 launch, indices only); a
waste-free rung searches its M root positions in the K-weight CDF
(`resampling._normalized_cumsum`, monotone with its last entry pinned),
on the card with K4 (`ops.searchsorted_sorted_cuda`, Kp = M; the
multinomial positions are unsorted, which K4 takes), else with
`torch.searchsorted`.

Host reads: the fixed ladder reads nothing from the device, so a call can
be captured in a CUDA graph. The adaptive ladder reads ``beta < 1`` once a
rung (its loop's exit test, the one intended read).

Draws, in order, per rung: the resampling noise (resample-move: the
method's noise on one row; waste-free: one uniform `()` for systematic,
`[M]` uniforms for stratified and multinomial), then per Metropolis sweep
one normal like each particle leaf (dicts in sorted key order) and one
uniform a chain (`[K]`, or `[M]` in waste-free mode).
"""

from __future__ import annotations

import math as _stdmath
from typing import Optional

import numpy as np
import torch

from . import device as _device
from . import resampling
from .noise import NoiseSource
from .ops import searchsorted_sorted_cuda
from .utils.pytree import rebuild, sorted_leaves

__all__ = ["smc_sampler"]

# Bisection steps of the adaptive increment (the JAX package's
# `fori_loop(0, 40, ...)`).
_BISECTION_STEPS = 40


def _ess_from_logw(log_w):
    return torch.exp(2.0 * torch.logsumexp(log_w, dim=-1) -
                     torch.logsumexp(2.0 * log_w, dim=-1))


def _take(tree, idx):
    return rebuild(tree, [torch.index_select(x, 0, idx)
                          for x in sorted_leaves(tree)])


def smc_sampler(log_prior, log_likelihood, initial_particles,
                noise: Optional[NoiseSource] = None, num_moves: int = 3,
                step_size=0.5, ess_target: float = 0.5, max_steps: int = 64,
                betas=None, resampling_method: str = "systematic",
                resampling_implementation="auto", waste_free_chains=None,
                return_history: bool = False, device=None):
    """Annealed SMC from `p0` to `p0 * exp(log_likelihood)`.

    Args:
        log_prior: `one_particle -> scalar` log p0 (normalized, where the
            evidence estimate matters).
        log_likelihood: `one_particle -> scalar` tempered term L(x). Both
            run under `torch.func.vmap` over the cloud.
        initial_particles: a `[K, ...]` tensor or a dict of them, iid draws
            from p0. Tensors stay on their device; numpy arrays go to
            ``device`` (default: the card; raises without one).
        noise: the source of every draw (order in the module docstring);
            default `NoiseSource.seeded(0)` on the particles' device.
        num_moves: random-walk Metropolis sweeps per rung (the thinning
            between collected states in waste-free mode, >= 1 there).
        step_size: the random walk's scale: a number, or a dict matching
            one particle.
        ess_target: each adaptive increment is bisected so that the
            incremental ESS is `ess_target * K` (0 < target < 1).
        max_steps: bound on the adaptive rungs; the last permitted rung
            jumps to b = 1 (`reached_final` False then).
        betas: optional explicit increasing ladder ending at 1.0 (a
            sequence of numbers or a float32 tensor); overrides the
            adaptive schedule.
        resampling_method: 'systematic', 'stratified' or 'multinomial'.
        resampling_implementation: 'auto' (the kernels for CUDA
            tensors), 'cuda' or 'torch'. A callable (distributed)
            implementation is slice E of the port and raises
            NotImplementedError.
        waste_free_chains: M (dividing K, 1 <= M < K), or None for
            classic resample-move.
        return_history: also return the per-rung beta/ESS/acceptance
            paths (NaN-padded to `max_steps` in adaptive mode).
        device: where numpy particles go.

    Returns:
        dict: particles `[K, ...]`, log_normalizer (0-d), num_steps (0-d
        int32), acceptance_rate (0-d), reached_final (0-d bool), and with
        `return_history` beta_history, ess_history, acceptance_history.
    """
    if callable(resampling_implementation):
        raise NotImplementedError(
            "smc_sampler's distributed (callable) resampling_implementation "
            "is not ported yet: multi-device is slice E of the port")
    if not 0.0 < float(ess_target) < 1.0:
        raise ValueError(
            f"ess_target must be in (0, 1). currently = {ess_target}")
    if num_moves < 0:
        raise ValueError(
            f"num_moves must be >= 0. currently = {num_moves}")

    def as_tensor(x):
        if isinstance(x, torch.Tensor):
            return x
        return torch.as_tensor(np.asarray(x, dtype=np.float32),
                               device=_device.resolve(device))

    particles = rebuild(initial_particles, [
        as_tensor(x) for x in sorted_leaves(initial_particles)])
    first = sorted_leaves(particles)[0]
    dev = first.device
    num_particles = int(first.shape[0])
    log_k = _stdmath.log(num_particles)
    m = None
    if waste_free_chains is not None:
        m = int(waste_free_chains)
        if not 1 <= m < num_particles:
            raise ValueError(
                "waste_free_chains must satisfy 1 <= M < K. "
                f"currently = {m} (K = {num_particles})")
        if num_particles % m != 0:
            raise ValueError(
                "waste_free_chains must divide the particle count: "
                f"K = {num_particles}, M = {m}")
        if num_moves < 1:
            raise ValueError(
                "waste-free mode needs num_moves >= 1 (the thinning "
                f"between collected chain states). currently = "
                f"{num_moves}")
        chain_len = num_particles // m
    if noise is None:
        noise = NoiseSource.seeded(0, dev)
    implementation = resampling.resolve_implementation(
        dev, resampling_method, resampling_implementation)
    v_log_lik = torch.func.vmap(log_likelihood)
    num_leaves = len(sorted_leaves(particles))
    steps = ([step_size] * num_leaves if isinstance(step_size, (int, float))
             else sorted_leaves(step_size))

    def next_beta(beta, loglik):
        """Largest b in (beta, 1] with ESS((b - beta) loglik) >= ess_target
        K, by bisection (the ESS is nonincreasing in b)."""
        target = ess_target * num_particles

        def ess_at(b):
            return _ess_from_logw((b - beta) * loglik)

        lo, hi = beta, torch.ones_like(beta)
        for _ in range(_BISECTION_STEPS):
            mid = 0.5 * (lo + hi)
            ok = ess_at(mid) >= target
            lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
        one = torch.ones_like(beta)
        return torch.where(ess_at(one) >= target, one, lo)

    def sweep(particles, logp, accepted, target_logp):
        """One vectorized random-walk Metropolis sweep over a cloud of any
        leading size (K, or M chains in waste-free mode)."""
        leaves = sorted_leaves(particles)
        prop = rebuild(particles, [x + s * noise.normal(tuple(x.shape))
                                   for x, s in zip(leaves, steps)])
        prop_logp = target_logp(prop)
        u = noise.uniform(tuple(logp.shape))
        acc = torch.log(u) < prop_logp - logp
        particles = rebuild(particles, [
            torch.where(acc.reshape(tuple(acc.shape) + (1,) * (a.ndim - 1)),
                        a, b)
            for a, b in zip(sorted_leaves(prop), leaves)])
        logp = torch.where(acc, prop_logp, logp)
        accepted = accepted + torch.mean(acc.to(torch.float32))
        return particles, logp, accepted

    def target_at(beta):
        # One vmap over both densities: the same arithmetic as two, at
        # half the host cost of a sweep.
        return torch.func.vmap(lambda p: log_prior(p) +
                               beta * log_likelihood(p))

    def move(particles, beta):
        """num_moves sweeps targeting p0 exp(beta L)."""
        accepted = torch.zeros((), dtype=torch.float32, device=dev)
        if num_moves == 0:
            return particles, accepted
        target_logp = target_at(beta)
        logp = target_logp(particles)
        for _ in range(num_moves):
            particles, logp, accepted = sweep(particles, logp, accepted,
                                              target_logp)
        return particles, accepted / num_moves

    def waste_free_positions(dtype):
        """M inverse-CDF query positions over the K-weight CDF."""
        grid = torch.arange(m, dtype=dtype, device=dev)
        if resampling_method == "systematic":
            return (noise.uniform(()) + grid) / m
        if resampling_method == "stratified":
            return (noise.uniform((m,)) + grid) / m
        return noise.uniform((m,))

    search = (searchsorted_sorted_cuda.searchsorted_sorted
              if implementation == "cuda" else
              searchsorted_sorted_cuda.searchsorted_sorted_torch)

    def root_indices(log_w, pos):
        cdf = resampling._normalized_cumsum(log_w[None])
        return search(cdf, pos[None].contiguous())[0].long()

    def waste_free_move(roots, beta):
        """Chains of length P from the M roots, every state collected, with
        num_moves sweeps between consecutive collected states."""
        target_logp = target_at(beta)
        logp = target_logp(roots)
        accepted = torch.zeros((), dtype=torch.float32, device=dev)
        states, current = [roots], roots
        for _ in range(chain_len - 1):
            for _ in range(num_moves):
                current, logp, accepted = sweep(current, logp, accepted,
                                                target_logp)
            states.append(current)
        cloud = rebuild(roots, [
            torch.stack(col, dim=0).reshape((num_particles,) +
                                            tuple(col[0].shape[1:]))
            for col in zip(*[sorted_leaves(s) for s in states])])
        return cloud, accepted / ((chain_len - 1) * num_moves)

    def rung(particles, delta, new_beta, log_z, loglik):
        """One rung from b to ``new_beta`` = b + ``delta``."""
        log_w = delta * loglik
        log_z = log_z + torch.logsumexp(log_w, dim=0) - log_k
        ess = _ess_from_logw(log_w)
        if m is None:
            idx = resampling.sample_indices(
                log_w[None], noise, resampling_method,
                implementation)[0].long()
            particles, acc = move(_take(particles, idx), new_beta)
        else:
            pos = waste_free_positions(log_w.dtype)
            roots = _take(particles, root_indices(log_w, pos))
            particles, acc = waste_free_move(roots, new_beta)
        return particles, log_z, ess, acc

    zero = torch.zeros((), dtype=torch.float32, device=dev)
    if betas is not None:
        # Float32 rungs, as the JAX package holds them: a tensor's entries
        # stay on its device; numbers become float32 Python floats, whose
        # differences are float32 differences (no copy from the host).
        if isinstance(betas, torch.Tensor):
            ladder = list(betas.to(torch.float32))
        else:
            ladder = [float(b) for b in np.asarray(betas, np.float32)]
        beta, log_z = 0.0, zero
        ess_h, acc_h = [], []
        for new_beta in ladder:
            loglik = v_log_lik(particles)
            delta = (float(np.float32(new_beta) - np.float32(beta))
                     if isinstance(new_beta, float) else new_beta - beta)
            particles, log_z, ess, acc = rung(particles, delta, new_beta,
                                              log_z, loglik)
            beta = new_beta
            ess_h.append(ess)
            acc_h.append(acc)
        acc_h = torch.stack(acc_h)
        out = {
            "particles": particles,
            "log_normalizer": log_z,
            "num_steps": torch.full((), len(ladder), dtype=torch.int32,
                                    device=dev),
            "acceptance_rate": torch.mean(acc_h),
            "reached_final": torch.ones((), dtype=torch.bool, device=dev),
        }
        if return_history:
            out["beta_history"] = torch.stack([
                b if isinstance(b, torch.Tensor) else
                torch.full((), b, dtype=torch.float32, device=dev)
                for b in ladder])
            out["ess_history"] = torch.stack(ess_h)
            out["acceptance_history"] = acc_h
        return out

    # ---- the adaptive ladder: one host read a rung (`beta < 1`).
    beta, log_z = zero, zero
    forced = torch.zeros((), dtype=torch.bool, device=dev)
    b_h, e_h, a_h = (torch.full((max_steps,), float("nan"), device=dev)
                     for _ in range(3))
    step = 0
    while step < max_steps and bool(beta < 1.0):
        loglik = v_log_lik(particles)
        new_beta = next_beta(beta, loglik)
        if step == max_steps - 1:
            # The last permitted rung jumps straight to 1 (log Z stays
            # unbiased: a higher-variance final increment).
            force = new_beta < 1.0
            new_beta = torch.where(force, torch.ones_like(new_beta),
                                   new_beta)
            forced = forced | force
        particles, log_z, ess, acc = rung(particles, new_beta - beta,
                                          new_beta, log_z, loglik)
        b_h[step], e_h[step], a_h[step] = new_beta, ess, acc
        beta = new_beta
        step += 1
    taken = torch.isfinite(a_h)
    out = {
        "particles": particles,
        "log_normalizer": log_z,
        "num_steps": torch.full((), step, dtype=torch.int32, device=dev),
        "acceptance_rate": (torch.nansum(a_h) /
                            torch.clamp(taken.sum(), min=1)),
        "reached_final": ~forced,
    }
    if return_history:
        out["beta_history"] = b_h
        out["ess_history"] = e_h
        out["acceptance_history"] = a_h
    return out
