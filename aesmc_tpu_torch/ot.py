"""Differentiable resampling by entropy-regularized optimal transport.

Counterpart of `aesmc_tpu.ot` (Corenflos, Thornton, Deligiannidis and
Doucet, ICML 2021): instead of drawing discrete ancestors, whose gradient
is zero almost everywhere, the weighted particle cloud is transported onto
a uniformly weighted one,

    x_tilde_j = K * sum_i P_ij x_i,

where P solves the entropic OT problem between the weighted empirical
measure and the uniform one on the same support. The result is
differentiable in the weights and in the particles.

Sinkhorn runs in the log domain on the squared-Euclidean cost, in two
forms behind `ot_resample`:

- dense: the `[B, K, K]` cost at once, for K <= `OT_DENSE_MAX_K`;
- blocked (`ot_resample_blocked`, or K above it): the cost in `[B, K,
  block]` tiles, one batched matmul each, with online logsumexp
  accumulators. Each tile is recomputed in the backward pass
  (`torch.utils.checkpoint` a block, where the JAX package wraps its scan
  body in `jax.checkpoint`), and so is each Sinkhorn iteration, so the
  backward keeps O(K * block) memory.

When a gradient is recorded the dense form checkpoints each iteration as
well, and the whole transport once more around them: a time step then
keeps its inputs and the iterations' potentials, not the `[B, K, K]`
tiles of every iteration of every step.

`lowrank_ot_resample` is the subquadratic form (Scetbon, Cuturi and Peyre,
ICML 2021): a rank-r plan from mirror descent with Bregman projections,
O(K r D) an iteration. Its symmetry-breaking jitter is two standard-normal
draws of `[B, K, r]` from the `NoiseSource`, in this order: the source
anchors' (Q), then the target anchors' (R); the JAX package draws them
from `split(key)`. With ``group=`` (a particle axis sharded over ranks)
each rank holds its rows of Q and R and every sum over K is all-reduced:
O(B r (D + 2)) floats a rank an iteration, no O(K) exchange.

`distributed_ot_resample` is the Sinkhorn over a particle axis sharded
across ranks: the blocked form's source blocks are the other ranks'
particle slices, pulled one rank along the ring (`parallel.collectives.
ring_shift`, differentiable) n times an update, so a rank does O(K_l K)
cost work and holds O(K_l^2) tiles; the cost scale and the normalization
come from all-reduces over the particle group, and each Sinkhorn
iteration is recomputed in the backward pass, which keeps O(iterations
K_l) potentials.

The products are torch ops (the JAX package computes them with XLA, not
in a Pallas kernel).
"""

from __future__ import annotations

import math as _stdmath
import warnings
from typing import Tuple

import torch
from torch.utils import checkpoint as _checkpoint

from . import resampling
from .noise import NoiseSource

__all__ = ["OT_DENSE_MAX_K", "sinkhorn_potentials", "ot_resample",
           "ot_resample_blocked", "lowrank_ot_resample",
           "distributed_ot_resample"]

OT_DENSE_MAX_K = 4096


def _flatten_particles(value):
    """A `[B, K, ...]` tensor or dict of them -> (`[B, K, D]` matrix of
    every leaf's columns side by side, rebuild function)."""
    leaves = resampling._leaves(value)
    shapes = [tuple(leaf.shape) for leaf in leaves]
    mats = [leaf.reshape(leaf.shape[0], leaf.shape[1], -1)
            for leaf in leaves]
    stacked = mats[0] if len(mats) == 1 else torch.cat(mats, dim=-1)

    def rebuild(mat):
        out, start = [], 0
        for shape in shapes:
            width = _stdmath.prod(shape[2:])
            out.append(mat[:, :, start:start + width].reshape(
                (mat.shape[0], mat.shape[1]) + shape[2:]))
            start += width
        return resampling._unflatten(value, iter(out))

    return stacked, rebuild


def _recording_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _maybe_checkpoint(fn, *args, recompute=False):
    """``fn(*args)``, recomputed in the backward pass when ``recompute``."""
    if recompute:
        return _checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                      preserve_rng_state=False)
    return fn(*args)


def _log_marginals(log_weight, group=None):
    """(log a, log b): the normalized source weights and the uniform
    target weights, `[B, K]` each; this rank's `[B, K_l]` blocks of the
    whole cloud's over the particle group ``group``."""
    if group is None:
        log_a = torch.log_softmax(log_weight, dim=-1)
        log_b = torch.full_like(log_a, -_stdmath.log(log_a.shape[-1]))
        return log_a, log_b
    from . import math as amath
    from .parallel import collectives
    k_global = log_weight.shape[1] * collectives.size(group)
    log_a = log_weight - amath.distributed_logsumexp(
        log_weight, group, dim=1)[:, None]
    return log_a, torch.full_like(log_a, -_stdmath.log(k_global))


def _sinkhorn_iteration(f, g, cost, log_a, log_b, epsilon):
    f = epsilon * log_a - epsilon * torch.logsumexp(
        (g[:, None, :] - cost) / epsilon, dim=2)
    g = epsilon * log_b - epsilon * torch.logsumexp(
        (f[:, :, None] - cost) / epsilon, dim=1)
    return f, g


def sinkhorn_potentials(log_weight, cost, epsilon: float,
                        num_iterations: int):
    """Log-domain Sinkhorn between the masses a = softmax(log_weight)
    (rows) and the uniform b (columns) for a batched cost `[B, K, K]`.

    Returns (f `[B, K]`, g `[B, K]`) such that log P_ij = (f_i + g_j -
    C_ij) / epsilon has the marginals (a, b). Each iteration is
    recomputed in the backward pass when a gradient is recorded.
    """
    log_a, log_b = _log_marginals(log_weight)
    recompute = _recording_grad(log_weight, cost)
    f = torch.zeros_like(log_a)
    g = torch.zeros_like(log_a)
    for _ in range(num_iterations):
        f, g = _maybe_checkpoint(_sinkhorn_iteration, f, g, cost, log_a,
                                 log_b, epsilon, recompute=recompute)
    return f, g


def _blocked_cost(x, xb, sq, sqb, inv_scale):
    """The squared-Euclidean cost tile `[B, K, bs]` against the source
    block ``xb`` `[B, bs, D]`, one batched matmul."""
    c = (sq[:, :, None] + sqb[:, None, :] -
         2.0 * torch.bmm(x, xb.transpose(1, 2)))
    return torch.clamp(c, min=0.0) * inv_scale


def _lse_block(m, s, x, xb, sq, sqb, phib, inv_scale, epsilon):
    """One source block of `_blocked_smoothed_lse`: the online (max, sum)
    accumulator over the block's `[B, K, bs]` tile."""
    v = (phib[:, None, :] - _blocked_cost(x, xb, sq, sqb, inv_scale)) / \
        epsilon
    new_m = torch.maximum(m, v.amax(dim=2))
    s = s * torch.exp(m - new_m) + torch.exp(v - new_m[:, :, None]).sum(
        dim=2)
    return new_m, s


def _blocked_smoothed_lse(phi, x, sq, inv_scale, epsilon, block_size,
                          recompute):
    """lse over sources s of (phi_s - C(q, s)) / epsilon for every query q,
    streaming the sources in blocks with an online (max, sum)
    accumulator. phi, sq: `[B, K]`; x: `[B, K, D]`. Returns `[B, K]`."""
    batch, k, _ = x.shape
    m = torch.full((batch, k), float("-inf"), dtype=x.dtype,
                   device=x.device)
    s = torch.zeros((batch, k), dtype=x.dtype, device=x.device)
    for start in range(0, k, block_size):
        block = slice(start, start + block_size)
        m, s = _maybe_checkpoint(
            _lse_block, m, s, x, x[:, block], sq, sq[:, block],
            phi[:, block], inv_scale, epsilon, recompute=recompute)
    return m + torch.log(s)


def _transport_block(acc, x, xb, sq, sqb, fb, g, inv_scale, epsilon):
    c = _blocked_cost(x, xb, sq, sqb, inv_scale)             # [B, Kq, bs]
    p = torch.exp((fb[:, None, :] + g[:, :, None] - c) / epsilon)
    return acc + torch.bmm(p, xb)


def _blocked_transport(f, g, x, sq, inv_scale, epsilon, block_size,
                       recompute):
    """x_tilde_j = K * sum_i exp((f_i + g_j - C_ij) / eps) x_i, streaming
    the sources i in blocks. Converged plan entries are <= ~1/K, so the
    exp accumulates stably in float32 without a shift."""
    batch, k, d = x.shape
    acc = torch.zeros((batch, k, d), dtype=x.dtype, device=x.device)
    for start in range(0, k, block_size):
        block = slice(start, start + block_size)
        acc = _maybe_checkpoint(
            _transport_block, acc, x, x[:, block], sq, sq[:, block],
            f[:, block], g, inv_scale, epsilon, recompute=recompute)
    return k * acc


def _inverse_mean_cost(x, sq, scale_cost, group=None):
    """1 / the per-row mean of the squared-Euclidean cost, `[B, 1, 1]`, in
    O(K D): mean_ij C_ij = 2 mean(sq) - 2 ||mean x||^2 (ones without
    ``scale_cost``). With ``group``, the means of the whole cloud from
    all-reduced sums over the particle group."""
    if not scale_cost:
        return torch.ones((x.shape[0], 1, 1), dtype=x.dtype, device=x.device)
    if group is None:
        xbar = x.mean(dim=1)                                 # [B, D]
        mean_sq = sq.mean(dim=1)
    else:
        from .parallel import collectives
        k_global = x.shape[1] * collectives.size(group)
        xbar = collectives.all_reduce(x.sum(dim=1), group) / k_global
        mean_sq = collectives.all_reduce(sq.sum(dim=1), group) / k_global
    mean_cost = 2.0 * mean_sq - 2.0 * (xbar * xbar).sum(dim=1)
    return 1.0 / (mean_cost[:, None, None] + 1e-12)


def _blocked_iteration(f, g, x, sq, inv_scale, log_a, log_b, epsilon,
                       block_size, recompute):
    f = epsilon * log_a - epsilon * _blocked_smoothed_lse(
        g, x, sq, inv_scale, epsilon, block_size, recompute)
    g = epsilon * log_b - epsilon * _blocked_smoothed_lse(
        f, x, sq, inv_scale, epsilon, block_size, recompute)
    return f, g


def ot_resample_blocked(log_weight, value, epsilon: float = 0.5,
                        num_iterations: int = 50, scale_cost: bool = True,
                        block_size: int = 256) -> Tuple:
    """`ot_resample` without the `[B, K, K]` matrices: O(K * block_size)
    live memory in the forward and the backward pass. The same updates as
    the dense form with a streaming logsumexp, so it matches it to float
    rounding. K must be a multiple of ``block_size``."""
    x, rebuild = _flatten_particles(value)                   # [B, K, D]
    k = x.shape[1]
    if k % block_size != 0:
        raise ValueError(
            f"K = {k} must be a multiple of block_size = {block_size}")
    recompute = _recording_grad(log_weight, x)
    sq = (x * x).sum(dim=-1)                                 # [B, K]
    inv_scale = _inverse_mean_cost(x, sq, scale_cost)
    log_a, log_b = _log_marginals(log_weight)
    f = torch.zeros_like(log_a)
    g = torch.zeros_like(log_a)
    for _ in range(num_iterations):
        # Each iteration recomputed in the backward pass: only the
        # potentials are kept a step.
        f, g = _maybe_checkpoint(
            _blocked_iteration, f, g, x, sq, inv_scale, log_a, log_b,
            epsilon, block_size, recompute, recompute=recompute)
    transported = _blocked_transport(f, g, x, sq, inv_scale, epsilon,
                                     block_size, recompute)
    return rebuild(transported), torch.zeros_like(log_weight)


def _auto_block_size(k: int) -> int:
    """The largest divisor of K up to 2,048 (the JAX package's sweep on
    its TPU: 512, 1,024, 2,048 and 4,096 at K = 16,384), with a warning
    below 256."""
    block_size = max(d for d in range(1, min(2048, k) + 1) if k % d == 0)
    if block_size < 256:
        warnings.warn(
            f"ot_resample: K={k} has no divisor in [256, 2048] - auto "
            f"block_size degraded to {block_size}, turning the blocked "
            f"Sinkhorn scan into ~{k // block_size} sequential steps. Pad "
            f"K to a multiple of 2048 (with -inf log-weights on the "
            f"padding) or pass an explicit block_size.",
            RuntimeWarning, stacklevel=3)
    return block_size


def _dense_transport(log_weight, x, epsilon, num_iterations, scale_cost):
    sq = (x * x).sum(dim=-1)                                 # [B, K]
    cost = (sq[:, :, None] + sq[:, None, :] -
            2.0 * torch.bmm(x, x.transpose(1, 2)))
    cost = torch.clamp(cost, min=0.0)
    if scale_cost:
        cost = cost / (cost.mean(dim=(1, 2), keepdim=True) + 1e-12)
    f, g = sinkhorn_potentials(log_weight, cost, epsilon, num_iterations)
    log_plan = (f[:, :, None] + g[:, None, :] - cost) / epsilon
    # x_tilde_j = K * sum_i P_ij x_i (columns sum to 1/K).
    return x.shape[1] * torch.bmm(torch.exp(log_plan).transpose(1, 2), x)


def ot_resample(log_weight, value, epsilon: float = 0.5,
                num_iterations: int = 50, scale_cost: bool = True,
                block_size=None) -> Tuple:
    """Transports weighted particles onto a uniform ensemble.

    Args:
        log_weight: `[B, K]` unnormalized log-weights (differentiable).
        value: a `[B, K, ...]` tensor or a dict of them.
        epsilon: entropic regularization (relative to the mean cost when
            ``scale_cost``).
        num_iterations: Sinkhorn iterations.
        scale_cost: divide the cost by its per-row mean, so that epsilon
            is scale-free.
        block_size: None picks the form (dense for K <= `OT_DENSE_MAX_K`,
            blocked above with the largest divisor of K up to 2,048); an
            int forces the blocked form with that tile width.

    Returns:
        (transported value `[B, K, ...]`, new log-weights `[B, K]`: zeros).
    """
    if block_size is None:
        k = resampling._leaves(value)[0].shape[1]
        if k > OT_DENSE_MAX_K:
            block_size = _auto_block_size(k)
    if block_size is not None:
        return ot_resample_blocked(
            log_weight, value, epsilon=epsilon,
            num_iterations=num_iterations, scale_cost=scale_cost,
            block_size=block_size)
    x, rebuild = _flatten_particles(value)                   # [B, K, D]
    transported = _maybe_checkpoint(
        _dense_transport, log_weight, x, epsilon, num_iterations,
        scale_cost, recompute=_recording_grad(log_weight, x))
    return rebuild(transported), torch.zeros_like(log_weight)


def _ring_smoothed_lse(phi, x, sq, inv_scale, epsilon, group):
    """lse over the GLOBAL sources s of (phi_s - C(q, s)) / epsilon for this
    rank's queries q: the source slices (x, sq, phi) visit in ring order,
    starting with this rank's own, into an online (max, sum)
    accumulator. Every rank applies the same order, so the result is
    reproducible; it differs from one device's by float association."""
    from .parallel import collectives

    n = collectives.size(group)
    batch, k_local = phi.shape
    m = torch.full((batch, k_local), float("-inf"), dtype=x.dtype,
                   device=x.device)
    s = torch.zeros((batch, k_local), dtype=x.dtype, device=x.device)
    xv, sqv, phiv = x, sq, phi
    for step in range(n):
        m, s = _lse_block(m, s, x, xv, sq, sqv, phiv, inv_scale, epsilon)
        if step < n - 1:
            xv, sqv, phiv = collectives.ring_shift([xv, sqv, phiv], group)
    return m + torch.log(s)


def _ring_transport(f, g, x, sq, inv_scale, epsilon, group, k_global):
    """x_tilde_j = K sum_i P_ij x_i with the sources i visiting around the
    ring; j runs over this rank's queries."""
    from .parallel import collectives

    n = collectives.size(group)
    acc = torch.zeros_like(x)
    xv, sqv, fv = x, sq, f
    for step in range(n):
        acc = _transport_block(acc, x, xv, sq, sqv, fv, g, inv_scale,
                               epsilon)
        if step < n - 1:
            xv, sqv, fv = collectives.ring_shift([xv, sqv, fv], group)
    return k_global * acc


def _ring_iteration(f, g, x, sq, inv_scale, log_a, log_b, epsilon, group):
    f = epsilon * log_a - epsilon * _ring_smoothed_lse(
        g, x, sq, inv_scale, epsilon, group)
    g = epsilon * log_b - epsilon * _ring_smoothed_lse(
        f, x, sq, inv_scale, epsilon, group)
    return f, g


def distributed_ot_resample(log_weight, value, group,
                            epsilon: float = 0.5, num_iterations: int = 50,
                            scale_cost: bool = True):
    """`ot_resample` over a particle axis sharded across the ranks of
    ``group`` (the particle axis's process group).

    Args:
        log_weight: this rank's block `[B, K_l]` (differentiable).
        value: this rank's `[B, K_l, ...]` particles (a tensor or a dict).
        group: the particle group; its ranks hold consecutive blocks.
        epsilon, num_iterations, scale_cost: as `ot_resample`; the cost
            scale is the mean over the GLOBAL cloud (all-reduced), the
            single-device scale to float rounding.

    Returns:
        (this rank's block of the transported particles, zeros `[B,
        K_l]`). Differentiable in both inputs; each Sinkhorn iteration is
        recomputed in the backward pass when a gradient is recorded.
    """
    from .parallel import collectives

    x, rebuild = _flatten_particles(value)                   # [B, K_l, D]
    k_global = x.shape[1] * collectives.size(group)
    sq = (x * x).sum(dim=-1)                                 # [B, K_l]
    inv_scale = _inverse_mean_cost(x, sq, scale_cost, group)
    log_a, log_b = _log_marginals(log_weight, group)
    recompute = _recording_grad(log_weight, x)
    f = torch.zeros_like(log_a)
    g = torch.zeros_like(log_a)
    for _ in range(num_iterations):
        f, g = _maybe_checkpoint(_ring_iteration, f, g, x, sq, inv_scale,
                                 log_a, log_b, epsilon, group,
                                 recompute=recompute)
    transported = _ring_transport(f, g, x, sq, inv_scale, epsilon, group,
                                  k_global)
    return rebuild(transported), torch.zeros_like(log_weight)


# ---------------------------------------------------------------------------
# Low-rank (subquadratic) transport. The plan is P = Q diag(1/g) R^T with
# Q in Pi(a, g) [K, r], R in Pi(b, g) [K, r] and g in the r-simplex, found
# by mirror descent with Bregman projections in the log domain. The
# squared-Euclidean cost factors exactly with rank D + 2, so every
# contraction costs O(K (D + 2) r).
# ---------------------------------------------------------------------------


def _lowrank_grads(lq, lr, lg, x, sq, inv_scale, group=None):
    """(grad_Q, grad_R, grad_g) of <C, Q diag(1/g) R^T> through the exact
    rank-(D + 2) factorization of the squared-Euclidean cost. With
    ``group`` the contractions over K are all-reduced: the [B, D + 2, r]
    moments of Q and R in one all-reduce, diag(Q^T C R) in another."""
    q = torch.exp(lq)                                        # [B, K, r]
    r = torch.exp(lr)
    inv_g = torch.exp(-lg)                                   # [B, r]
    scale = inv_scale[:, :, 0]                               # [B, 1]

    def moments(m):
        # 1^T M, sq^T M and X^T M: [B, r], [B, r], [B, D, r].
        return (m.sum(dim=1), torch.einsum("bk,bkr->br", sq, m),
                torch.einsum("bkd,bkr->bdr", x, m))

    def c_times(m, t1, t2, t3):
        # C M for M [B, K, r]: sq (1^T M) + 1 (sq^T M) - 2 X (X^T M).
        out = (sq[:, :, None] * t1[:, None, :] + t2[:, None, :] -
               2.0 * torch.einsum("bkd,bdr->bkr", x, t3))
        return out * scale[:, None, :]

    if group is None:
        cr = c_times(r, *moments(r))
        cq = c_times(q, *moments(q))                         # C^T Q = C Q
        omega = torch.einsum("bkr,bkr->br", q, cr)           # diag(Q^T C R)
    else:
        from .parallel import collectives
        d = x.shape[2]
        packed = torch.stack([torch.cat([t1[:, None], t2[:, None], t3],
                                        dim=1)
                              for t1, t2, t3 in (moments(r), moments(q))])
        total = collectives.all_reduce(packed, group)   # [2, B, D + 2, r]
        cr, cq = (c_times(m, t[:, 0], t[:, 1], t[:, 2:2 + d])
                  for m, t in ((r, total[0]), (q, total[1])))
        omega = collectives.all_reduce(
            torch.einsum("bkr,bkr->br", q, cr), group)
    grad_q = cr * inv_g[:, None, :]
    grad_r = cq * inv_g[:, None, :]
    grad_g = -omega * inv_g ** 2
    return grad_q, grad_r, grad_g


def _logsumexp_k(lq, lr, group):
    """The logsumexps over K (dim 1) of ``lq`` and ``lr``, `[B, r]` each;
    with ``group`` over the whole cloud, both in one distributed
    logsumexp."""
    if group is None:
        return torch.logsumexp(lq, dim=1), torch.logsumexp(lr, dim=1)
    from . import math as amath
    both = amath.distributed_logsumexp(torch.cat([lq, lr], dim=2), group,
                                       dim=1)
    return both[:, :lq.shape[2]], both[:, lq.shape[2]:]


def _lowrank_project(lq, lr, lg, log_a, log_b, inner_iterations,
                     group=None):
    """Bregman projections onto {Q1 = a, R1 = b, Q^T 1 = R^T 1 = g,
    sum g = 1} in the log domain, ending on the row scalings (exact a and
    b marginals). The sums over K cross ``group``."""
    for _ in range(inner_iterations):
        lq = lq - torch.logsumexp(lq, dim=2, keepdim=True) + log_a[:, :, None]
        lr = lr - torch.logsumexp(lr, dim=2, keepdim=True) + log_b[:, :, None]
        lp, lqq = _logsumexp_k(lq, lr, group)                # [B, r]
        lg = (lp + lqq + lg) / 3.0
        lg = lg - torch.logsumexp(lg, dim=1, keepdim=True)
        lq = lq + (lg - lp)[:, None, :]
        lr = lr + (lg - lqq)[:, None, :]
    lq = lq - torch.logsumexp(lq, dim=2, keepdim=True) + log_a[:, :, None]
    lr = lr - torch.logsumexp(lr, dim=2, keepdim=True) + log_b[:, :, None]
    return lq, lr, lg


def _lowrank_iteration(lq, lr, lg, x, sq, inv_scale, log_a, log_b, gamma,
                       epsilon, inner_iterations, group=None):
    gq, gr, gg = _lowrank_grads(lq, lr, lg, x, sq, inv_scale, group)
    # Per-row adaptive step: gamma / max |grad|, the max over the whole
    # cloud (the ranks' maxima gathered: differentiable, as the max is).
    local = torch.maximum(gq.abs().amax(dim=(1, 2)),
                          gr.abs().amax(dim=(1, 2)))
    if group is not None:
        from .parallel import collectives
        local = collectives.all_gather(local[None], group, dim=0).amax(dim=0)
    gmax = torch.clamp(torch.maximum(local, gg.abs().amax(dim=1)), min=1e-6)
    step = gamma / gmax                                      # [B]
    s3 = step[:, None, None]
    s2 = step[:, None]
    # Entropic mirror update: l' = (1 - step eps) l - step grad.
    lq = (1.0 - s3 * epsilon) * lq - s3 * gq
    lr = (1.0 - s3 * epsilon) * lr - s3 * gr
    lg = (1.0 - s2 * epsilon) * lg - s2 * gg
    return _lowrank_project(lq, lr, lg, log_a, log_b, inner_iterations,
                            group)


def lowrank_ot_resample(log_weight, value, rank: int = 32,
                        epsilon: float = 0.05, num_iterations: int = 60,
                        gamma: float = 5.0, inner_iterations: int = 6,
                        scale_cost: bool = True, noise=None,
                        group=None) -> Tuple:
    """Subquadratic differentiable ensemble-transport resampling.

    Transports the weighted cloud onto a uniform one through a rank-
    ``rank`` plan, O(K rank D) an iteration instead of Sinkhorn's O(K^2).
    Every output is a convex combination of source particles (each target
    is normalized by the column mass the plan gives it), and the weighted
    mean is preserved to ~1e-3 relative.

    Args:
        log_weight: `[B, K]` unnormalized log-weights (differentiable).
        value: a `[B, K, ...]` tensor or a dict of them.
        rank: the number of anchors r.
        epsilon: entropic smoothing of the mirror step (0 disables).
        num_iterations: mirror-descent iterations.
        gamma: mirror step size, divided per row by the gradient's largest
            magnitude.
        inner_iterations: Bregman projection sweeps an iteration.
        scale_cost: divide the cost by its per-row mean.
        noise: the `NoiseSource` of the initialization's symmetry-breaking
            jitter (default `NoiseSource.seeded(0)` on the weights'
            device): two normal draws of `[B, K, rank]`, Q's then R's. The
            independent couplings a g^T and b g^T are a fixed point of the
            iteration, so the anchors start perturbed.
        group: the particle axis's process group when the cloud is
            sharded over ranks, or None. ``log_weight`` and ``value`` are
            then this rank's blocks `[B, K_l, ...]`, and so are Q and R:
            every sum over K (the cost's moments, diag(Q^T C R), the
            projections' logsumexps, the step's max, the cost scale and
            the final Q^T X) crosses the group, O(B r (D + 2)) floats a
            rank an iteration and no O(K) exchange. ``noise`` must then
            hand each rank its block of the global `[B, K, rank]` draws
            (`noise.ShardNoise`). A group of one rank computes as one
            device.

    Returns:
        (transported value `[B, K, ...]`, new log-weights `[B, K]`: zeros).
    """
    if group is not None:
        from .parallel import collectives
        if collectives.size(group) == 1:
            group = None
    x, rebuild = _flatten_particles(value)                   # [B, K, D]
    batch, k, _ = x.shape
    r = int(rank)
    if noise is None:
        noise = NoiseSource.seeded(0, log_weight.device)
    sq = (x * x).sum(dim=-1)
    inv_scale = _inverse_mean_cost(x, sq, scale_cost, group)
    log_a, log_b = _log_marginals(log_weight, group)
    lg0 = torch.full((batch, r), -_stdmath.log(r), dtype=log_a.dtype,
                     device=log_a.device)
    lq0 = (log_a[:, :, None] + lg0[:, None, :] +
           0.5 * noise.normal((batch, k, r)))
    lr0 = (log_b[:, :, None] + lg0[:, None, :] +
           0.5 * noise.normal((batch, k, r)))
    lq, lr, lg = _lowrank_project(lq0, lr0, lg0, log_a, log_b,
                                  inner_iterations, group)
    recompute = _recording_grad(log_weight, x)
    for _ in range(num_iterations):
        lq, lr, lg = _maybe_checkpoint(
            _lowrank_iteration, lq, lr, lg, x, sq, inv_scale, log_a, log_b,
            gamma, epsilon, inner_iterations, group, recompute=recompute)
    # x_tilde_j = sum_i P_ij x_i / sum_i P_ij with P = Q diag(1/g) R^T, all
    # low rank: Q^T x and Q^T 1 are [B, r, .] contractions.
    q = torch.exp(lq)
    rmat = torch.exp(lr)
    inv_g = torch.exp(-lg)                                   # [B, r]
    qx = torch.einsum("bkr,bkd->brd", q, x)                  # Q^T x
    qs = q.sum(dim=1)                                        # Q^T 1
    if group is not None:
        # Over the whole cloud: [Q^T x, Q^T 1] in one all-reduce.
        from .parallel import collectives
        moments = collectives.all_reduce(
            torch.cat([qx, qs[:, :, None]], dim=2), group)
        qx, qs = moments[:, :, :-1], moments[:, :, -1]
    num = torch.einsum("bkr,brd->bkd", rmat, qx * inv_g[:, :, None])
    den = torch.einsum("bkr,br->bk", rmat, qs * inv_g)
    transported = num / (den[:, :, None] + 1e-30)
    return rebuild(transported), torch.zeros_like(log_weight)
