"""Particle resampling, on the tensors' device.

Counterpart of the systematic, stratified and multinomial paths of
`aesmc_tpu.resampling`:

    normalize -> cumulative sum -> sorted positions -> inverse-CDF search

with ancestor indices detached and the CDF made monotone and pinned to 1.0
at its end, exactly as the JAX package does. Noise comes from a
`noise.NoiseSource`: one uniform a row (systematic), one a stratum
(stratified), or K + 1 exponentials a row whose normalized cumulative sums
are the sorted multinomial draws.

Two implementations:
- 'cuda': the hand-written kernels, for CUDA tensors only: the fused
  systematic resample+gather (`ops.resample_cuda`, K1), the search +
  gather over loaded positions (`ops.resample_sorted_cuda`, K3) and,
  where only indices are needed, the index-only search of loaded
  positions (`ops.searchsorted_sorted_cuda`, K4); the backward of K1 and
  K3 is the range sum (`ops.range_sum_cuda`, K2). Float32 particles ride
  K1 or K3; particles of any other dtype (the HMM's int32 states) are
  gathered apart by the ancestor indices through the sorted gather
  (`ops.gather_sorted_cuda`, K5), which moves every dtype bit for bit and
  is forward-only;
- 'torch': plain PyTorch ops, on any device.
'auto' picks 'cuda' for a CUDA tensor and 'torch' otherwise, at every K.

Residual and soft resampling, and the dense one-hot route of the JAX
package, are not ported yet.
"""

from __future__ import annotations

import math as _stdmath

import torch

from . import math as amath
from .ops import (gather_sorted_cuda, resample_cuda, resample_sorted_cuda,
                  searchsorted_sorted_cuda)

METHODS = ("systematic", "stratified", "multinomial")
IMPLEMENTATIONS = ("auto", "cuda", "torch")


def _check_nan_eager(log_weight):
    """FloatingPointError on NaN log-weights. This waits for the device, so
    only the public entry points call it, never `infer`'s time loop."""
    if bool(torch.isnan(log_weight).any()):
        raise FloatingPointError("log_weight contains nan element(s)")


def _check_method(method):
    if method not in METHODS:
        raise ValueError(
            f"method must be one of {METHODS}. currently = {method}")


def _normalized_cumsum(log_weight):
    """`[B, K]` log-weights -> `[B, K]` normalized CDF.

    The cumulative sum is made monotone with a running max, divided by its
    last entry, and the last entry is then pinned to exactly 1.0, so that
    every position (strictly below 1) has a strictly greater CDF entry.
    """
    w = amath.exponentiate_and_normalize(log_weight, dim=-1)
    cum = torch.cummax(torch.cumsum(w, dim=-1), dim=-1).values
    cum = cum / cum[:, -1:]
    return torch.cat([cum[:, :-1], torch.ones_like(cum[:, -1:])], dim=1)


def resampling_positions(log_weight, noise, method: str = "systematic"):
    """The sorted inverse-CDF query positions `[B, K]`, clamped strictly
    below 1.0:

    - systematic: ``(u + j) / K`` with one uniform ``u`` a row;
    - stratified: ``(u_j + j) / K`` with one uniform a stratum;
    - multinomial: ``S_j / S_K`` for the cumulative sums S of K + 1 iid
      Exp(1) draws: the order statistics of K iid uniforms.
    """
    _check_method(method)
    batch_size, k = log_weight.shape
    if method == "systematic":
        return resample_cuda.systematic_positions(
            noise.uniform((batch_size, 1)), k)
    if method == "stratified":
        return resample_cuda.systematic_positions(
            noise.uniform((batch_size, k)), k)
    # A parallel cumulative sum on the card is not monotone in float32
    # (measured on an H100 at K = 8,388,608); the running max keeps the
    # positions sorted, which the search and its backward (K2) rely on.
    s = torch.cummax(
        torch.cumsum(noise.exponential((batch_size, k + 1)), dim=-1),
        dim=-1).values
    return torch.clamp(s[:, :-1] / s[:, -1:],
                       max=resample_cuda._BELOW_ONE)


def _indices(log_weight, noise, method):
    k = log_weight.shape[-1]
    cum = _normalized_cumsum(log_weight)
    pos = resampling_positions(log_weight, noise, method)
    idx = torch.searchsorted(cum, pos, right=True)
    return idx.clamp_(max=k - 1).to(torch.int32)


def systematic_indices(log_weight, noise):
    """Systematic ancestor indices `[B, K]` int32."""
    return _indices(log_weight, noise, "systematic")


def stratified_indices(log_weight, noise):
    """Stratified ancestor indices `[B, K]` int32: an independent uniform
    per grid stratum."""
    return _indices(log_weight, noise, "stratified")


def multinomial_indices(log_weight, noise):
    """Multinomial ancestor indices `[B, K]` int32: the sorted order
    statistics of K iid categorical draws from the weights."""
    return _indices(log_weight, noise, "multinomial")


def resolve_implementation(device, method: str, implementation: str) -> str:
    """'auto' -> 'cuda' for a CUDA device, 'torch' otherwise. Explicit
    strings pass through; 'cuda' for a tensor off the card raises."""
    _check_method(method)
    return _route(device, implementation)


def _route(device, implementation: str) -> str:
    if implementation not in IMPLEMENTATIONS:
        raise ValueError(f"implementation must be one of {IMPLEMENTATIONS}."
                         f" currently = {implementation}")
    on_cuda = torch.device(device).type == "cuda"
    if implementation == "cuda" and not on_cuda:
        raise ValueError(
            f"implementation='cuda' needs CUDA tensors; got {device}")
    if implementation == "auto":
        return "cuda" if on_cuda else "torch"
    return implementation


def sample_ancestral_index(log_weight, noise, method: str = "systematic",
                           implementation: str = "auto"):
    """Samples `[batch, particle]` int32 ancestor indices (no gradient).

    On the 'cuda' route systematic resampling runs K1 with no value
    columns and its index output on; stratified and multinomial run K4 on
    the positions of `resampling_positions`.
    The 'torch' route runs `torch.searchsorted`. Both draw the same noise.
    """
    _check_method(method)
    if log_weight.ndim != 2:
        raise ValueError(
            f"log_weight must be [batch, particles]. Got "
            f"{tuple(log_weight.shape)}")
    _check_nan_eager(log_weight)
    implementation = resolve_implementation(log_weight.device, method,
                                            implementation)
    log_weight = log_weight.detach()
    if implementation == "torch":
        return _indices(log_weight, noise, method)
    cdf = _normalized_cumsum(log_weight)
    if method == "systematic":
        u = noise.uniform((log_weight.shape[0], 1))
        idx, _ = resample_cuda.resample_and_gather_systematic(
            cdf, u, _no_columns(cdf))
        return idx
    pos = resampling_positions(log_weight, noise, method)
    return searchsorted_sorted_cuda.searchsorted_sorted(cdf, pos)


def _no_columns(cdf):
    """`[B, K, 0]`: no value columns for K1."""
    return cdf.new_empty(tuple(cdf.shape) + (0,))


def _leaves(value):
    if isinstance(value, dict):
        return [leaf for v in value.values() for leaf in _leaves(v)]
    return [value]


def _unflatten(value, leaves):
    """Inverse of `_leaves`: ``value``'s structure with the next leaves of
    the iterator ``leaves``."""
    if isinstance(value, dict):
        return {key: _unflatten(v, leaves) for key, v in value.items()}
    return next(leaves)


def _fused(leaf) -> bool:
    """Whether a leaf rides K1/K3 as value columns (float32) or is gathered
    apart by the ancestor indices (K5)."""
    return leaf.dtype == torch.float32


def _resample(log_weight, noise, value, method, implementation,
              need_indices):
    """The resampling step of `infer`: no NaN check (it would wait for the
    device at every step). ``implementation`` is 'cuda' or 'torch'.

    Float32 leaves go through K1 (systematic) or K3 as the columns of one
    `[B, K, D]` tensor; every other leaf through K5 with the indices K1 or
    K3 emitted, which they then emit even when ``need_indices`` is False
    (the returned indices still follow ``need_indices``). With no float32
    leaf, stratified and multinomial find the indices with K4."""
    log_weight = log_weight.detach()
    batch_size, k = log_weight.shape
    cdf = _normalized_cumsum(log_weight)
    leaves = _leaves(value)
    fused = [leaf.reshape(batch_size, k, -1) for leaf in leaves
             if _fused(leaf)]
    apart = [leaf for leaf in leaves if not _fused(leaf)]
    cuda = implementation == "cuda"
    if cuda and any(leaf.requires_grad for leaf in apart):
        raise ValueError(
            "only float32 particles carry a gradient through resampling on "
            "the 'cuda' route (K1/K3, backward K2); the gather of other "
            "dtypes (K5) is forward-only")
    emit_idx = need_indices or bool(apart)
    if len(fused) > 1:
        flat = torch.cat(fused, dim=2)
    else:
        flat = fused[0] if fused else None
    if method == "systematic":
        # K1 builds the positions itself from one uniform a row.
        if flat is None:
            flat = _no_columns(cdf)
        u = noise.uniform((batch_size, 1))
        if cuda:
            idx, gathered = resample_cuda.resample_and_gather_systematic(
                cdf, u, flat.contiguous(), emit_idx=emit_idx)
        else:
            idx, gathered = \
                resample_cuda.resample_and_gather_systematic_torch(
                    cdf, u, flat, emit_idx=emit_idx)
    else:
        pos = resampling_positions(log_weight, noise, method)
        if flat is None:
            # Indices only: K4 on the 'cuda' route.
            search = (searchsorted_sorted_cuda.searchsorted_sorted if cuda
                      else searchsorted_sorted_cuda.searchsorted_sorted_torch)
            idx, gathered = search(cdf, pos), None
        elif cuda:
            idx, gathered = resample_sorted_cuda.resample_and_gather_sorted(
                cdf, pos, flat.contiguous(), emit_idx=emit_idx)
        else:
            idx, gathered = \
                resample_sorted_cuda.resample_and_gather_sorted_torch(
                    cdf, pos, flat, emit_idx=emit_idx)
    gathered_apart = iter(_gather_apart(apart, idx, cuda))
    out, start = [], 0
    for leaf in leaves:
        if _fused(leaf):
            width = _stdmath.prod(leaf.shape[2:])
            out.append(gathered[:, :, start:start + width].reshape(leaf.shape))
            start += width
        else:
            out.append(next(gathered_apart))
    return (idx if need_indices else None), _unflatten(value, iter(out))


def _gather_apart(leaves, idx, cuda):
    if cuda:
        return [gather_sorted_cuda.gather_sorted(leaf.contiguous(), idx)
                for leaf in leaves]
    return [gather_sorted_cuda.gather_sorted_torch(leaf, idx)
            for leaf in leaves]


def sample_ancestral_index_and_resample(log_weight, noise, value,
                                        method: str = "systematic",
                                        implementation: str = "auto",
                                        need_indices: bool = True):
    """Samples ancestor indices AND redistributes ``value`` in one pass.

    ``value`` is a `[B, K, ...]` tensor or a dict of them. Float32 leaves
    travel through the fused kernel (K1 for 'systematic', K3 otherwise) as
    the columns of one `[B, K, D]` tensor, and gradients flow to them
    (through K2 on the 'cuda' route); leaves of any other dtype are
    gathered by the ancestor indices (K5, forward-only: on the 'cuda' route
    such a leaf that requires a gradient raises ValueError). With
    ``need_indices=False`` indices come back None, and the kernel skips
    its index output unless a leaf needs K5.

    Returns (indices `[B, K]` int32 - detached - or None, resampled value).
    """
    _check_nan_eager(log_weight)
    implementation = resolve_implementation(log_weight.device, method,
                                            implementation)
    return _resample(log_weight, noise, value, method, implementation,
                     need_indices)


def resample_particles(value, ancestral_index,
                       implementation: str = "auto"):
    """Gathers particles by sorted ancestor indices `[B, Kp]`: on the 'cuda'
    route every leaf goes through K5 (any dtype of 1, 2, 4 or 8 bytes,
    forward-only), on the 'torch' route through `take_along_dim`. 'auto'
    follows the indices' device. For unsorted indices use
    `state.resample`."""
    implementation = _route(ancestral_index.device, implementation)
    idx = ancestral_index.to(torch.int32).contiguous()
    return _unflatten(value, iter(_gather_apart(
        _leaves(value), idx, implementation == "cuda")))
