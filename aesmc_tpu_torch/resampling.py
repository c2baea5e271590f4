"""Systematic particle resampling, on the tensors' device.

Counterpart of the systematic path of `aesmc_tpu.resampling`:

    normalize -> cumulative sum -> systematic grid -> inverse-CDF search

with ancestor indices detached and the CDF made monotone and pinned to 1.0
at its end, exactly as the JAX package does. Uniforms come from a
`noise.NoiseSource`.

Two implementations:
- 'cuda': the fused resample+gather kernel (`ops.resample_cuda`, K1), for
  CUDA tensors only;
- 'torch': plain PyTorch ops, on any device.
'auto' picks 'cuda' for a CUDA tensor and 'torch' otherwise.

Stratified, multinomial, residual and soft resampling, and the dense
one-hot route of the JAX package, are not ported yet.
"""

from __future__ import annotations

import math as _stdmath

import torch

from . import math as amath
from . import state
from .ops import resample_cuda

METHODS = ("systematic",)
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
    """The sorted query positions ``min((u + j) / K, nextafter(1, 0))``,
    with one uniform ``u`` per batch row from ``noise``."""
    _check_method(method)
    batch_size, k = log_weight.shape
    return resample_cuda.systematic_positions(noise.uniform((batch_size, 1)),
                                              k)


def systematic_indices(log_weight, noise):
    """Systematic ancestor indices `[B, K]` int32."""
    k = log_weight.shape[-1]
    cum = _normalized_cumsum(log_weight)
    pos = resampling_positions(log_weight, noise, "systematic")
    idx = torch.searchsorted(cum, pos, right=True)
    return idx.clamp_(max=k - 1).to(torch.int32)


def resolve_implementation(device, method: str, implementation: str) -> str:
    """'auto' -> 'cuda' for a CUDA device, 'torch' otherwise. Explicit
    strings pass through; 'cuda' for a tensor off the card raises."""
    _check_method(method)
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


def sample_ancestral_index(log_weight, noise, method: str = "systematic"):
    """Samples `[batch, particle]` int32 ancestor indices (no gradient)."""
    _check_method(method)
    if log_weight.ndim != 2:
        raise ValueError(
            f"log_weight must be [batch, particles]. Got "
            f"{tuple(log_weight.shape)}")
    _check_nan_eager(log_weight)
    return systematic_indices(log_weight.detach(), noise)


def _leaves(value):
    if isinstance(value, dict):
        return [leaf for v in value.values() for leaf in _leaves(v)]
    return [value]


def _rebuild(value, flat, start=0):
    """Inverse of flattening ``value``'s leaves into the columns of
    ``flat`` `[B, K, C]`; returns (rebuilt, next column)."""
    if isinstance(value, dict):
        out = {}
        for key, v in value.items():
            out[key], start = _rebuild(v, flat, start)
        return out, start
    width = _stdmath.prod(value.shape[2:])
    cols = flat[:, :, start:start + width]
    return cols.reshape(value.shape), start + width


def _resample_systematic(log_weight, noise, value, implementation,
                         need_indices):
    """The resampling step of `infer`: no NaN check (it would wait for the
    device at every step). ``implementation`` is 'cuda' or 'torch'."""
    log_weight = log_weight.detach()
    batch_size, k = log_weight.shape
    cdf = _normalized_cumsum(log_weight)
    u = noise.uniform((batch_size, 1))
    leaves = _leaves(value)
    if len(leaves) == 1:
        flat = leaves[0].reshape(batch_size, k, -1)
    else:
        flat = torch.cat([leaf.reshape(batch_size, k, -1)
                          for leaf in leaves], dim=2)
    if implementation == "cuda":
        idx, gathered = resample_cuda.resample_and_gather_systematic(
            cdf, u, flat.contiguous(), emit_idx=need_indices)
    else:
        idx, gathered = resample_cuda.resample_and_gather_systematic_torch(
            cdf, u, flat, emit_idx=need_indices)
    return idx, _rebuild(value, gathered)[0]


def sample_ancestral_index_and_resample(log_weight, noise, value,
                                        method: str = "systematic",
                                        implementation: str = "auto",
                                        need_indices: bool = True):
    """Samples ancestor indices AND redistributes ``value`` in one pass.

    ``value`` is a `[B, K, ...]` tensor or a dict of them; on the 'cuda'
    route they must be float32 and travel through the fused kernel as the
    columns of one `[B, K, D]` tensor. With ``need_indices=False`` the
    kernel skips the index output and indices come back None.

    Returns (indices `[B, K]` int32 - detached - or None, resampled value).
    """
    _check_nan_eager(log_weight)
    implementation = resolve_implementation(log_weight.device, method,
                                            implementation)
    return _resample_systematic(log_weight, noise, value, implementation,
                                need_indices)


def resample_particles(value, ancestral_index):
    """Gathers particles by ancestor index (any indices, any dtype)."""
    return state.resample(value, ancestral_index)
