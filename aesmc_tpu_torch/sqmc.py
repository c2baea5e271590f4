"""Sequential quasi-Monte Carlo (SQMC, Gerber & Chopin 2015).

Counterpart of `aesmc_tpu.sqmc`. SQMC replaces the i.i.d. uniforms that
drive a particle filter with randomized quasi-Monte Carlo (RQMC) point
sets, which turns the O(K^-1/2) Monte Carlo error into o(K^-1/2) on
smooth models. Three building blocks:

- `sobol_points(n, dim, noise)`: scrambled Sobol points from the Joe & Kuo
  direction numbers (this module's own copy of the table for dim <= 64,
  scipy's bundled table above). The scramble is a left linear matrix
  scramble (Matousek) and a digital shift, drawn as uniform 32-bit words
  (`NoiseSource.bits`, the draws of `jax.random.bits`), so that each
  draw gives an unbiased RQMC replicate. All bit arithmetic runs on int64
  words masked to 32 bits; with the same words the points equal the JAX
  package's bit for bit.
- `hilbert_sort_indices(x, bits)`: each row's particle order along the
  Hilbert curve (Skilling's transpose algorithm on int64 words), whose
  locality makes inverse-CDF resampling a low-discrepancy map in d > 1.
- `sqmc_infer(...)`: the SQMC particle filter, with the contract and
  return vocabulary of `inference.infer('smc', ...)`. At t = 0 a `[K, d]`
  point set drives the proposal's quantile transform; at t >= 1 a
  `[K, 1 + d]` set drives inverse-CDF resampling of the Hilbert-ordered
  particles (first coordinate) and the proposal (the others).

On the 'cuda' route each resampling step is one launch of K3
(`ops.resample_sorted_cuda`): the sorted first coordinates are its
positions and the Hilbert permutation rides as its one value column, so
the gathered column is the ancestor. The CDF of the sorted weights takes a
running max (`torch.cumsum` on the card is not monotone in float32, and K3
and `torch.searchsorted` agree only on a monotone CDF); its last entry is
not pinned, as in the JAX package.

Proposals must be quantile-transformable: the location-scale Gaussian
family (`Normal`, `MultivariateNormalDiag`, `MultivariateNormalTriL`,
`Independent(Normal, 1)`), `Deterministic`, or any object with
`sample_from_uniforms(u)`.
"""

from __future__ import annotations

import math as _stdmath
import os
from typing import Optional

import numpy as np
import torch
from torch.utils import checkpoint as _checkpoint

from . import device as _device
from . import distributions as dists
from . import inference as _inference
from . import math as amath
from . import resampling, state
from .noise import NoiseSource
from .ops import resample_sorted_cuda
from .state import BatchShapeMode

__all__ = [
    "direction_numbers",
    "sobol_points",
    "hilbert_index",
    "hilbert_sort_indices",
    "event_size",
    "quantile_sample",
    "sqmc_infer",
    "get_resampled_latents",
]

_BITS = 32
_MAX_EMBEDDED_DIM = 64
# Largest K of the kernel route: the Hilbert permutation rides K3 as a
# float32 column, exact up to 2^24, which is also the kernels' own bound.
_MAX_KERNEL_PARTICLES = 1 << 24

# Primitive polynomials (as integers, leading term the MSB) and initial
# direction numbers m_1..m_s of the first 64 Sobol dimensions: the
# public Joe & Kuo (2008) tables, which scipy also ships.
_POLY = [
    1, 3, 7, 11, 13, 19, 25, 37, 41, 47, 55, 59, 61, 67, 91, 97, 103,
    109, 115, 131, 137, 143, 145, 157, 167, 171, 185, 191, 193, 203,
    211, 213, 229, 239, 241, 247, 253, 285, 299, 301, 333, 351, 355,
    357, 361, 369, 391, 397, 425, 451, 463, 487, 501, 529, 539, 545,
    557, 563, 601, 607, 617, 623, 631, 637,
]
_VINIT = [
    [], [1], [1, 3], [1, 3, 1], [1, 1, 1], [1, 1, 3, 3], [1, 3, 5, 13],
    [1, 1, 5, 5, 17], [1, 1, 5, 5, 5], [1, 1, 7, 11, 19],
    [1, 1, 5, 1, 1], [1, 1, 1, 3, 11], [1, 3, 5, 5, 31],
    [1, 3, 3, 9, 7, 49], [1, 1, 1, 15, 21, 21], [1, 3, 1, 13, 27, 49],
    [1, 1, 1, 15, 7, 5], [1, 3, 1, 15, 13, 25], [1, 1, 5, 5, 19, 61],
    [1, 3, 7, 11, 23, 15, 103], [1, 3, 7, 13, 13, 15, 69],
    [1, 1, 3, 13, 7, 35, 63], [1, 3, 5, 9, 1, 25, 53],
    [1, 3, 1, 13, 9, 35, 107], [1, 3, 1, 5, 27, 61, 31],
    [1, 1, 5, 11, 19, 41, 61], [1, 3, 5, 3, 3, 13, 69],
    [1, 1, 7, 13, 1, 19, 1], [1, 3, 7, 5, 13, 19, 59],
    [1, 1, 3, 9, 25, 29, 41], [1, 3, 5, 13, 23, 1, 55],
    [1, 3, 7, 3, 13, 59, 17], [1, 3, 1, 3, 5, 53, 69],
    [1, 1, 5, 5, 23, 33, 13], [1, 1, 7, 7, 1, 61, 123],
    [1, 1, 7, 9, 13, 61, 49], [1, 3, 3, 5, 3, 55, 33],
    [1, 3, 1, 15, 31, 13, 49, 245], [1, 3, 5, 15, 31, 59, 63, 97],
    [1, 3, 1, 11, 11, 11, 77, 249], [1, 3, 1, 11, 27, 43, 71, 9],
    [1, 1, 7, 15, 21, 11, 81, 45], [1, 3, 7, 3, 25, 31, 65, 79],
    [1, 3, 1, 1, 19, 11, 3, 205], [1, 1, 5, 9, 19, 21, 29, 157],
    [1, 3, 7, 11, 1, 33, 89, 185], [1, 3, 3, 3, 15, 9, 79, 71],
    [1, 3, 7, 11, 15, 39, 119, 27], [1, 1, 3, 1, 11, 31, 97, 225],
    [1, 1, 1, 3, 23, 43, 57, 177], [1, 3, 7, 7, 17, 17, 37, 71],
    [1, 3, 1, 5, 27, 63, 123, 213], [1, 1, 3, 5, 11, 43, 53, 133],
    [1, 3, 5, 5, 29, 17, 47, 173, 479], [1, 3, 3, 11, 3, 1, 109, 9, 69],
    [1, 1, 1, 5, 17, 39, 23, 5, 343], [1, 3, 1, 5, 25, 15, 31, 103, 499],
    [1, 1, 1, 11, 11, 17, 63, 105, 183],
    [1, 1, 5, 11, 9, 29, 97, 231, 363],
    [1, 1, 5, 15, 19, 45, 41, 7, 383],
    [1, 3, 7, 7, 31, 19, 83, 137, 221],
    [1, 1, 1, 3, 23, 15, 111, 223, 83],
    [1, 1, 5, 13, 31, 15, 55, 25, 161],
    [1, 1, 3, 13, 25, 47, 39, 87, 257],
]

_direction_cache: dict = {}
# Device copies of the constants, made by the first (eager) call on each
# device: a copy from the host could not be captured in a CUDA graph.
_device_constants: dict = {}


def direction_numbers(dim: int) -> np.ndarray:
    """`[dim, 32]` uint32 Sobol direction numbers (on the host, cached).

    Dimensions <= 64 come from this module's Joe-Kuo table; higher ones
    from scipy's bundled table of the same source data
    (`_sobol_direction_numbers.npz`, installed with scipy).
    """
    if dim in _direction_cache:
        return _direction_cache[dim]
    if dim <= _MAX_EMBEDDED_DIM:
        poly, vinit = _POLY[:dim], _VINIT[:dim]
    else:
        try:
            import scipy.stats as _st
            npz = np.load(os.path.join(os.path.dirname(_st.__file__),
                                       "_sobol_direction_numbers.npz"))
        except Exception as exc:  # pragma: no cover
            raise ValueError(
                f"Sobol dimension {dim} > {_MAX_EMBEDDED_DIM} needs "
                "scipy's Joe-Kuo table, which is unavailable: "
                f"{exc}") from exc
        if dim > npz["poly"].shape[0]:
            raise ValueError(f"Sobol dimension {dim} exceeds the "
                             f"Joe-Kuo table ({npz['poly'].shape[0]})")
        poly = [int(p) for p in npz["poly"][:dim]]
        vinit = [[int(x) for x in row[:max(p.bit_length() - 1, 0)]]
                 for p, row in zip(poly, npz["vinit"][:dim])]
    v = np.zeros((dim, _BITS), dtype=np.uint64)
    for k in range(_BITS):
        v[0, k] = 1 << (_BITS - 1 - k)
    for j in range(1, dim):
        p = int(poly[j])
        s = p.bit_length() - 1
        m = [int(x) for x in vinit[j][:s]]
        for k in range(s, _BITS):
            newm = m[k - s] ^ (m[k - s] << s)
            for i in range(1, s):
                if (p >> (s - i)) & 1:
                    newm ^= m[k - i] << i
            m.append(newm)
        for k in range(_BITS):
            v[j, k] = m[k] << (_BITS - 1 - k)
    out = v.astype(np.uint32)
    _direction_cache[dim] = out
    return out


def _constant(name, device, make):
    """The device tensor ``make()`` under ``name``, made once a device."""
    key = (name, torch.device(device))
    t = _device_constants.get(key)
    if t is None:
        t = make().to(device)
        _device_constants[key] = t
    return t


def _direction_tensor(dim, device):
    return _constant(("directions", dim), device, lambda: torch.from_numpy(
        direction_numbers(dim).astype(np.int64)))


def _lms_masks(device):
    """(above, diag) `[32]` int64: row r of the scramble matrix produces
    output bit 31 - r from input bits 31 .. 31 - r, with random bits
    strictly above the diagonal and the diagonal bit set."""
    def make():
        r = np.arange(_BITS)
        mask = (1 << _BITS) - 1
        above = [0 if i == 0 else (mask << (_BITS - i)) & mask for i in r]
        diag = [1 << (_BITS - 1 - i) for i in r]
        return torch.tensor([above, diag], dtype=torch.int64)
    return _constant("lms", device, make)


def _parity(x):
    """The GF(2) parity (population count mod 2) of 32-bit words held in
    int64, by xor-folding."""
    for shift in (16, 8, 4, 2, 1):
        x = x ^ (x >> shift)
    return x & 1


def _lms_scramble(v, rnd):
    """Left linear matrix scramble (Matousek 1998) of direction numbers.

    ``v`` is `[dim, 32]` int64 direction numbers and ``rnd`` `[..., dim,
    32]` uniform 32-bit words (one random lower-triangular unit-diagonal
    GF(2) matrix a dimension, MSB first). Returns `[..., dim, 32]` int64.
    With an identity matrix (``rnd`` all zero) it is the identity.
    """
    above, diag = _lms_masks(v.device)
    lmat = (rnd & above) | diag                             # [..., dim, r]
    par = _parity(lmat[..., :, :, None] & v[:, None, :])    # [.., dim, r, b]
    return (par * diag[:, None]).sum(dim=-2)


def _sobol_uint32(num_points: int, dim: int, noise=None,
                  scramble: bool = True, batch_shape=(), device=None):
    """`batch_shape + [num_points, dim]` Sobol words (int64 in [0, 2^32)).
    Scrambled: one independent scramble a batch entry, drawn from
    ``noise`` as `bits(batch_shape + (dim, 32))` (the matrix) then
    `bits(batch_shape + (dim,))` (the shift), the draws of the JAX
    package's `split(key)` pair."""
    batch_shape = tuple(batch_shape)
    if scramble and noise is None:
        raise ValueError("scramble=True requires a noise source")
    device = noise.device if noise is not None else _device.resolve(device)
    v = _direction_tensor(dim, device)                      # [dim, 32]
    if scramble:
        v = _lms_scramble(v, noise.bits(batch_shape + (dim, _BITS)))
        shift = noise.bits(batch_shape + (dim,))
    i = torch.arange(num_points, dtype=torch.int64, device=device)
    gray = i ^ (i >> 1)
    nbits = max((num_points - 1).bit_length(), 1)
    x = torch.zeros(tuple(v.shape[:-2]) + (num_points, dim),
                    dtype=torch.int64, device=device)
    for b in range(nbits):
        take = (gray >> b) & 1                              # [n]
        x = x ^ (take[:, None] * v[..., None, :, b])
    if scramble:
        return x ^ shift[..., None, :]
    return x.expand(batch_shape + (num_points, dim))


def sobol_points(num_points: int, dim: int, noise=None,
                 scramble: bool = True, dtype=torch.float32,
                 batch_shape=(), device=None) -> torch.Tensor:
    """`batch_shape + [num_points, dim]` (scrambled) Sobol points in [0, 1).

    With ``scramble=True`` every batch entry takes its own scramble (LMS
    and digital shift) from ``noise``, an unbiased RQMC replicate whose
    marginals are exactly uniform. ``scramble=False`` gives the raw
    Joe-Kuo sequence (point 0 is the origin) on ``device`` (default the
    noise's, else the card). float32 points carry the top 24 bits
    (exactly representable); float64 points all 32.
    """
    x = _sobol_uint32(num_points, dim, noise=noise, scramble=scramble,
                      batch_shape=batch_shape, device=device)
    if dtype == torch.float64:
        return x.to(torch.float64) * 2.0 ** -32
    return (x >> 8).to(torch.float32) * 2.0 ** -24


# ---------------------------------------------------------------------
# The Hilbert curve (Skilling 2004, "Programming the Hilbert curve").
# ---------------------------------------------------------------------

def _axes_to_transpose(coords, bits: int):
    """Skilling's AxesToTranspose over a list of int64 tensors."""
    n = len(coords)
    x = list(coords)
    # Inverse undo.
    q = 1 << (bits - 1)
    while q > 1:
        p = q - 1
        for i in range(n):
            cond = (x[i] & q) != 0
            t = (x[0] ^ x[i]) & p
            x0_new = torch.where(cond, x[0] ^ p, x[0] ^ t)
            xi_new = torch.where(cond, x[i], x[i] ^ t)
            x[0] = x0_new
            if i != 0:
                x[i] = xi_new
        q >>= 1
    # Gray encode.
    for i in range(1, n):
        x[i] = x[i] ^ x[i - 1]
    t = torch.zeros_like(x[0])
    q = 1 << (bits - 1)
    while q > 1:
        t = torch.where((x[n - 1] & q) != 0, t ^ (q - 1), t)
        q >>= 1
    return [xi ^ t for xi in x]


def hilbert_index(coords: torch.Tensor, bits: int) -> torch.Tensor:
    """Hilbert-curve keys of integer grid coordinates.

    Args:
        coords: `[..., d]` integer grid coordinates in [0, 2^bits).
        bits: bits per axis; d * bits must be <= 62.

    Returns:
        `[..., 2]` int64 (hi, lo) key words, each below 2^31: consecutive
        keys along the curve differ by one unit step in one axis. Sort
        lexicographically (hi major), as `hilbert_sort_indices` does.
    """
    d = coords.shape[-1]
    total = d * bits
    if total > 62:
        raise ValueError(f"d*bits = {total} > 62: reduce bits "
                         f"(got d={d}, bits={bits})")
    axes = [coords[..., i].to(torch.int64) for i in range(d)]
    x = _axes_to_transpose(axes, bits)
    hi = torch.zeros_like(x[0])
    lo = torch.zeros_like(x[0])
    # Transpose layout: index bit (MSB first) m = (bits-1-q)*d + i is bit
    # q of axis i; LSB position p = q*d + (d-1-i).
    for q in range(bits):
        for i in range(d):
            bit = (x[i] >> q) & 1
            p = q * d + (d - 1 - i)
            if p < 31:
                lo = lo | (bit << p)
            else:
                hi = hi | (bit << (p - 31))
    return torch.stack([hi, lo], dim=-1)


def _default_bits(d: int) -> int:
    return max(1, min(16, 62 // d))


def hilbert_sort_indices(latent: torch.Tensor,
                         bits: Optional[int] = None) -> torch.Tensor:
    """Each row's particle order along the Hilbert curve.

    Args:
        latent: `[B, K]` scalars or `[B, K, D]` vectors. Values are
            min-max rescaled per (row, dim) before gridding, so any scale
            works.
        bits: grid bits per axis (default min(16, 62 // D)).

    Returns:
        `[B, K]` int32 permutation sorting each row along the curve (the
        value order when the latent is scalar). Every sort is stable, as
        `jnp.argsort` is; the two-word keys (d * bits > 31) sort by the
        low word, then stably by the high word.
    """
    latent = latent.detach()
    if latent.ndim == 2:
        return torch.argsort(latent, dim=-1, stable=True).to(torch.int32)
    if latent.ndim != 3:
        raise ValueError("hilbert_sort_indices expects [B, K] or "
                         f"[B, K, D]; got shape {tuple(latent.shape)}")
    d = latent.shape[-1]
    if bits is None:
        bits = _default_bits(d)
    lo = torch.amin(latent, dim=1, keepdim=True)
    hi = torch.amax(latent, dim=1, keepdim=True)
    u01 = (latent - lo) / torch.clamp(hi - lo, min=1e-30)
    grid = torch.clamp((u01 * (2 ** bits)).to(torch.int32), 0,
                       2 ** bits - 1)
    keys = hilbert_index(grid, bits)                        # [B, K, 2]
    order_lo = torch.argsort(keys[..., 1], dim=-1, stable=True)
    if d * bits <= 31:
        return order_lo.to(torch.int32)
    hi_p = torch.take_along_dim(keys[..., 0], order_lo, dim=-1)
    order_hi = torch.argsort(hi_p, dim=-1, stable=True)
    return torch.take_along_dim(order_lo, order_hi,
                                dim=-1).to(torch.int32)


# ---------------------------------------------------------------------
# Quantile (inverse-CDF) sampling of the port's distributions.
# ---------------------------------------------------------------------

_U_LO = 1e-8
_U_HI = float(1.0 - 2.0 ** -24)


def _clip_u(u):
    return torch.clamp(u, _U_LO, _U_HI)


def _ndtri(u):
    return torch.special.ndtri(_clip_u(u))


def event_size(distribution) -> int:
    """The number of uniforms one sample of ``distribution`` consumes."""
    if isinstance(distribution, dists.Deterministic):
        return 0
    size = 1
    for s in distribution.event_shape:
        size *= int(s)
    return size


def quantile_sample(distribution, batch_size: int, num_particles: int,
                    u: torch.Tensor):
    """Samples `[batch, particle, ...]` by the quantile transform.

    The SQMC counterpart of `state.sample`: in place of noise it maps
    ``u``, `[batch, particle, event_size]` uniforms in [0, 1), so that
    low-discrepancy point sets map to low-discrepancy particle sets. The
    location-scale Gaussian family (the exact componentwise `ndtri`
    transform, on u clipped to [1e-8, 1 - 2^-24]), `Deterministic`, and
    any object with a `sample_from_uniforms(u)` method. Batch-shape modes
    follow `state.sample`.
    """
    mode = state.get_batch_shape_mode(distribution, batch_size,
                                      num_particles)
    batch_expanded = mode == BatchShapeMode.BATCH_EXPANDED
    batch_shape = tuple(distribution.batch_shape)

    def expand(p, trailing=()):
        # Broadcast the parameter to the distribution's full batch shape
        # plus its own trailing (event) dims first (a parameter may be a
        # batch-free constant), then insert the particle axis of a
        # BATCH_EXPANDED distribution.
        if not isinstance(p, torch.Tensor):
            p = torch.full((), p, dtype=u.dtype, device=u.device)
        p = torch.broadcast_to(p, batch_shape + tuple(trailing))
        if batch_expanded:
            p = p[:, None]
        return p

    if isinstance(distribution, dists.Deterministic):
        event = tuple(distribution.event_shape)
        value = expand(distribution.loc, event)
        return torch.broadcast_to(value,
                                  (batch_size, num_particles) + event)
    if isinstance(distribution, dists.Normal):
        z = _ndtri(u[..., 0])
        return expand(distribution.loc) + expand(distribution.scale) * z
    if isinstance(distribution, dists.MultivariateNormalDiag):
        z = _ndtri(u)
        d_ev = (z.shape[-1],)
        return (expand(distribution.loc, d_ev) +
                expand(distribution.scale_diag, d_ev) * z)
    if isinstance(distribution, dists.MultivariateNormalTriL):
        z = _ndtri(u)
        d_ev = (z.shape[-1],)
        loc = expand(distribution.loc, d_ev)
        tril = expand(distribution.scale_tril, d_ev + d_ev)
        return loc + torch.einsum(
            "...ij,...j->...i",
            torch.broadcast_to(tril, tuple(z.shape) + d_ev), z)
    if isinstance(distribution, dists.Independent):
        base = distribution.base
        if (isinstance(base, dists.Normal) and
                distribution.reinterpreted_batch_ndims == 1):
            z = _ndtri(u)
            d_ev = (z.shape[-1],)
            return expand(base.loc, d_ev) + expand(base.scale, d_ev) * z
        raise TypeError(
            "quantile_sample supports Independent(Normal, 1) only; "
            f"got Independent({type(base).__name__}, "
            f"{distribution.reinterpreted_batch_ndims})")
    if hasattr(distribution, "sample_from_uniforms"):
        return distribution.sample_from_uniforms(u)
    raise TypeError(
        f"{type(distribution).__name__} has no quantile transform: SQMC "
        "proposals must come from the location-scale Gaussian family "
        "(Normal / MultivariateNormalDiag / MultivariateNormalTriL / "
        "Independent(Normal, 1) / Deterministic) or define "
        "sample_from_uniforms(u).")


# ---------------------------------------------------------------------
# The SQMC particle filter.
# ---------------------------------------------------------------------

def _sorted_cdf(log_weight, sigma):
    """The normalized CDF `[B, K]` of the weights in the order ``sigma``:
    a cumulative sum made monotone by a running max, last entry not
    pinned."""
    logw_sorted = torch.take_along_dim(log_weight.detach(), sigma.long(),
                                       dim=1)
    w_sorted = amath.exponentiate_and_normalize(logw_sorted, dim=1)
    return torch.cummax(resampling._row_cumsum(w_sorted), dim=1).values


def _hilbert_ancestors(cdf, sigma, u_first, cuda: bool):
    """Ancestors `[B, K]` int32: the particle ``sigma[j]`` at the slot j of
    the CDF that each sorted position falls in. On the 'cuda' route one K3
    launch gathers the permutation as a float32 column; the 'torch' route
    is `torch.searchsorted` (right side, clamped to K - 1) and a gather,
    the same ancestors from the same CDF."""
    if cuda:
        _, anc = resample_sorted_cuda.resample_and_gather_sorted(
            cdf, u_first, sigma.to(torch.float32)[..., None],
            emit_idx=False)
        return anc[..., 0].to(torch.int32)
    pos = torch.searchsorted(cdf, u_first, right=True)
    pos = pos.clamp_(max=cdf.shape[1] - 1)
    return torch.take_along_dim(sigma, pos, dim=1)


def _check_implementation(device, num_particles, resampling_implementation):
    """Whether the kernel route applies; the JAX package's ValueError for
    a callable, and a ValueError for the kernel route above its K."""
    if callable(resampling_implementation):
        raise ValueError(
            "sqmc_infer's resampling scheme is the fixed Hilbert "
            "inverse-CDF; engine resampler callables do not apply. "
            "Use resampling_implementation='auto'|'torch'|'cuda'.")
    resolved = resampling.resolve_implementation(
        device, "systematic", resampling_implementation)
    use_cuda = resolved == "cuda"
    if use_cuda and num_particles > _MAX_KERNEL_PARTICLES:
        raise ValueError(
            f"sqmc_infer: K={num_particles} > 2^24 exceeds the kernel "
            "route, whose Hilbert permutation rides K3 as a float32 column "
            "(exact up to 2^24); use resampling_implementation='torch'.")
    return use_cuda


def sqmc_infer(observations,
               initial,
               transition,
               emission,
               proposal,
               num_particles: int,
               noise: Optional[NoiseSource] = None,
               hilbert_bits: Optional[int] = None,
               scramble: bool = True,
               resampling_implementation="auto",
               remat: bool = False,
               return_log_marginal_likelihood: bool = False,
               return_latents: bool = True,
               return_original_latents: bool = False,
               return_log_weight: bool = True,
               return_log_weights: bool = False,
               return_ancestral_indices: bool = False) -> dict:
    """SQMC particle filter (Gerber & Chopin 2015, Algorithm 2).

    The component contract, return vocabulary and log-Z estimator of
    `inference.infer('smc', ...)` with resampling at every step; only the
    randomness differs. Each time step and batch row takes its own
    scrambled Sobol point set, drawn from ``noise`` (default
    `NoiseSource.seeded(0)` on the observations' device) as
    `bits([B, dim, 32])` then `bits([B, dim])`: the first coordinate
    drives inverse-CDF resampling of the Hilbert-ordered particles, the
    other d the proposal's quantile transform.

    Proposals must be quantile-transformable (`quantile_sample`), latents
    single tensors (no dict latents), and the resampling scheme is the
    Hilbert inverse CDF. The estimator is unbiased over scrambles; take K
    a power of two for the full RQMC balance.

    ``resampling_implementation``: 'auto' | 'torch' | 'cuda'. 'cuda' runs
    each step's search and ancestor gather as one K3 launch (the sorted
    RQMC positions are its position contract), 'torch' as
    `torch.searchsorted` and a gather; the ancestors are the same. 'auto'
    is 'cuda' for CUDA tensors. Above K = 2^24 the 'cuda' route (and
    'auto' on CUDA tensors) raises ValueError; a callable raises
    ValueError. ``remat``
    recomputes each step on the backward pass (`torch.utils.checkpoint`),
    with the step's draws handed to the recompute.

    Returns the `infer` dict: log_marginal_likelihood `[B]`, latents
    (lineage-traced), original_latents, log_weight `[B, K]`, log_weights
    `[T, B, K]`, ancestral_indices `[T-1, B, K]`, last_latent.
    """
    stacked_obs = _inference.stack_observations(observations)
    obs_seq = _inference.ObservationSequence(stacked_obs)
    num_timesteps = len(obs_seq)
    first = _inference._first_leaf(stacked_obs)
    batch_size = first.shape[1]
    if noise is None:
        noise = NoiseSource.seeded(0, first.device)
    log_num_particles = _stdmath.log(num_particles)

    def row_points(dim, source):
        return sobol_points(num_particles, dim, source, scramble=scramble,
                            batch_shape=(batch_size,), device=first.device)

    # ---- t = 0.
    proposal_dist = proposal(time=0, observations=obs_seq)
    d0 = max(event_size(proposal_dist), 1)
    u0 = row_points(d0, noise)                              # [B, K, d0]
    latent_0 = quantile_sample(proposal_dist, batch_size, num_particles,
                               u0)
    proposal_log_prob = state.log_prob(proposal_dist, latent_0)
    initial_log_prob = state.log_prob(initial(), latent_0)
    emission_log_prob = state.log_prob(
        emission(latents=[latent_0], time=0),
        state.expand_observation(obs_seq[0], num_particles))
    log_weight_0 = initial_log_prob + emission_log_prob - proposal_log_prob
    if not isinstance(latent_0, torch.Tensor):
        raise TypeError("sqmc_infer requires array latents (the Hilbert "
                        "sort has no order for dict latents)")

    use_cuda = (_check_implementation(first.device, num_particles,
                                      resampling_implementation)
                if num_timesteps > 1 else False)

    def step(t, prev_latent, prev_log_weight, source):
        time = _inference.TimeIndex(t)
        pts = row_points(1 + d0, source)                    # [B, K, 1+d0]
        sigma = hilbert_sort_indices(prev_latent, bits=hilbert_bits)
        order = torch.argsort(pts[..., 0], dim=-1, stable=True)
        u_first = torch.take_along_dim(pts[..., 0], order, dim=-1)
        u_rest = torch.take_along_dim(pts[..., 1:], order[..., None],
                                      dim=1)
        ancestral_index = _hilbert_ancestors(
            _sorted_cdf(prev_log_weight, sigma), sigma, u_first, use_cuda)
        previous_latent = state.resample(prev_latent, ancestral_index)
        proposal_dist = proposal(previous_latents=[previous_latent],
                                 time=time, observations=obs_seq)
        latent_t = quantile_sample(proposal_dist, batch_size, num_particles,
                                   u_rest)
        proposal_lp = state.log_prob(proposal_dist, latent_t)
        transition_lp = state.log_prob(
            transition(previous_latents=[previous_latent], time=time,
                       previous_observations=[obs_seq[t - 1]]),
            latent_t)
        emission_lp = state.log_prob(
            emission(latents=[latent_t], time=time,
                     previous_observations=[obs_seq[t - 1]]),
            state.expand_observation(obs_seq[t], num_particles))
        log_weight_t = transition_lp + emission_lp - proposal_lp
        contribution = (torch.logsumexp(prev_log_weight, dim=1) -
                        log_num_particles)
        return latent_t, log_weight_t, ancestral_index, contribution

    def remat_step(t, prev_latent, prev_log_weight, tape):
        tape.rewind()
        return step(t, prev_latent, prev_log_weight, tape)

    latents, log_weights, ancestors, contributions = (
        [latent_0], [log_weight_0], [], [])
    prev_latent, prev_log_weight = latent_0, log_weight_0
    for t in range(1, num_timesteps):
        if remat:
            out = _checkpoint.checkpoint(
                remat_step, t, prev_latent, prev_log_weight,
                _inference._NoiseTape(noise), use_reentrant=False,
                preserve_rng_state=False)
        else:
            out = step(t, prev_latent, prev_log_weight, noise)
        prev_latent, prev_log_weight, ancestral_index, contribution = out
        latents.append(prev_latent)
        log_weights.append(prev_log_weight)
        ancestors.append(ancestral_index)
        contributions.append(contribution)

    ancestral_indices = (
        torch.stack(ancestors, dim=0) if ancestors else
        torch.zeros((0, batch_size, num_particles), dtype=torch.int32,
                    device=first.device))
    need_original = return_latents or return_original_latents
    original_latents = (_inference._stack_time(latents) if need_original
                        else None)
    log_marginal_likelihood = None
    if return_log_marginal_likelihood:
        summed = (_inference._sum_in_order(contributions) if contributions
                  else 0.0)
        log_marginal_likelihood = (
            summed + torch.logsumexp(prev_log_weight, dim=1) -
            log_num_particles)
    return {
        "log_marginal_likelihood": log_marginal_likelihood,
        "latents": (get_resampled_latents(original_latents,
                                          ancestral_indices)
                    if return_latents else None),
        "original_latents":
            original_latents if return_original_latents else None,
        "log_weight": prev_log_weight if return_log_weight else None,
        "log_weights": (_inference._stack_time(log_weights)
                        if return_log_weights else None),
        "ancestral_indices":
            ancestral_indices if return_ancestral_indices else None,
        "last_latent": prev_latent,
    }


def get_resampled_latents(original_latents, ancestral_indices):
    """Lineage-traced latents (the engine's tracer,
    `inference.get_resampled_latents`)."""
    return _inference.get_resampled_latents(original_latents,
                                            ancestral_indices)
