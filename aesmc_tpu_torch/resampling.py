"""Particle resampling, on the tensors' device.

Counterpart of `aesmc_tpu.resampling`:

    normalize -> cumulative sum -> sorted positions -> inverse-CDF search

with ancestor indices detached and the CDF made monotone and pinned to 1.0
at its end, exactly as the JAX package does. Noise comes from a
`noise.NoiseSource`: one uniform a row (systematic), one a stratum
(stratified), one a slot (residual), or K + 1 exponentials a row whose
normalized cumulative sums are the sorted multinomial draws.

Methods: systematic, stratified, multinomial and residual (Liu & Chen:
floor(K w_i) copies of particle i, the rest drawn from the residual
weights), and soft resampling (Karkus et al.: ancestors drawn
multinomially from the tempered mixture q = alpha w + (1 - alpha) / K,
next weights corrected by w[a] / q[a], so that gradients reach the
weights).

Two implementations:
- 'cuda': the hand-written kernels, for CUDA tensors only: the fused
  systematic resample+gather (`ops.resample_cuda`, K1), the search +
  gather over loaded positions (`ops.resample_sorted_cuda`, K3: stratified,
  multinomial and soft, whose two weight columns ride the launch beside
  the particles) and, where only indices are needed, the index-only
  search of loaded positions (`ops.searchsorted_sorted_cuda`, K4); the
  backward of K1 and K3 is the range sum (`ops.range_sum_cuda`, K2).
  Float32 particles ride K1 or K3; particles of any other dtype (the
  HMM's int32 states) are gathered apart by the ancestor indices through
  the sorted gather (`ops.gather_sorted_cuda`, K5), which moves every
  dtype bit for bit and is forward-only. Residual resampling has no
  kernel (its query set is not a monotone position grid, nor in the JAX
  package) and raises here;
- 'torch': plain PyTorch ops, on any device. At K <= `DENSE_GATHER_MAX_K`
  with floating-point particles it takes the JAX 'xla' route's dense
  one-hot gather (`dense_indices_and_gather`): one compare gives the
  indices and a one-hot selector whose batched matmul gathers the
  particles and whose transpose is the backward, with no scatter.
'auto' picks 'cuda' for a CUDA tensor and 'torch' otherwise, at every K,
and 'torch' for residual resampling: on an H100 the dense route's graphed
train step at (T, B) = (200, 10) was slower than the kernels' at K = 256
to 1,024 and kept the card busy 3 ms a step longer at K = 100
(`chip_smoke.py` phases 8 and 14, `PERF.md`).
"""

from __future__ import annotations

import math as _stdmath

import torch

from . import math as amath
from .ops import (gather_sorted_cuda, resample_cuda, resample_sorted_cuda,
                  searchsorted_sorted_cuda)

METHODS = ("systematic", "stratified", "multinomial", "residual")
IMPLEMENTATIONS = ("auto", "cuda", "torch")

# The 'torch' route gathers float particles with the dense one-hot matmul
# up to this K, as the JAX package's 'xla' route does: the [B, K, K]
# selector costs O(K^2) memory a step.
DENSE_GATHER_MAX_K = 1024


def _check_nan_eager(log_weight):
    """FloatingPointError on NaN log-weights. This waits for the device, so
    only the public entry points call it, never `infer`'s time loop."""
    if bool(torch.isnan(log_weight).any()):
        raise FloatingPointError("log_weight contains nan element(s)")


def _check_method(method, methods=METHODS):
    if method not in methods:
        raise ValueError(
            f"method must be one of {methods}. currently = {method}")


# The width of the first level of `_two_level_cumsum`.
_SCAN_CHUNK = 512


def _row_cumsum(x):
    """``torch.cumsum(x, dim=-1)`` for `[B, K]` ``x``, with the same bits on
    every run on the card. PyTorch hands a tensor of one row on a card to
    CUB's single-pass scan, whose float32 sums vary from run to run (so
    the same noise could draw other ancestors); rows of two or more go to
    its per-row scan, whose sums do not. One row on a card is therefore
    scanned in two levels (`_two_level_cumsum`)."""
    if x.is_cuda and x.shape[0] == 1:
        return _two_level_cumsum(x)
    return torch.cumsum(x, dim=-1)


def _two_level_cumsum(x):
    """The cumulative sum of one row `[1, K]` as chunks of `_SCAN_CHUNK`
    (zero-padded), each a row of a per-row scan, plus the exclusive sums
    of the chunks' totals, scanned as two equal rows."""
    k = x.shape[1]
    chunks = max(2, -(-k // _SCAN_CHUNK))
    width = -(-k // chunks)
    inner = torch.cumsum(torch.nn.functional.pad(
        x, (0, chunks * width - k)).reshape(chunks, width), dim=-1)
    totals = torch.cat([torch.zeros_like(inner[:1, -1]), inner[:-1, -1]])
    offsets = torch.cumsum(torch.stack([totals, totals]), dim=-1)[0]
    return (inner + offsets[:, None]).reshape(1, -1)[:, :k]


def _normalized_cumsum(log_weight):
    """`[B, K]` log-weights -> `[B, K]` normalized CDF.

    The cumulative sum (`_row_cumsum`) is made monotone with a running
    max, divided by its last entry, and the last entry is then pinned to
    exactly 1.0, so that every position (strictly below 1) has a strictly
    greater CDF entry.
    """
    w = amath.exponentiate_and_normalize(log_weight, dim=-1)
    cum = torch.cummax(_row_cumsum(w), dim=-1).values
    cum = cum / cum[:, -1:]
    return _pin_last(cum)


def _pin_last(cum):
    """``cum`` with its last entry set to exactly 1.0 (a concatenation)."""
    return torch.cat([cum[:, :-1], torch.ones_like(cum[:, -1:])], dim=1)


def resampling_positions(log_weight, noise, method: str = "systematic"):
    """The sorted inverse-CDF query positions `[B, K]`, clamped strictly
    below 1.0:

    - systematic: ``(u + j) / K`` with one uniform ``u`` a row;
    - stratified: ``(u_j + j) / K`` with one uniform a stratum;
    - multinomial: ``S_j / S_K`` for the cumulative sums S of K + 1 iid
      Exp(1) draws: the order statistics of K iid uniforms.
    """
    _check_method(method, ("systematic", "stratified", "multinomial"))
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
    s = torch.cummax(_row_cumsum(noise.exponential((batch_size, k + 1))),
                     dim=-1).values
    return torch.clamp(s[:, :-1] / s[:, -1:],
                       max=resample_cuda.BELOW_ONE)


def inverse_cdf_indices(log_weight, pos):
    """The slots `[B, Kp]` int32 of the positions ``pos`` `[B, Kp]` in the
    normalized CDF of ``log_weight`` `[B, K]`: `torch.searchsorted` on the
    right side, clamped to K - 1. The positions need not be sorted."""
    cum = _normalized_cumsum(log_weight)
    idx = torch.searchsorted(cum, pos.to(cum.dtype), right=True)
    return idx.clamp_(max=log_weight.shape[-1] - 1).to(torch.int32)


def _indices(log_weight, noise, method):
    if method == "residual":
        return residual_indices(log_weight, noise)
    return inverse_cdf_indices(
        log_weight, resampling_positions(log_weight, noise, method))


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


def residual_indices(log_weight, noise):
    """Residual ancestor indices `[B, K]` int32, sorted.

    Particle i gets floor(K w_i) copies; the remaining R = K - sum of the
    floors slots are iid draws from the residual weights r_i propto
    K w_i - floor(K w_i). As in the JAX package, slot s takes the
    deterministic index (the search of ``s + 0.5`` in the cumulative
    copies) while s < C, the row's deterministic total, and a draw of the
    residual CDF (made monotone, its last entry pinned to 1.0) at its own
    uniform otherwise; the result is sorted. One uniform a slot.
    """
    batch_size, k = log_weight.shape
    w = amath.exponentiate_and_normalize(log_weight, dim=-1)
    kw = k * w
    copies = torch.floor(kw)
    cum_copies = torch.cumsum(copies, dim=1)
    det_total = cum_copies[:, -1:]
    slots = torch.arange(k, dtype=cum_copies.dtype,
                         device=log_weight.device).expand(batch_size, k)
    det_idx = torch.searchsorted(cum_copies, slots + 0.5, right=True)
    residual = kw - copies
    res_total = torch.clamp(k - det_total, min=1e-30)
    cum_res = _pin_last(torch.cummax(
        torch.cumsum(residual / res_total, dim=1), dim=1).values)
    u = noise.uniform((batch_size, k))
    res_idx = torch.searchsorted(cum_res, u, right=True)
    idx = torch.where(slots < det_total, det_idx, res_idx)
    idx = idx.clamp_(0, k - 1).to(torch.int32)
    return torch.sort(idx, dim=1).values


def resolve_implementation(device, method: str, implementation: str) -> str:
    """'auto' -> 'cuda' for a CUDA device, 'torch' otherwise, and 'torch'
    for residual resampling (no kernel). Explicit strings pass through;
    'cuda' for a tensor off the card, or for residual, raises. ``method``
    may also be 'soft', which resolves as multinomial does."""
    _check_method(method, METHODS + ("soft",))
    if method == "residual":
        if implementation == "cuda":
            raise ValueError(
                "residual resampling has no fused kernel path (its query "
                "set is not a monotone position grid); use "
                "implementation='torch' or 'auto'")
        _route(device, implementation)
        return "torch"
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
    Residual resampling runs torch ops on every device.
    """
    _check_method(method)
    if log_weight.ndim != 2:
        raise ValueError(
            f"log_weight must be [batch, particles]. Got "
            f"{tuple(log_weight.shape)}")
    _check_nan_eager(log_weight)
    implementation = resolve_implementation(log_weight.device, method,
                                            implementation)
    return sample_indices(log_weight, noise, method, implementation)


def sample_indices(log_weight, noise, method, implementation):
    """`sample_ancestral_index` without its eager checks, for the filters'
    time loops: ``implementation`` is already resolved ('torch' or
    'cuda', by `resolve_implementation`), and nothing is read from the
    device, so a loop that calls it can be captured in a CUDA graph."""
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


def _exact_matmul(a, b):
    """``a @ b`` at full float32 precision whatever
    `torch.set_float32_matmul_precision` the caller set: TF32 or bfloat16
    would round the particles the one-hot selector passes through."""
    precision = torch.get_float32_matmul_precision()
    if precision == "highest":
        return torch.matmul(a, b)
    torch.set_float32_matmul_precision("highest")
    try:
        return torch.matmul(a, b)
    finally:
        torch.set_float32_matmul_precision(precision)


class _DenseGather(torch.autograd.Function):
    """``sel @ leaf`` over the particle axis for a one-hot selector ``sel``
    `[B, Kp, K]`; the backward is the transposed product (no scatter)."""

    @staticmethod
    def forward(ctx, sel, leaf):
        batch, k = leaf.shape[:2]
        flat = leaf.reshape(batch, k, -1)
        sel = sel.to(flat.dtype)
        ctx.save_for_backward(sel)
        ctx.leaf_shape = tuple(leaf.shape)
        out = _exact_matmul(sel, flat)
        return out.reshape((batch, sel.shape[1]) + tuple(leaf.shape[2:]))

    @staticmethod
    def backward(ctx, grad_out):
        (sel,) = ctx.saved_tensors
        batch, kp = grad_out.shape[:2]
        grad = _exact_matmul(sel.transpose(1, 2),
                             grad_out.reshape(batch, kp, -1).to(sel.dtype))
        return None, grad.reshape(ctx.leaf_shape)


def dense_indices_and_gather(log_weight, pos, value):
    """Search and differentiable gather through one dense compare, the JAX
    package's dense route.

    ``le[b, j, i] = cdf[b, i] <= pos[b, j]`` gives both outputs: the
    ancestor index ``sum_i le[b, j, i]`` (searchsorted, side 'right',
    clamped to K - 1) and the one-hot selector ``le[i - 1] - le[i]``,
    whose batched matmul with the particles passes them through bit for
    bit (`_exact_matmul`: one nonzero product a slot) and whose transpose
    is the backward.

    Args:
        log_weight: `[B, K]` (detached by the callers).
        pos: `[B, Kp]` sorted positions in [0, 1).
        value: a `[B, K, ...]` floating-point tensor or a dict of them.

    Returns:
        (idx `[B, Kp]` int32, gathered value `[B, Kp, ...]`).
    """
    cdf = _normalized_cumsum(log_weight)
    k = cdf.shape[-1]
    le = cdf[:, None, :] <= pos[:, :, None]                  # [B, Kp, K]
    idx = le.sum(dim=-1, dtype=torch.int32).clamp_(max=k - 1)
    lef = le.to(cdf.dtype)
    le_prev = torch.cat([torch.ones_like(lef[:, :, :1]), lef[:, :, :-1]],
                        dim=-1)
    sel = le_prev - lef                                      # one-hot rows
    return idx, _unflatten(value, iter(
        [_DenseGather.apply(sel, leaf) for leaf in _leaves(value)]))


def _search_gather(cdf, value, cuda, need_indices, u=None, pos=None,
                   columns=()):
    """K1 (given the row uniforms ``u``) or K3 (given sorted positions
    ``pos``) over the float32 leaves of ``value`` and the extra `[B, K]`
    float32 ``columns``, as the columns of one `[B, K, D]` tensor; every
    other leaf through K5 with the indices the launch emitted, which it
    then emits even when ``need_indices`` is False. With no column at all
    K1 finds the indices alone, and the sorted search is K4's. On the
    'torch' route the plain versions of the same kernels.

    Returns (indices or None, gathered value (None for a None ``value``),
    list of the gathered columns, each `[B, Kp]`).
    """
    batch_size, k = cdf.shape
    leaves = [] if value is None else _leaves(value)
    fused = [leaf.reshape(batch_size, k, -1) for leaf in leaves
             if _fused(leaf)] + [c.unsqueeze(-1) for c in columns]
    apart = [leaf for leaf in leaves if not _fused(leaf)]
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
    if u is not None:
        if flat is None:
            flat = _no_columns(cdf)
        if cuda:
            idx, gathered = resample_cuda.resample_and_gather_systematic(
                cdf, u, flat.contiguous(), emit_idx=emit_idx)
        else:
            idx, gathered = \
                resample_cuda.resample_and_gather_systematic_torch(
                    cdf, u, flat, emit_idx=emit_idx)
    elif flat is None:
        # Indices only: K4 on the 'cuda' route.
        search = (searchsorted_sorted_cuda.searchsorted_sorted if cuda
                  else searchsorted_sorted_cuda.searchsorted_sorted_torch)
        idx, gathered = search(cdf, pos), None
    elif cuda:
        idx, gathered = resample_sorted_cuda.resample_and_gather_sorted(
            cdf, pos, flat.contiguous(), emit_idx=emit_idx)
    else:
        idx, gathered = resample_sorted_cuda.resample_and_gather_sorted_torch(
            cdf, pos, flat, emit_idx=emit_idx)
    gathered_apart = iter(_gather_apart(apart, idx, cuda))
    out, start = [], 0
    for leaf in leaves:
        if _fused(leaf):
            width = _stdmath.prod(leaf.shape[2:])
            out.append(gathered[:, :, start:start + width].reshape(
                (batch_size, gathered.shape[1]) + tuple(leaf.shape[2:])))
            start += width
        else:
            out.append(next(gathered_apart))
    extra = [gathered[:, :, start + i] for i in range(len(columns))]
    value_out = None if value is None else _unflatten(value, iter(out))
    return (idx if need_indices else None), value_out, extra


def _resample(log_weight, noise, value, method, implementation,
              need_indices):
    """The resampling step of `infer`: no NaN check (it would wait for the
    device at every step). ``implementation`` is 'cuda' or 'torch'.

    Float32 leaves go through K1 (systematic) or K3 as the columns of one
    `[B, K, D]` tensor; every other leaf through K5 with the indices K1 or
    K3 emitted, which they then emit even when ``need_indices`` is False
    (the returned indices still follow ``need_indices``). With no float32
    leaf, stratified and multinomial find the indices with K4. The
    'torch' route takes the dense one-hot gather at K <=
    `DENSE_GATHER_MAX_K` when every leaf is floating point, and residual
    resampling gathers with `take_along_dim`."""
    log_weight = log_weight.detach()
    batch_size, k = log_weight.shape
    cuda = implementation == "cuda"
    if method == "residual":
        idx = residual_indices(log_weight, noise)
        out = _unflatten(value, iter(_gather_apart(_leaves(value), idx,
                                                   False)))
        return (idx if need_indices else None), out
    if (not cuda and k <= DENSE_GATHER_MAX_K and
            all(leaf.is_floating_point() for leaf in _leaves(value))):
        pos = resampling_positions(log_weight, noise, method)
        idx, out = dense_indices_and_gather(log_weight, pos, value)
        return (idx if need_indices else None), out
    cdf = _normalized_cumsum(log_weight)
    if method == "systematic":
        # K1 builds the positions itself from one uniform a row.
        u, pos = noise.uniform((batch_size, 1)), None
    else:
        u, pos = None, resampling_positions(log_weight, noise, method)
    idx, out, _ = _search_gather(cdf, value, cuda, need_indices, u=u,
                                 pos=pos)
    return idx, out


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
    such a leaf that requires a gradient raises ValueError). On the
    'torch' route floating-point particles at K <= `DENSE_GATHER_MAX_K`
    take the dense one-hot gather. With ``need_indices=False`` indices
    come back None, and the kernel skips its index output unless a leaf
    needs K5.

    Returns (indices `[B, K]` int32 - detached - or None, resampled value).
    """
    _check_method(method)
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


def _soft_tempered_log_weights(log_weight, alpha: float):
    """(log_w, log_q) for soft resampling: the normalized log-weights and
    the tempered mixture q = alpha w + (1 - alpha) / K, in log space
    (underflowed weights would make log(w[a]) -inf and its gradient NaN).
    The constants are float32 logs on the device, as the JAX package
    computes them, made by fills (a copy from the host could not be
    captured in a CUDA graph)."""
    k = log_weight.shape[1]
    log_w = amath.lognormexp(log_weight, dim=-1)
    if alpha >= 1.0:
        return log_w, log_w

    def log_const(x):
        return torch.log(torch.full((), x, dtype=log_w.dtype,
                                    device=log_w.device))

    log_q = torch.logaddexp(log_const(alpha) + log_w,
                            log_const((1.0 - alpha) / k).expand_as(log_w))
    return log_w, log_q


def soft_indices_and_weights(log_weight, noise, alpha: float = 0.5):
    """Soft resampling's ancestors and corrected weights, unfused.

    Samples ancestors multinomially from q = alpha w + (1 - alpha) / K and
    returns the corrected next-step log-weights log(w[a] / q[a]),
    differentiable in ``log_weight`` through log w[a] (log q[a] is
    detached). Torch ops on any device.

    Returns (indices `[B, K]` int32 - detached - , corrected `[B, K]`).
    """
    log_w, log_q = _soft_tempered_log_weights(log_weight, alpha)
    idx = multinomial_indices(log_q.detach(), noise)
    index = idx.long()
    log_w_sel = torch.take_along_dim(log_w, index, dim=1)
    log_q_sel = torch.take_along_dim(log_q.detach(), index, dim=1)
    return idx, log_w_sel - log_q_sel


def soft_resample_and_gather(log_weight, noise, value, alpha: float = 0.5,
                             implementation: str = "auto",
                             need_indices: bool = True):
    """Soft resampling with the particle gather fused into K3.

    The estimator of `soft_indices_and_weights` plus the particle gather.
    On the 'cuda' route one K3 launch searches the multinomial positions
    in the CDF of q and gathers the float32 particle columns and the two
    weight columns log w and log q together; the gradient reaches
    ``log_weight`` through the gathered log w column (K3's backward, K2)
    and the particles through theirs. Leaves of other dtypes go through
    K5. The 'torch' route is the unfused formula: the multinomial search,
    then `take_along_dim`.

    Returns (indices - detached - or None without ``need_indices`` on the
    'cuda' route, corrected log-weights `[B, K]`, resampled value).
    """
    _check_nan_eager(log_weight)
    implementation = resolve_implementation(log_weight.device, "soft",
                                            implementation)
    return _soft_resample(log_weight, noise, value, alpha, implementation,
                          need_indices)


def _soft_resample(log_weight, noise, value, alpha, implementation,
                   need_indices):
    """`soft_resample_and_gather` without its checks; ``value`` may be None
    (nothing gathered but the weights)."""
    log_w, log_q = _soft_tempered_log_weights(log_weight, alpha)
    lq_det = log_q.detach()
    if implementation == "cuda":
        cdf = _normalized_cumsum(lq_det)
        pos = resampling_positions(lq_det, noise, "multinomial")
        idx, out, (log_w_sel, log_q_sel) = _search_gather(
            cdf, value, True, need_indices, pos=pos, columns=(log_w, lq_det))
        return idx, log_w_sel - log_q_sel, out
    idx = multinomial_indices(lq_det, noise)
    index = idx.long()
    corrected = (torch.take_along_dim(log_w, index, dim=1) -
                 torch.take_along_dim(lq_det, index, dim=1))
    out = (None if value is None else _unflatten(value, iter(
        _gather_apart(_leaves(value), idx, False))))
    return idx, corrected, out
