"""Resampling over a particle axis sharded across ranks.

Counterpart of `aesmc_tpu.parallel.dist_resampling` (the OT resampler
wraps `ot.distributed_ot_resample`, the ring-streamed Sinkhorn). Systematic,
stratified and multinomial resampling need the GLOBAL cumulative weight
distribution, while the weights and particles live in blocks on the
ranks of the particle group. Per batch row, with K particles over n
ranks of K_l = K / n:

1. normalization: the weights exp(lw - lse) with the logsumexp over the
   whole axis (`math.distributed_logsumexp`, or the engine's log-Z term,
   which is the same logsumexp);
2. a rank's slice of the global CDF: its local cumulative sum (made
   monotone with a running max; the shard sum is its LAST entry) plus
   the exclusive prefix of the n shard sums, over the total;
3. the sorted query positions of the output slots this rank OWNS
   (`[p K_l, (p + 1) K_l)`), drawn over the GLOBAL grid and sliced;
4. the exchange, two ways:
   - 'allgather': gather the local scans (every rank then forms every
     slice of step 2 itself) and the particles, then one search + gather
     over the global CDF (kernel K3 on the card: a `[B_l, K]` CDF against
     `[B_l, K_l]` positions; K4 for indices only; K5 for particles that
     are not float32);
   - 'ring': each rank's (CDF slice, particles) travel around the ring;
     at each of the n visits a rank searches and gathers only the
     positions whose mass falls inside the visiting slice (K3 on `[B_l,
     K_l]` slices, n launches a step). Live memory O(K / n) a rank, the
     same indices and values as 'allgather' bit for bit: the shard sums
     come from one gather of n scalars a row, and the ownership masks use
     the slices' upper edges, which every rank computes from them with
     the arithmetic of the gathered CDF.

The arithmetic of steps 1-2 is that of `resampling._normalized_cumsum`
with the cumulative sum cut at the shard edges: over one rank it gives
that CDF bit for bit (on the card the single-device 'cuda' route sums
its CDF in the CDF kernel's order instead, `ops.normalized_cdf_cuda`).
Its last edge is pinned to 1.0.

Residual resampling (`distributed_residual_resample`, which `infer`
makes for 'residual' with a mesh; `make_distributed_fused_resampler`
refuses it, as the JAX package's factory does) exchanges no CDF: its
result is sorted, so each source's count of copies determines it. One
packed gather brings the rows' log-weights (every rank then computes the
copies and the residual CDF with the single-device arithmetic) and the
float32 particles; each rank searches its slots' residual draws (K4),
the ranks sum the draws' histograms in int32, and a rank's slots are
searched in the cumulative counts: K3 with the particle gather (K2
backward), K4 for indices only, K5 for other dtypes.

Noise. A function here takes the step's source: the positions are drawn
from its replicated state (`noise.ShardNoise.replicated`, or the source
itself), which every rank must hold alike, at the single-device run's
global shapes: `[B, 1]` uniforms (systematic), `[B, K]` (stratified and
residual) or `[B, K + 1]` exponentials (multinomial).

Gradients. Indices are detached. The exchanged values are
differentiable: through the gather (`collectives.all_gather`, whose
backward sums the ranks' cotangents) or the ring's shifts, and through
K3, whose backward is the range sum K2 over the gathered CDF.
"""

from __future__ import annotations

import torch

from .. import math as amath
from .. import resampling as _resampling
from ..noise import ShardNoise
from ..ops import resample_cuda
from . import collectives

__all__ = [
    "distributed_resampling_indices", "distributed_systematic_indices",
    "distributed_resample_particles", "distributed_systematic_resample",
    "distributed_systematic_resample_streaming", "distributed_soft_resample",
    "make_distributed_resampler", "make_distributed_systematic_resampler",
    "make_distributed_fused_resampler", "make_distributed_ot_resampler",
]

METHODS = ("systematic", "stratified", "multinomial")
EXCHANGES = ("allgather", "ring")


def _replicated(noise):
    return noise.replicated if isinstance(noise, ShardNoise) else noise


def _rows(data_group, batch_size):
    """(first global row, global batch size) of this rank's rows."""
    if data_group is None:
        return 0, batch_size
    return (collectives.rank_in(data_group) * batch_size,
            collectives.size(data_group) * batch_size)


def _sequential_prefix(sums):
    """(exclusive prefixes `[n, B]`, total `[B]`) of the shard sums `[n, B]`,
    added one shard at a time: the same floats on every rank, and
    prefix[d] + sums[d] == prefix[d + 1] exactly, so the slices join
    monotonically."""
    prefixes = [torch.zeros_like(sums[0])]
    for d in range(sums.shape[0]):
        prefixes.append(prefixes[-1] + sums[d])
    return torch.stack(prefixes[:-1]), prefixes[-1]


def _local_cumsum(w):
    """The monotone local cumulative sum `[B, K_l]` and its last entry."""
    cum = torch.cummax(_resampling._row_cumsum(w), dim=-1).values
    return cum, cum[:, -1]


def _distributed_positions(noise, method, batch_size, k_local, group,
                           data_group):
    """This rank's slice `[B_l, K_l]` of the global sorted positions of
    `resampling.resampling_positions`, drawn over the global `[B, K]`
    grid from the replicated source (so a mesh run draws what the
    single-device run draws). Sorted within the slice for every method."""
    n, p = collectives.size(group), collectives.rank_in(group)
    k_global = k_local * n
    row0, b_global = _rows(data_group, batch_size)
    rows = slice(row0, row0 + batch_size)
    cols = slice(p * k_local, (p + 1) * k_local)
    source = _replicated(noise)
    if method in ("systematic", "stratified"):
        width = 1 if method == "systematic" else k_global
        u = source.uniform((b_global, width))[rows]
        if method == "stratified":
            u = u[:, cols]
        grid = u + torch.arange(p * k_local, (p + 1) * k_local,
                                dtype=torch.float32, device=u.device)
        kf = torch.full((), float(k_global), dtype=torch.float32,
                        device=u.device)
        return torch.clamp(grid / kf, max=resample_cuda.BELOW_ONE)
    if method != "multinomial":
        raise ValueError(f"unsupported method: {method}")
    # Order statistics by exponential spacings, S_j / S_{K+1}: each rank
    # scans its slice; the shard prefix and the total (with the extra
    # K+1-th draw) come from one gather of n scalars a row.
    e = source.exponential((b_global, k_global + 1))[rows]
    local_cs, local_sum = _local_cumsum(e[:, cols])
    sums = collectives.all_gather(local_sum[None], group, dim=0)  # [n, B]
    prefix, total = _sequential_prefix(sums)
    total = total + e[:, k_global]
    pos = (prefix[p][:, None] + local_cs) / total[:, None]
    return torch.clamp(pos, max=resample_cuda.BELOW_ONE)


def _local_cdf(log_weight, group, log_sum=None):
    """The monotone local scan `[B_l, K_l]` of the normalized weights
    exp(lw - lse), the logsumexp over the whole particle axis (``log_sum``
    `[B_l]` if the caller has it)."""
    log_weight = log_weight.detach()
    if log_sum is None:
        log_sum = amath.distributed_logsumexp(log_weight, group, dim=1)
    w = torch.exp(log_weight - log_sum.detach()[:, None])
    return _local_cumsum(w)


def _cdf_slices(log_weight, group, log_sum=None):
    """This rank's slice `[B_l, K_l]` of the normalized global CDF (last
    edge not yet pinned) and the upper edges `[n, B_l]` of every rank's
    slice, the same floats on every rank."""
    local_cum, local_sum = _local_cdf(log_weight, group, log_sum)
    sums = collectives.all_gather(local_sum[None], group, dim=0)  # [n, B]
    prefix, total = _sequential_prefix(sums)
    p = collectives.rank_in(group)
    cdf = (prefix[p][:, None] + local_cum) / total[:, None]
    edges = (prefix + sums) / total
    return cdf, edges


def _pin_global_last(cdf, group):
    """A ring slice of the CDF with the global last edge (the last rank's
    last entry) pinned to 1.0, as the gathered CDF's is: every position,
    below 1, then has a strictly greater edge."""
    if collectives.rank_in(group) == collectives.size(group) - 1:
        return _resampling._pin_last(cdf)
    return cdf


def _cuda(tensor) -> bool:
    return _resampling._route(tensor.device, "auto") == "cuda"


def _gathered_cdf(scans, n):
    """The global CDF `[B_l, K]` (last edge 1.0) from every rank's local
    scan, gathered `[B_l, K]`: each slice formed as `_cdf_slices` forms a
    rank's own, the same floats."""
    batch_size, k = scans.shape
    blocks = scans.reshape(batch_size, n, k // n)
    prefix, total = _sequential_prefix(blocks[:, :, -1].T)      # [n, B]
    cdf = (prefix.T[:, :, None] + blocks) / total[:, None, None]
    return _resampling._pin_last(cdf.reshape(batch_size, k))


def distributed_resampling_indices(log_weight, noise, group,
                                   data_group=None,
                                   method: str = "systematic",
                                   log_sum=None):
    """Ancestor indices for this rank's output slots.

    Args:
        log_weight: this rank's block `[B_l, K_l]` of the `[B, K]`
            unnormalized log-weights.
        noise: the step's source; its replicated state must be the same
            on every rank.
        group: the particle axis's process group.
        data_group: the data axis's process group, or None (batch not
            sharded).
        method: 'systematic', 'stratified' or 'multinomial'.
        log_sum: the logsumexp `[B_l]` of the whole particle axis, if the
            caller has it (the engine's log-Z term); else computed.

    Returns:
        `[B_l, K_l]` int32 GLOBAL ancestor indices of the slots `[p K_l,
        (p + 1) K_l)` (kernel K4 on the card).
    """
    batch_size, k_local = log_weight.shape
    local_cum, _ = _local_cdf(log_weight, group, log_sum)
    global_cdf = _gathered_cdf(collectives.all_gather(local_cum, group,
                                                      dim=1),
                               collectives.size(group))
    pos = _distributed_positions(noise, method, batch_size, k_local, group,
                                 data_group)
    search = (_resampling.searchsorted_sorted_cuda.searchsorted_sorted
              if _cuda(global_cdf) else
              _resampling.searchsorted_sorted_cuda.searchsorted_sorted_torch)
    return search(global_cdf, pos)


def distributed_systematic_indices(log_weight, noise, group,
                                   data_group=None):
    """Systematic special case of `distributed_resampling_indices`."""
    return distributed_resampling_indices(log_weight, noise, group,
                                          data_group, "systematic")


def distributed_resample_particles(value, global_index, group):
    """Redistributes particles to globally indexed output slots: each leaf
    `[B_l, K_l, ...]` of ``value`` (a tensor or a dict) is gathered over
    the particle axis, then the slots of ``global_index`` `[B_l, K_l]`
    are taken (`torch.take_along_dim`; the indices need not be sorted).
    O(K) transient memory a rank. Differentiable in the values."""
    idx = global_index.long()

    def gather(leaf):
        full = collectives.all_gather(leaf, group, dim=1)
        expanded = idx.reshape(tuple(idx.shape) + (1,) * (leaf.ndim - 2))
        return torch.take_along_dim(full, expanded, dim=1)

    return _resampling._unflatten(value, iter(
        [gather(leaf) for leaf in _resampling._leaves(value)]))


def _gather_packed(scan, value, group, columns=()):
    """(every rank's ``scan`` `[B_l, K]`, ``value`` with its leaves
    gathered `[B_l, K, ...]` or None, the gathered ``columns``): one
    gather carries the local scan `[B_l, K_l]`, the float32 leaves and
    the extra `[B_l, K_l]` columns as the columns of one tensor; leaves of
    other dtypes are gathered apart."""
    batch_size, k_local = scan.shape
    leaves = [] if value is None else _resampling._leaves(value)
    floats = [leaf.reshape(batch_size, k_local, -1) for leaf in leaves
              if _resampling._fused(leaf)]
    packed = torch.cat([scan[:, :, None]] + floats +
                       [c[:, :, None] for c in columns], dim=2)
    full = collectives.all_gather(packed, group, dim=1)     # [B_l, K, 1 + D]
    pieces = iter(torch.split(full[:, :, 1:], [f.shape[2] for f in floats] +
                              [1] * len(columns), dim=2))
    gathered = [next(pieces).reshape((batch_size, -1) +
                                     tuple(leaf.shape[2:]))
                if _resampling._fused(leaf) else
                collectives.all_gather(leaf, group, dim=1)
                for leaf in leaves]
    full_columns = tuple(next(pieces)[:, :, 0] for _ in columns)
    return (full[:, :, 0], None if value is None else
            _resampling._unflatten(value, iter(gathered)), full_columns)


def _allgather_exchange(log_weight, noise, value, group, data_group,
                        method, columns=(), log_sum=None):
    """(idx, value, gathered columns) through the gathered global CDF
    (`_gather_packed`)."""
    batch_size, k_local = log_weight.shape
    local_cum, _ = _local_cdf(log_weight, group, log_sum)
    scans, full_value, full_columns = _gather_packed(local_cum, value, group,
                                                     columns)
    global_cdf = _gathered_cdf(scans, collectives.size(group))
    pos = _distributed_positions(noise, method, batch_size, k_local, group,
                                 data_group)
    return _resampling._search_gather(
        global_cdf, full_value, _cuda(global_cdf), True, pos=pos,
        columns=full_columns)


def distributed_systematic_resample(log_weight, noise, value, group,
                                    data_group=None,
                                    method: str = "systematic",
                                    log_sum=None):
    """Indices AND redistributed particles through the all-gather
    exchange: the local CDF scans and every leaf of ``value`` are gathered
    over the particle axis, then one K3 launch (on the card) searches this
    rank's positions and gathers the float32 columns; other dtypes go
    through K5 by the indices.

    Returns (indices `[B_l, K_l]` int32 global, value with `[B_l, K_l,
    ...]` leaves). ``log_sum``: as `distributed_resampling_indices`'.
    """
    idx, out, _ = _allgather_exchange(log_weight, noise, value, group,
                                      data_group, method, log_sum=log_sum)
    return idx, out


# Cumulative counts are exact float32 integers up to 2^24 particles (and
# the kernels' rows hold at most 2^24 entries).
RESIDUAL_MAX_K = 1 << 24


def _residual_counts(log_weight, noise, group, data_group, value=None):
    """The residual exchange up to the final search: (the cumulative
    counts `[B_l, K]` float32 of every source's copies, this rank's slots
    `[B_l, K_l]` as float32, ``value`` gathered over the particle axis).
    See `distributed_residual_resample`."""
    batch_size, k_local = log_weight.shape
    n, p = collectives.size(group), collectives.rank_in(group)
    k = k_local * n
    if k > RESIDUAL_MAX_K:
        raise ValueError(f"distributed residual resampling counts particles "
                         f"in float32: K = {k} is over {RESIDUAL_MAX_K}")
    # The whole rows' log-weights ride the particles' packed gather; on
    # them every rank computes `resampling.residual_indices`' copies and
    # residual CDF with its arithmetic.
    full_lw, full_value, _ = _gather_packed(log_weight.detach(), value,
                                            group)
    copies, cum_copies, cum_res = _resampling._residual_parts(full_lw)
    det_total = cum_copies[:, -1:]                               # C
    # This rank's slots s of the global grid: the residual draw u_s where
    # s >= C. The draws are searched sorted (K4 keeps a sorted tile's
    # search in its shared-memory window); only their histogram is kept.
    row0, b_global = _rows(data_group, batch_size)
    u = _replicated(noise).uniform((b_global, k))[
        row0:row0 + batch_size, p * k_local:(p + 1) * k_local]
    slots = torch.arange(p * k_local, (p + 1) * k_local,
                         dtype=cum_res.dtype, device=cum_res.device).expand(
                             batch_size, k_local)
    u_sorted, order = torch.sort(u, dim=1)
    drawn = torch.gather(slots >= det_total, 1, order).to(torch.int32)
    search = (_resampling.searchsorted_sorted_cuda.searchsorted_sorted
              if _cuda(cum_res) else
              _resampling.searchsorted_sorted_cuda.searchsorted_sorted_torch)
    res_idx = search(cum_res, u_sorted.contiguous())
    # Every source's count: the copies (on every rank alike) plus the
    # ranks' residual draws, summed in int32 (exact in any order).
    counts = torch.zeros((batch_size, k), dtype=torch.int32,
                         device=cum_res.device)
    counts.scatter_add_(1, res_idx.long(), drawn)
    counts = collectives.all_reduce(counts, group) + copies.to(torch.int32)
    cum_counts = torch.cumsum(counts, dim=1, dtype=torch.int32).to(
        cum_res.dtype)
    return cum_counts, slots.contiguous(), full_value


def distributed_residual_resample(log_weight, noise, value, group,
                                  data_group=None):
    """Residual resampling over the sharded particle axis: indices AND
    redistributed particles, this rank's output slots `[p K_l, (p + 1)
    K_l)` of `resampling.residual_indices`' sorted `[B, K]` result.

    That result is sorted, so the counts of each source determine it; the
    ranks exchange only the rows and exact integer counts:

    1. one packed gather of the log-weights and the float32 particles
       (other dtypes apart); on the whole rows every rank computes
       floor(K w) copies, their total C and the residual CDF of (K w -
       copies) / max(K - C, 1e-30) with the single-device arithmetic (its
       logsumexp, scan and running max): the floor turns the last bit of
       K w into a whole particle, and under the exact proposal every K w
       sits at 1, so a distributed logsumexp's rounding would move
       copies;
    2. this rank's block of the global `[B, K]` uniform draw; the slots s
       >= C search their draws in the residual CDF (kernel K4, on the
       draws sorted locally);
    3. the draws' histogram `[B_l, K]`, summed over the particle group in
       int32, plus the copies; the cumulative counts as float32, exact
       below 2^24 particles (`RESIDUAL_MAX_K`);
    4. this rank's indices: the right-side search of its slots j in the
       cumulative counts, which for integer counts is the search of j +
       0.5 of `resampling.residual_indices`; the particles move as in the
       all-gather exchange, with (cumulative counts, slots) in place of
       (CDF, positions): K3 searches and gathers the float32 columns, its
       backward K2 sums each source's slot range (exactly its count), and
       K5 moves the other dtypes bit for bit. ``value`` None: K4's
       indices only.

    Where the rows' reductions give one device's bits (the CPU; the card
    at equal row counts), the indices are one device's exactly.

    Returns (indices `[B_l, K_l]` int32 global, sorted; value with `[B_l,
    K_l, ...]` leaves, or None).
    """
    cum_counts, slots, full_value = _residual_counts(
        log_weight, noise, group, data_group, value)
    idx, out, _ = _resampling._search_gather(
        cum_counts, full_value, _cuda(cum_counts), True, pos=slots)
    return idx, out


def _where_slots(mask, new, acc):
    return torch.where(mask.reshape(tuple(mask.shape) +
                                    (1,) * (new.ndim - 2)), new, acc)


def _ring_exchange(log_weight, noise, value, group, data_group, method,
                   columns=(), log_sum=None):
    """(idx, value, gathered columns) through the ring."""
    batch_size, k_local = log_weight.shape
    n, p = collectives.size(group), collectives.rank_in(group)
    cdf, edges = _cdf_slices(log_weight, group, log_sum)
    cdf = _pin_global_last(cdf, group)
    edges = torch.cat([edges[:-1], torch.ones_like(edges[-1:])], dim=0)
    pos = _distributed_positions(noise, method, batch_size, k_local, group,
                                 data_group)
    cuda = _cuda(cdf)
    leaves = [] if value is None else _resampling._leaves(value)
    visiting = [cdf] + leaves + list(columns)
    idx = torch.zeros((batch_size, k_local), dtype=torch.int32,
                      device=cdf.device)
    gathered = None
    for step in range(n):
        src = (p + step) % n
        v_cdf = visiting[0]
        v_leaves = visiting[1:1 + len(leaves)]
        v_cols = visiting[1 + len(leaves):]
        v_value = (None if value is None else _resampling._unflatten(
            value, iter(v_leaves)))
        local_idx, out, extra = _resampling._search_gather(
            v_cdf, v_value, cuda, True, pos=pos, columns=tuple(v_cols))
        lo = (torch.zeros_like(edges[0]) if src == 0 else edges[src - 1])
        mask = (pos >= lo[:, None]) & (pos < edges[src][:, None])
        idx = torch.where(mask, local_idx + src * k_local, idx)
        new = ([] if value is None else _resampling._leaves(out)) + extra
        gathered = (new if gathered is None else
                    [_where_slots(mask, a, b) for a, b in zip(new, gathered)])
        if step < n - 1:
            visiting = collectives.ring_shift(visiting, group)
    out_leaves = gathered[:len(leaves)]
    out = (None if value is None else
           _resampling._unflatten(value, iter(out_leaves)))
    return idx, out, gathered[len(leaves):]


def distributed_systematic_resample_streaming(log_weight, noise, value,
                                              group, data_group=None,
                                              method: str = "systematic",
                                              log_sum=None):
    """Indices AND redistributed particles through the ring exchange, with
    O(K / n) live memory a rank: each rank's CDF slice and particles
    visit every rank in turn (`collectives.ring_shift`), and a rank keeps
    from each visit the slots whose position lies in the visiting slice
    (one K3 launch a visit on the card). Bit for bit the results of
    `distributed_systematic_resample`.

    Args/returns: as `distributed_systematic_resample`.
    """
    idx, out, _ = _ring_exchange(log_weight, noise, value, group,
                                 data_group, method, log_sum=log_sum)
    return idx, out


def distributed_soft_resample(log_weight, noise, value, group,
                              alpha: float = 0.5, data_group=None,
                              exchange: str = "allgather", log_sum=None):
    """Differentiable ('soft') resampling over the sharded particle axis.

    Ancestors are drawn multinomially from the tempered mixture q = alpha
    w + (1 - alpha) / K; the next weights are log(w[a] / q[a]). The
    normalization is a distributed logsumexp, the tempering is local, and
    the log w and log q columns ride the exchange beside the particles
    (all-gather or ring), so the gradient reaches ``log_weight`` through
    the gathered log w as on one device (`resampling.
    soft_resample_and_gather`).

    ``log_sum``, the (differentiable) logsumexp `[B_l]` of the whole axis,
    if the caller has it (the engine's log-Z term).

    Returns (indices `[B_l, K_l]` int32 - detached -, corrected
    log-weights `[B_l, K_l]` - differentiable -, resampled value or None
    for a None ``value``).
    """
    k_global = log_weight.shape[1] * collectives.size(group)
    if log_sum is None:
        log_sum = amath.distributed_logsumexp(log_weight, group, dim=1)
    log_w = log_weight - log_sum[:, None]
    log_q = _resampling._soft_mixture(log_w, alpha, k_global)
    lq_det = log_q.detach()
    body = _allgather_exchange if exchange == "allgather" else _ring_exchange
    idx, out, (log_w_sel, log_q_sel) = body(
        lq_det, noise, value, group, data_group, "multinomial",
        columns=(log_w, lq_det))
    return idx, log_w_sel - log_q_sel, out


def _axes(mesh, data_axis, particle_axis):
    """(particle group, data group or None) of ``mesh``."""
    names = tuple(mesh.mesh_dim_names or ())
    if particle_axis not in names:
        raise ValueError(f"mesh has axes {names}; particle_axis="
                         f"{particle_axis!r} is not one of them")
    data_group = mesh.get_group(data_axis) if data_axis in names else None
    return mesh.get_group(particle_axis), data_group


def _check_method(method, methods):
    if method not in methods:
        raise ValueError(f"method must be one of {methods}. currently = "
                         f"{method}")


def make_distributed_fused_resampler(mesh, data_axis: str = "data",
                                     particle_axis: str = "particle",
                                     exchange: str = "allgather",
                                     method: str = "systematic",
                                     soft_alpha: float = 0.5):
    """A FUSED ``(log_weight, noise, value) -> (indices, value)`` callable
    for `infer(resampling_implementation=...)`: the indices and the
    particle exchange in one pass, on this rank's blocks (`[B_l, K_l]`
    log-weights, `[B_l, K_l, ...]` leaves). Carries ``.fused = True``;
    the engine then skips its own gather. It also takes ``log_sum=``
    (``.takes_log_sum``), the logsumexp of the whole axis, which the
    engine has from its log-Z term: two all-reduces fewer a step.

    ``exchange``: 'allgather' (the global CDF and particles on every rank)
    or 'ring' (O(K / n) live memory a rank; the same bits). ``method``:
    'systematic', 'stratified', 'multinomial' or 'soft'. With 'soft' the
    callable carries ``.soft = True`` and ``.soft_alpha``, takes the same
    arguments and returns (indices, corrected log-weights, value).
    """
    if exchange not in EXCHANGES:
        raise ValueError(f"exchange must be 'allgather' or 'ring'. "
                         f"currently = {exchange}")
    _check_method(method, METHODS + ("soft",))
    group, data_group = _axes(mesh, data_axis, particle_axis)

    if method == "soft":
        def resampler(log_weight, noise, value, log_sum=None):
            return distributed_soft_resample(
                log_weight, noise, value, group, alpha=soft_alpha,
                data_group=data_group, exchange=exchange, log_sum=log_sum)

        resampler.soft = True
        resampler.soft_alpha = soft_alpha
    else:
        body = (distributed_systematic_resample if exchange == "allgather"
                else distributed_systematic_resample_streaming)

        def resampler(log_weight, noise, value, log_sum=None):
            return body(log_weight, noise, value, group,
                        data_group=data_group, method=method,
                        log_sum=log_sum)

        resampler.soft = False
    resampler.takes_log_sum = True
    resampler.fused = True
    resampler.method = method
    resampler.exchange = exchange
    _tag(resampler, mesh, data_axis, particle_axis, group)
    return resampler


def _make_residual_resampler(mesh, data_axis: str = "data",
                             particle_axis: str = "particle"):
    """The fused residual callable `infer` makes with ``mesh`` for
    ``resampling_method='residual'`` (`distributed_residual_resample`).
    It has no public factory: `make_distributed_fused_resampler` refuses
    'residual', as the JAX package's does."""
    group, data_group = _axes(mesh, data_axis, particle_axis)

    def resampler(log_weight, noise, value):
        return distributed_residual_resample(log_weight, noise, value, group,
                                             data_group=data_group)

    resampler.soft = False
    resampler.fused = True
    resampler.method = "residual"
    _tag(resampler, mesh, data_axis, particle_axis, group)
    return resampler


def make_distributed_ot_resampler(mesh, data_axis: str = "data",
                                  particle_axis: str = "particle",
                                  epsilon: float = 0.5,
                                  num_iterations: int = 50,
                                  scale_cost: bool = True):
    """A ``(log_weight, value) -> (value, new_log_weight)`` callable for
    `infer(resampling_method='ot', resampling_implementation=...)` with
    ``mesh``: entropy-regularized transport over the sharded particle
    axis (the ring-streamed Sinkhorn, `ot.distributed_ot_resample`), on
    this rank's blocks. Carries ``.ot = True``; epsilon and the
    iterations are bound here (the engine's ``ot_*`` options are then
    unused)."""
    from .. import ot as _ot

    group, _ = _axes(mesh, data_axis, particle_axis)

    def resampler(log_weight, value):
        return _ot.distributed_ot_resample(
            log_weight, value, group, epsilon=epsilon,
            num_iterations=num_iterations, scale_cost=scale_cost)

    resampler.ot = True
    resampler.fused = False
    resampler.soft = False
    _tag(resampler, mesh, data_axis, particle_axis, group)
    return resampler


def _tag(resampler, mesh, data_axis, particle_axis, group):
    """The attributes a module reads off a distributed resampler: its
    mesh and axis names (`sharding_utils.cloud_of`) and particle group."""
    resampler.mesh = mesh
    resampler.data_axis = data_axis
    resampler.particle_axis = particle_axis
    resampler.particle_group = group


def make_distributed_resampler(mesh, data_axis: str = "data",
                               particle_axis: str = "particle",
                               method: str = "systematic"):
    """A ``(log_weight, noise) -> indices`` callable for the
    ``resampling_implementation`` of `infer` and
    `resampling.sample_ancestral_index`: this rank's `[B_l, K_l]`
    log-weights in, the `[B_l, K_l]` global ancestor indices of its output
    slots out (`distributed_resampling_indices`). The engine then
    redistributes the particles (`distributed_resample_particles`).
    ``method``: 'systematic', 'stratified' or 'multinomial'."""
    _check_method(method, METHODS)
    group, data_group = _axes(mesh, data_axis, particle_axis)

    def resampler(log_weight, noise, log_sum=None):
        return distributed_resampling_indices(
            log_weight, noise, group, data_group=data_group, method=method,
            log_sum=log_sum)

    resampler.fused = False
    resampler.takes_log_sum = True
    resampler.soft = False
    resampler.method = method
    _tag(resampler, mesh, data_axis, particle_axis, group)
    return resampler


def make_distributed_systematic_resampler(mesh, data_axis: str = "data",
                                          particle_axis: str = "particle"):
    """Systematic special case of `make_distributed_resampler`."""
    return make_distributed_resampler(mesh, data_axis, particle_axis,
                                      method="systematic")
