"""Spawned multi-rank worlds for the port's multi-device tests.

The tests run the JAX references in the pytest process and the port on
a world of gloo ranks on the CPU, the counterpart of the JAX tests' eight
fake CPU devices. The ranks are processes started with the spawn start
method, which imports this module afresh in each of them: it imports no
JAX (never fork a process that has imported JAX), and every case a test
file needs runs in one world, started once per file.

A case is ``(name, kwargs)``: ``name`` is a function of this module
called on every rank as ``fn(**kwargs)``, and each rank's return value
comes back to the parent (`run_world` returns them in rank order).
Inputs are numpy arrays; replayed draws travel as lists of arrays
(`ListNoise`).
"""

import os
import socket
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import aesmc_tpu_torch as port
from aesmc_tpu_torch import parallel
from aesmc_tpu_torch.parallel import collectives, dist_resampling

_MESHES = {}


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank, world, port_, cases, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port_}",
                            rank=rank, world_size=world)
    try:
        results = [globals()[name](**kwargs) for name, kwargs in cases]
        torch.save(results, os.path.join(out_dir, f"{rank}.pt"))
        dist.barrier()
    finally:
        _MESHES.clear()
        dist.destroy_process_group()


def run_world(world, cases):
    """Runs ``cases`` on ``world`` spawned gloo ranks; returns, for each
    case, the list of the ranks' results (rank order)."""
    with tempfile.TemporaryDirectory() as d:
        mp.start_processes(_entry, args=(world, free_port(), cases, d),
                           nprocs=world, start_method="spawn", join=True)
        per_rank = [torch.load(os.path.join(d, f"{r}.pt"),
                               weights_only=False) for r in range(world)]
    return [[per_rank[r][i] for r in range(world)]
            for i in range(len(cases))]


def mesh(dp, pp):
    """The ('data', 'particle') CPU mesh of shape (dp, pp), made once."""
    if (dp, pp) not in _MESHES:
        _MESHES[(dp, pp)] = parallel.make_mesh(dp, pp, device_type="cpu")
    return _MESHES[(dp, pp)]


def island_mesh(n):
    if ("island", n) not in _MESHES:
        _MESHES[("island", n)] = parallel.make_island_mesh(
            n, device_type="cpu")
    return _MESHES[("island", n)]


class ListNoise:
    """A CPU noise source that hands out given draws, each kind in order
    (the JAX package's draws, replayed)."""

    device = torch.device("cpu")

    def __init__(self, **draws):
        self.queues = {kind: [torch.tensor(np.asarray(x)) for x in xs]
                       for kind, xs in draws.items()}

    def _pop(self, kind, shape):
        x = self.queues[kind].pop(0)
        assert tuple(shape) == tuple(x.shape), (kind, tuple(shape), x.shape)
        return x

    def uniform(self, shape):
        return self._pop("uniform", shape)

    def normal(self, shape):
        return self._pop("normal", shape)

    def exponential(self, shape):
        return self._pop("exponential", shape)


def _noise(draws, seed):
    if draws is not None:
        return ListNoise(**draws)
    return port.noise.NoiseSource.seeded(seed, "cpu")


def block(x, m, dims):
    from aesmc_tpu_torch.sharding_utils import local_block
    return local_block(x, m, dims)


def _tensor(x):
    if isinstance(x, dict):
        return {k: _tensor(v) for k, v in x.items()}
    return torch.tensor(np.asarray(x))


def _numpy(x):
    if isinstance(x, dict):
        return {k: _numpy(v) for k, v in x.items()}
    if x is None:
        return None
    return x.detach().numpy()


def where(dp, pp):
    """(data rank, particle rank) of this rank on the (dp, pp) mesh."""
    rank = dist.get_rank()
    return rank // pp, rank % pp


def assemble(blocks, dp, pp, row_dim=0, particle_dim=1):
    """The global array from the ranks' blocks (rank = d pp + p)."""
    if isinstance(blocks[0], dict):
        return {k: assemble([b[k] for b in blocks], dp, pp, row_dim,
                            particle_dim) for k in blocks[0]}
    rows = [np.concatenate([blocks[d * pp + p] for p in range(pp)],
                           axis=particle_dim) for d in range(dp)]
    return np.concatenate(rows, axis=row_dim)


# ---- cases ---------------------------------------------------------------

def indices(dp, pp, lw, method, draws=None, seed=0):
    """`make_distributed_resampler` on this rank's block."""
    m = mesh(dp, pp)
    resampler = parallel.make_distributed_resampler(m, method=method)
    return resampler(block(_tensor(lw), m, {0: "data", 1: "particle"}),
                     _noise(draws, seed)).numpy()


def redistribute(dp, pp, lw, latent, draws):
    """Indices, then `distributed_resample_particles`."""
    m = mesh(dp, pp)
    group = m.get_group("particle")
    lw_b = block(_tensor(lw), m, {0: "data", 1: "particle"})
    lat_b = block(_tensor(latent), m, {0: "data", 1: "particle"})
    gi = dist_resampling.distributed_systematic_indices(
        lw_b, ListNoise(**draws), group, m.get_group("data"))
    return dist_resampling.distributed_resample_particles(
        lat_b, gi, group).numpy()


def fused(dp, pp, lw, value, exchange, method, draws=None, seed=0,
          soft_alpha=0.5, grad=False, spy=False):
    """`make_distributed_fused_resampler` on this rank's block: (idx,
    value[, corrected][, the gradient of sum(corrected) + sum(x) with
    respect to this rank's log-weights]); with ``spy`` also the shapes
    every `collectives.all_gather` call returned."""
    m = mesh(dp, pp)
    dims = {0: "data", 1: "particle"}
    lw_b = block(_tensor(lw), m, dims).clone().requires_grad_(grad)
    value_b = block(_tensor(value), m, dims)
    resampler = parallel.make_distributed_fused_resampler(
        m, exchange=exchange, method=method, soft_alpha=soft_alpha)
    shapes = []
    original = collectives.all_gather
    if spy:
        def spying(x, group, dim=0):
            out = original(x, group, dim)
            shapes.append(tuple(out.shape))
            return out
        collectives.all_gather = spying
    try:
        out = resampler(lw_b, _noise(draws, seed), value_b)
    finally:
        collectives.all_gather = original
    result = {"idx": out[0].numpy(), "value": _numpy(out[-1])}
    if method == "soft":
        result["corrected"] = _numpy(out[1])
        if grad:
            loss = out[1].sum() + out[2]["x"].sum()
            loss.backward()
            result["grad"] = lw_b.grad.numpy()
    if spy:
        result["gathers"] = shapes
    return result


def logsumexp(dp, pp, values):
    from aesmc_tpu_torch import math as amath
    m = mesh(dp, pp)
    x = block(_tensor(values), m, {0: "data", 1: "particle"})
    return amath.distributed_logsumexp(x, m.get_group("particle"),
                                       dim=1).numpy()


def apf_lookahead():
    """The auxiliary PF's score of the tests' LGSSM (transition 0.9, 1;
    emission 1, 0.2)."""
    from aesmc_tpu_torch.models import lgssm
    return lgssm.Lookahead(0.9, 1.0, 1.0, 0.2)


def lgssm_components(params):
    from aesmc_tpu_torch.models import lgssm
    return lgssm.from_numpy(params, device="cpu")


def infer_case(dp, pp, obs, params, num_particles, exchange=None,
               method="systematic", draws=None, seed=0, algorithm="smc",
               criterion="always", return_latents=False, apf=False,
               window=1, remat=False):
    """`infer(mesh=...)` on this rank's rows; ``exchange`` None is the
    default route, else a fused resampler of that exchange; ``apf`` adds
    the LGSSM's exact lookahead (`apf_lookahead`)."""
    m = mesh(dp, pp)
    impl = "auto"
    if exchange is not None:
        impl = parallel.make_distributed_fused_resampler(
            m, exchange=exchange, method=method)
    elif method == "plain":
        impl, method = parallel.make_distributed_resampler(m), "systematic"
    out = port.inference.infer(
        algorithm, parallel.shard_batch(_tensor(obs), m),
        *lgssm_components(params), num_particles, noise=_noise(draws, seed),
        resampling_method=method, resampling_implementation=impl,
        resampling_criterion=criterion,
        lookahead=apf_lookahead() if apf else None, history_window=window,
        remat=remat, return_log_marginal_likelihood=True,
        return_latents=return_latents,
        return_ancestral_indices=algorithm == "smc", mesh=m)
    return {k: _numpy(v) for k, v in out.items()
            if v is not None and k != "last_latent"}


def _grads(components):
    from aesmc_tpu_torch import train
    return [p.grad.detach().numpy().copy()
            for p in train.get_chained_params(*components)]


def train_case(dp, pp, obs, params, num_particles, steps=1, lr=1e-2,
               method="systematic", exchange=None, soft_alpha=0.5,
               seed=0, draws=None, explicit=False):
    """``steps`` of `make_sharded_train_step` with Adam: each step's loss,
    the averaged gradients of the last step and the parameters after.
    Step i draws from a source seeded ``seed + i``, or the first step
    from ``draws``; ``explicit`` resamples through
    `make_distributed_systematic_resampler`."""
    from aesmc_tpu_torch import train
    m = mesh(dp, pp)
    comps = lgssm_components(params)
    optimizer = torch.optim.Adam(train.get_chained_params(*comps), lr=lr)
    impl = "auto"
    if exchange is not None:
        impl = parallel.make_distributed_fused_resampler(
            m, exchange=exchange, method=method, soft_alpha=soft_alpha)
    elif explicit:
        impl = parallel.make_distributed_systematic_resampler(m)
    step = parallel.make_sharded_train_step(
        num_particles, "aesmc", optimizer, m, resampling_method=method,
        resampling_implementation=impl)
    obs_b = parallel.shard_batch(_tensor(obs), m)
    losses = []
    for i in range(steps):
        noise = (ListNoise(**draws) if draws is not None and i == 0 else
                 port.noise.NoiseSource.seeded(seed + i, "cpu"))
        losses.append(float(step(comps, obs_b, noise)))
    return {"losses": losses, "grads": _grads(comps),
            "params": [p.detach().numpy().copy() for p in
                       train.get_chained_params(*comps)]}


def online_case(dp, pp, obs, params, num_particles, method="systematic",
                exchange=None, fixed_lag=0, criterion="always", seed=0):
    """The streaming filter with ``mesh``: init then T - 1 steps from one
    seeded source; each step's info and the final carry's blocks."""
    m = mesh(dp, pp)
    impl = "auto"
    if exchange is not None:
        impl = parallel.make_distributed_fused_resampler(
            m, exchange=exchange, method=method)
    init_fn, step_fn = port.online.make_online_filter(
        *lgssm_components(params), num_particles, resampling_method=method,
        resampling_implementation=impl, resampling_criterion=criterion,
        return_ancestors=True, fixed_lag=fixed_lag, mesh=m)
    obs_b = parallel.shard_batch(_tensor(obs), m)
    noise = port.noise.NoiseSource.seeded(seed, "cpu")
    fs = init_fn(obs_b[0], noise)
    infos = []
    for t in range(1, obs_b.shape[0]):
        fs, info = step_fn(fs, obs_b[t], noise)
        infos.append({k: _numpy(v) for k, v in info.items()
                      if isinstance(v, torch.Tensor)})
    return {"infos": infos, "log_weight": _numpy(fs.log_weight),
            "latent": _numpy(fs.latent),
            "log_z": _numpy(port.online.log_marginal_likelihood(fs, m)),
            "ess": _numpy(port.online.effective_sample_size(fs, m))}


def island_case(n_ranks, obs, params, num_particles, num_islands,
                criterion, seed=0, island_axis="island", **kwargs):
    """`island_infer` on an ('island',) mesh of ``n_ranks``."""
    m = island_mesh(n_ranks)
    out = parallel.island_infer(
        _tensor(obs), *lgssm_components(params), num_particles=num_particles,
        num_islands=num_islands,
        noise=port.noise.NoiseSource.seeded(seed, "cpu"),
        island_resampling_criterion=criterion, mesh=m,
        island_axis=island_axis, **kwargs)
    return {k: _numpy(v) for k, v in out.items()}


def island_bad_axis(n_ranks, obs, params):
    m = island_mesh(n_ranks)
    try:
        parallel.island_infer(_tensor(obs), *lgssm_components(params),
                              num_particles=4, num_islands=2, mesh=m,
                              island_axis="data",
                              noise=port.noise.NoiseSource.seeded(0, "cpu"))
    except ValueError as e:
        return str(e)
    return None


def mesh_info(dp, pp):
    """The mesh's shape, axis names and this rank's coordinates; the
    message of a mesh larger than the world."""
    m = mesh(dp, pp)
    try:
        parallel.make_mesh(16, 16, device_type="cpu")
        too_many = None
    except ValueError as e:
        too_many = str(e)
    rows, particles = parallel.data_particle_specs(m, 8, 32)
    from aesmc_tpu_torch.sharding_utils import gather_block, local_block
    cloud = torch.arange(8 * 32 * 2.0).reshape(8, 32, 2)
    dims = {0: "data", 1: "particle"}
    return {"shape": tuple(m.shape), "names": tuple(m.mesh_dim_names),
            "coords": (m.get_local_rank("data"),
                       m.get_local_rank("particle")),
            "too_many": too_many,
            "specs": ((rows.start, rows.stop),
                      (particles.start, particles.stop)),
            "shard": parallel.shard_batch(
                torch.arange(16.0).reshape(2, 8), m).numpy(),
            "round_trip": bool(torch.equal(
                gather_block(local_block(cloud, m, dims), m, dims), cloud))}


def mesh_errors(dp, pp, obs, params):
    """The messages (type name, text) of the calls a mesh refuses."""
    m = mesh(dp, pp)
    comps = lgssm_components(params)
    obs_b = parallel.shard_batch(_tensor(obs), m)
    noise = port.noise.NoiseSource.seeded(0, "cpu")
    calls = {
        "ot": lambda: port.inference.infer(
            "smc", obs_b, *comps, 16, noise=noise, resampling_method="ot",
            return_latents=False, mesh=m),
        "residual": lambda: port.inference.infer(
            "smc", obs_b, *comps, 16, noise=noise,
            resampling_method="residual", mesh=m),
        "no_mesh": lambda: port.inference.infer(
            "smc", obs_b, *comps, 16, noise=noise,
            resampling_implementation=(
                parallel.make_distributed_systematic_resampler(m))),
        "paris": lambda: port.online.make_online_filter(
            *comps, 16, paris_h=lambda x: x, mesh=m),
        "genealogy": lambda: port.online.make_online_filter(
            *comps, 16, track_genealogy=True, mesh=m),
        "tmc": lambda: port.losses.get_loss(obs_b, 16, "tmc", *comps,
                                            noise=noise, mesh=m),
        "split": lambda: port.inference.infer(
            "smc", obs_b, *comps, 10, noise=noise, mesh=m),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = None
        except (ValueError, NotImplementedError) as e:
            out[name] = (type(e).__name__, str(e))
    return out


def dryrun(n_devices=8, big_k=8192, soft_k=32768, island_k=2048):
    """The paths of the JAX package's `__graft_entry__.dryrun_multichip`
    on the port: a sharded AESMC train step with the explicit distributed
    resampler on a (data, particle) mesh; one sharded `infer` through the
    fused ring exchange at K = ``big_k`` a rank; a soft-resampling train
    step through the ring at K = ``soft_k`` a rank; island SMC with one
    ``island_k``-particle island a rank, ESS-adaptive. Returns the
    finite-ness of each result."""
    data = 1
    for cand in (2, 4):
        if n_devices % cand == 0:
            data = cand
    particle = n_devices // data
    m = mesh(data, particle)
    params = {"initial": {"loc": 0.0, "scale": 1.0},
              "transition": {"mult": 0.5, "scale": 1.0},
              "emission": {"mult": 1.0, "scale": 0.2},
              "proposal": {"lin_0_weight": 0.5, "lin_0_bias": 0.0,
                           "lin_t_weight": np.array([0.9, 0.1], np.float32),
                           "lin_t_bias": 0.0, "scale_0": 1.0,
                           "scale_t": 1.0}}
    true_params = dict(params, transition={"mult": 0.9, "scale": 1.0})
    noise = port.noise.NoiseSource.seeded(0, "cpu")
    _, obs = port.statistics.sample_from_prior(
        *lgssm_components(true_params)[:3], 4, 2 * data, noise=noise)
    obs = obs.detach()
    obs_b = parallel.shard_batch(obs, m)
    out = {}

    comps = lgssm_components(params)
    optimizer = torch.optim.Adam(port.train.get_chained_params(*comps),
                                 lr=1e-2)
    step = parallel.make_sharded_train_step(
        4 * particle, "aesmc", optimizer, m,
        resampling_implementation=(
            parallel.make_distributed_systematic_resampler(m)))
    out["step"] = float(step(comps, obs_b, noise.fold_in(1)))

    ring = parallel.make_distributed_fused_resampler(m, exchange="ring")
    res = port.inference.infer(
        "smc", obs_b[:3], *lgssm_components(true_params),
        big_k * n_devices, noise=noise.fold_in(2),
        resampling_implementation=ring, return_log_marginal_likelihood=True,
        return_latents=False, return_log_weight=False, mesh=m)
    out["ring"] = _numpy(res["log_marginal_likelihood"])

    soft = parallel.make_distributed_fused_resampler(
        m, exchange="ring", method="soft", soft_alpha=0.5)
    comps = lgssm_components(params)
    optimizer = torch.optim.Adam(port.train.get_chained_params(*comps),
                                 lr=1e-2)
    soft_step = parallel.make_sharded_train_step(
        soft_k * n_devices, "aesmc", optimizer, m, resampling_method="soft",
        resampling_implementation=soft)
    out["soft"] = float(soft_step(comps, obs_b[:3], noise.fold_in(3)))

    islands = parallel.island_infer(
        obs[:, :2], *lgssm_components(true_params),
        num_particles=island_k, num_islands=n_devices,
        noise=noise.fold_in(4), island_resampling_criterion=0.5,
        mesh=island_mesh(n_devices))
    out["islands"] = _numpy(islands["log_marginal_likelihood"])
    return out


def hmm_case(dp, pp, obs, method, num_particles=32):
    """`infer(mesh=...)` on the HMM (int32 particles; the exact proposal
    draws its t = 0 Gumbels particle-major)."""
    from aesmc_tpu_torch.models import hmm
    m = mesh(dp, pp)
    comps = hmm.make_model(num_states=3, emission_scale=0.6, stay_prob=0.85,
                           device="cpu")
    out = port.inference.infer(
        "smc", parallel.shard_batch(_tensor(obs), m), *comps, num_particles,
        noise=port.noise.NoiseSource.seeded(0, "cpu"),
        resampling_method=method, return_log_marginal_likelihood=True,
        return_latents=True, return_ancestral_indices=True, mesh=m)
    return {k: _numpy(v) for k, v in out.items()
            if v is not None and k != "last_latent"}
