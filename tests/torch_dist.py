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

    def gumbel(self, shape):
        return self._pop("gumbel", shape)


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
               seed=0, draws=None, explicit=False, algorithm="aesmc"):
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
        num_particles, algorithm, optimizer, m, resampling_method=method,
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
    """The messages (type name, text) of the calls a mesh refuses; None
    for a call that runs."""
    m = mesh(dp, pp)
    comps = lgssm_components(params)
    obs_b = parallel.shard_batch(_tensor(obs), m)
    noise = port.noise.NoiseSource.seeded(0, "cpu")
    calls = {
        "ot": lambda: port.inference.infer(
            "smc", obs_b, *comps, 16, noise=noise, resampling_method="ot",
            return_latents=False, mesh=m),
        "ot_rank": lambda: port.inference.infer(
            "smc", obs_b, *comps, 16, noise=noise, resampling_method="ot",
            ot_rank=2, return_latents=False, mesh=m),
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


# ---- slice E2: smoothing, streaming PaRIS, the RBPF, OT -----------------

def _open_lanes_spy():
    """Wraps `smoothing._open_lanes` to record, a call, this rank's own
    open lanes and the mesh's count the loop reads; returns (records,
    undo)."""
    from aesmc_tpu_torch import smoothing
    original = smoothing._open_lanes
    records = []

    def spying(accepted, cloud, sharded_children):
        count = original(accepted, cloud, sharded_children)
        records.append((int((~accepted).sum()), count))
        return count

    smoothing._open_lanes = spying

    def undo():
        smoothing._open_lanes = original
    return records, undo


def ffbs_case(dp, pp, latents, log_weights, obs, params, num_trajectories,
              backward="pairwise", draws=None, seed=0, max_exact_lanes=None):
    """`smoothing.backward_simulation(mesh=...)` on this rank's blocks of a
    filter's `[T, B, K]` output: the trajectories `[T, B_l, M]` and, in
    'rejection' mode, the (own, mesh) open-lane counts of each round."""
    from aesmc_tpu_torch import smoothing
    m = mesh(dp, pp)
    dims = {1: "data", 2: "particle"}
    records, undo = _open_lanes_spy()
    try:
        traj = smoothing.backward_simulation(
            block(_tensor(latents), m, dims),
            block(_tensor(log_weights), m, dims),
            lgssm_components(params)[1], num_trajectories,
            _noise(draws, seed),
            observations=block(_tensor(obs), m, {1: "data"}),
            backward=backward, max_exact_lanes=max_exact_lanes, mesh=m)
    finally:
        undo()
    return {"traj": _numpy(traj), "lanes": records}


def _paris_h(xp, xc, t):
    return xp * xc


def _paris_h0(x0):
    return x0 * x0


def paris_case(dp, pp, obs, params, num_particles, backward="pairwise",
               draws=None, seed=0, max_exact_lanes=None,
               exchange="allgather"):
    """`smoothing.paris(mesh=...)` on this rank's rows (h = x_{t-1} x_t,
    h0 = x_0^2, two backward draws)."""
    from aesmc_tpu_torch import smoothing
    m = mesh(dp, pp)
    records, undo = _open_lanes_spy()
    impl = parallel.make_distributed_fused_resampler(m, exchange=exchange)
    try:
        with torch.no_grad():
            out = smoothing.paris(
                block(_tensor(obs), m, {1: "data"}),
                *lgssm_components(params), num_particles, h=_paris_h,
                h0=_paris_h0, noise=_noise(draws, seed),
                num_backward_draws=2, backward=backward,
                max_exact_lanes=max_exact_lanes,
                resampling_implementation=impl, mesh=m)
    finally:
        undo()
    result = {k: _numpy(v) for k, v in out.items()}
    result["lanes"] = records
    return result


def online_e2_case(dp, pp, obs, params, num_particles, seed=0,
                   backward="pairwise", method="systematic", draws=None):
    """The streaming filter with ``mesh``, streaming PaRIS and genealogy:
    each step's smoothed estimate, relative variance and ancestors, and
    the final tau (one source for the whole stream: ``draws`` or
    seeded)."""
    m = mesh(dp, pp)
    init_fn, step_fn = port.online.make_online_filter(
        *lgssm_components(params), num_particles, resampling_method=method,
        return_ancestors=True, track_genealogy=True, paris_h=_paris_h,
        paris_h0=_paris_h0, paris_backward=backward, mesh=m)
    obs_b = block(_tensor(obs), m, {1: "data"})
    noise = _noise(draws, seed)
    with torch.no_grad():
        fs = init_fn(obs_b[0], noise)
        infos = []
        for t in range(1, obs_b.shape[0]):
            fs, info = step_fn(fs, obs_b[t], noise)
            infos.append({k: _numpy(v) for k, v in info.items()
                          if isinstance(v, torch.Tensor)})
    return {"infos": infos, "tau": _numpy(fs.tau), "eve": _numpy(fs.eve)}


def switching_rbpf_components():
    """The 2-regime switching LGSSM of the RBPF tests (D = 2, Do = 1)."""
    from aesmc_tpu_torch import distributions
    from aesmc_tpu_torch import math as amath

    def f(x):
        return torch.tensor(np.asarray(x, np.float32))

    pi0, pmat = np.log([0.6, 0.4]), np.log([[0.85, 0.15], [0.3, 0.7]])
    a_by_regime = np.array([0.95, 0.2])
    a = np.array([[1.0, 0.1], [0.0, 1.0]])
    return dict(
        initial=lambda: distributions.Categorical(logits=f(pi0)),
        transition=lambda previous_latents, time: distributions.Categorical(
            logits=amath.table_lookup(f(pmat), previous_latents[0])),
        linear_initial=lambda u0: (f(np.zeros(2)), f(np.eye(2))),
        linear_dynamics=lambda u, time: (
            amath.table_lookup(f(a_by_regime), u)[..., None, None] * f(a),
            f(np.zeros(2)), f(0.5 * np.eye(2))),
        linear_emission=lambda u, time: (f([[1.0, 0.5]]), f(np.zeros(1)),
                                         f([[0.09]])))


def rbpf_case(dp, pp, obs, num_particles, method="systematic", draws=None,
              seed=0, via_callable=False, ess_threshold=0.5):
    """`rbpf.rbpf` on this rank's rows: with ``mesh`` (the default fused
    exchange), or with only a distributed index resampler
    (``via_callable``)."""
    from aesmc_tpu_torch import rbpf
    m = mesh(dp, pp)
    kwargs = (dict(resampling_implementation=parallel.
                   make_distributed_resampler(m, method=method))
              if via_callable else dict(mesh=m))
    out = rbpf.rbpf(block(_tensor(obs), m, {1: "data"}),
                    num_particles=num_particles, noise=_noise(draws, seed),
                    resampling_method=method, ess_threshold=ess_threshold,
                    return_history=True, **switching_rbpf_components(),
                    **kwargs)
    return {k: _numpy(v) for k, v in out.items()}


def ot_case(dp, pp, log_weight, value, epsilon, num_iterations, grad=False):
    """`make_distributed_ot_resampler` on this rank's blocks; with
    ``grad`` also the gradients of sum(x^2) + sum(y) of the transported
    value with respect to this rank's log-weights and x."""
    m = mesh(dp, pp)
    dims = {0: "data", 1: "particle"}
    lw = block(_tensor(log_weight), m, dims).clone().requires_grad_(grad)
    val = {k: block(_tensor(v), m, dims).clone() for k, v in value.items()}
    val["x"].requires_grad_(grad)
    resampler = parallel.make_distributed_ot_resampler(
        m, epsilon=epsilon, num_iterations=num_iterations)
    out, new_lw = resampler(lw, val)
    result = {"value": _numpy(out), "new_log_weight": _numpy(new_lw)}
    if grad:
        loss = (out["x"] ** 2).sum() + out["y"].sum()
        loss.backward()
        result["grad_lw"] = lw.grad.numpy()
        result["grad_x"] = val["x"].grad.numpy()
    return result


def ot_engine_case(dp, pp, obs, params, num_particles, num_iterations,
                   draws=None, seed=0, explicit=False, online=False):
    """'ot' with ``mesh``: `infer`'s log-Z through the default ring or the
    explicit OT resampler; with ``online`` the streaming filter's
    log-predictives."""
    m = mesh(dp, pp)
    impl = (parallel.make_distributed_ot_resampler(
        m, num_iterations=num_iterations) if explicit else "auto")
    obs_b = block(_tensor(obs), m, {1: "data"})
    comps = lgssm_components(params)
    if online:
        init_fn, step_fn = port.online.make_online_filter(
            *comps, num_particles, resampling_method="ot",
            ot_num_iterations=num_iterations, resampling_implementation=impl,
            mesh=m)
        noise = _noise(draws, seed)
        fs = init_fn(obs_b[0], noise)
        preds = []
        for t in range(1, obs_b.shape[0]):
            fs, info = step_fn(fs, obs_b[t], noise)
            preds.append(_numpy(info["log_pred"]))
        return {"log_pred": np.stack(preds)}
    out = port.inference.infer(
        "smc", obs_b, *comps, num_particles, noise=_noise(draws, seed),
        resampling_method="ot", ot_num_iterations=num_iterations,
        resampling_implementation=impl, return_log_marginal_likelihood=True,
        return_latents=False, return_log_weight=False, mesh=m)
    return {"log_marginal_likelihood": _numpy(out["log_marginal_likelihood"])}


def ring_forms_case(dp, pp):
    """`collectives._shift`'s two forms on the particle group: the direct
    P2P and the host-staged one (gloo's form for device tensors), on a
    float32 and an int32 tensor, forward and back; and which form the
    dispatch takes for these host tensors."""
    m = mesh(dp, pp)
    group = m.get_group("particle")
    rank = dist.get_rank()
    tensors = [torch.arange(6.0).reshape(2, 3) * (rank + 1) + 0.1,
               torch.arange(4, dtype=torch.int32) + 10 * rank]
    out = {}
    for step in (1, -1):
        direct = collectives._shift_direct(tensors, group, step)
        staged = collectives._shift_staged(tensors, group, step)
        out[step] = ([t.numpy() for t in direct], [t.numpy() for t in staged])
    calls = []
    original = collectives._shift_staged
    collectives._shift_staged = lambda *a: calls.append(1) or original(*a)
    try:
        collectives._shift(tensors, group, 1)
    finally:
        collectives._shift_staged = original
    out["staged_for_host_tensors"] = bool(calls)
    out["mine"] = [t.numpy() for t in tensors]
    return out


# ---- slice E2: SMC^2, twisted SMC, resample-move, the block PF, the
# samplers and IF2 ----------------------------------------------------------

def smc2_problem(true_mult=0.8, emission_scale=0.5):
    """SMC^2's LGSSM of the SMC^2 tests: (build, log_prior)."""
    from aesmc_tpu_torch.models import lgssm
    sig = float(np.sqrt(1.0 / (1.0 + 1.0 / emission_scale ** 2)))
    emission = lgssm.Emission(1.0, emission_scale)
    proposal = lgssm.Proposal(0.8, 0.0, [0.2 * true_mult, 0.8], 0.0, sig,
                              sig)
    initial = lgssm.Initial(0.0, 1.0)

    def build(theta):
        return (initial, lgssm.Transition(mult=theta["mult"], scale=1.0),
                emission, proposal)

    def log_prior(theta):
        return -0.5 * theta["mult"] ** 2

    return build, log_prior


def smc2_case(dp, pp, obs, theta0, num_particles, ess_threshold=0.8,
              num_moves=2, draws=None, seed=0):
    """`smc2(mesh=...)` on a (theta, particle) mesh: this rank's thetas
    and the global outputs."""
    from aesmc_tpu_torch import smc2
    m = mesh(dp, pp)
    build, log_prior = smc2_problem()
    out = smc2.smc2(_tensor(obs), build, _tensor(theta0), log_prior,
                    num_particles, noise=_noise(draws, seed),
                    ess_threshold=ess_threshold, num_moves=num_moves,
                    return_history=True, mesh=m)
    return {k: _numpy(v) for k, v in out.items()}


def twisted_case(dp, pp, obs, num_particles, twist, method="systematic",
                 draws=None, seed=0, discrete=None):
    """`twisted_smc(mesh=...)` on this rank's rows; ``twist`` holds the
    GLOBAL `[T, B, ...]` tables (cut by the port to this rank's rows).
    ``discrete`` (num_states) selects the twisted HMM."""
    from aesmc_tpu_torch import distributions, twisted
    from aesmc_tpu_torch.models import hmm
    from aesmc_tpu_torch.state import BatchShapeMode
    m = mesh(dp, pp)
    if discrete is None:
        spec = twisted.GaussianSSMSpec(
            initial_loc=0.0, initial_scale=1.0, transition_scale=1.0,
            mean_fn=lambda x, t: 0.9 * x)

        def emission(latents=None, time=None, previous_observations=None):
            return distributions.Normal(
                1.2 * latents[-1], 0.5,
                batch_shape_mode=BatchShapeMode.FULLY_EXPANDED)

        tw = twisted.QuadraticTwist(**_tensor(twist))
    else:
        comps = hmm.make_model(num_states=discrete, emission_scale=0.6,
                               stay_prob=0.85, device="cpu")
        spec = twisted.DiscreteSSMSpec(comps[0].logits, comps[1].logits)
        emission = comps[2]
        tw = twisted.TabularTwist(**_tensor(twist))
    out = twisted.twisted_smc(
        block(_tensor(obs), m, {1: "data"}), spec, emission, tw,
        num_particles, noise=_noise(draws, seed), mesh=m,
        resampling_method=method, return_latents=True,
        return_ancestral_indices=True)
    return {k: _numpy(v) for k, v in out.items()
            if v is not None and k != "last_latent"}


def sv_twist_problem(phi=0.9, sigma=0.8, beta=0.7):
    """`learn_twist`'s stochastic-volatility problem of
    `tests/test_torch_twisted.py`: (spec, emission)."""
    import math
    from aesmc_tpu_torch import distributions, twisted
    from aesmc_tpu_torch.state import BatchShapeMode

    def emission(latents=None, time=None, previous_observations=None):
        return distributions.Normal(
            torch.zeros_like(latents[-1]), beta * torch.exp(latents[-1] / 2),
            batch_shape_mode=BatchShapeMode.FULLY_EXPANDED)

    spec = twisted.GaussianSSMSpec(
        initial_loc=0.0, initial_scale=sigma / math.sqrt(1 - phi ** 2),
        transition_scale=sigma, mean_fn=lambda x, t: phi * x)
    return spec, emission


def learn_twist_case(dp, pp, obs, num_particles, seed=0, draws=None,
                     **options):
    """`learn_twist(mesh=...)` on this rank's rows (the global twist and
    info come back on every rank)."""
    from aesmc_tpu_torch import twisted
    m = mesh(dp, pp)
    tw, info = twisted.learn_twist(
        block(_tensor(obs), m, {1: "data"}), *sv_twist_problem(),
        num_particles, noise=_noise(draws, seed), mesh=m, **options)
    return {"A": _numpy(tw.A), "b": _numpy(tw.b), "c": _numpy(tw.c),
            **{k: _numpy(v) for k, v in info.items()}}


def resample_move_case(dp, pp, obs, params, num_particles, seed=0,
                       exchange="allgather", target_acceptance=None,
                       draws=None):
    """`resample_move_filter` with a distributed fused resampler (the
    module runs on its mesh), seeded or on ``draws``."""
    from aesmc_tpu_torch import resample_move
    m = mesh(dp, pp)
    impl = parallel.make_distributed_fused_resampler(m, exchange=exchange)
    out = resample_move.resample_move_filter(
        block(_tensor(obs), m, {1: "data"}), *lgssm_components(params),
        num_particles, noise=_noise(draws, seed),
        target_acceptance=target_acceptance,
        resampling_implementation=impl)
    return {k: _numpy(v) for k, v in out.items()}


def lorenz_components(params):
    from aesmc_tpu_torch.models import lorenz
    return lorenz.from_numpy(params, proposal="bootstrap", device="cpu")


def block_pf_case(dp, pp, obs, params, num_particles, block_size,
                  obs_indices, method="systematic", seed=0, fused=False,
                  draws=None):
    """`block_pf` with a distributed resampler (index-only, or the fused
    all-gather one's indices), on this rank's rows, seeded or on
    ``draws``."""
    from aesmc_tpu_torch import blockpf
    m = mesh(dp, pp)
    impl = (parallel.make_distributed_fused_resampler(m, method=method)
            if fused else
            parallel.make_distributed_resampler(m, method=method))
    comps = lorenz_components(params)
    dim = int(comps[0]().event_shape[-1])
    out = blockpf.block_pf(
        block(_tensor(obs), m, {1: "data"}), *comps[:3], num_particles,
        blockpf.contiguous_blocks(dim, block_size),
        noise=_noise(draws, seed), obs_indices=obs_indices,
        resampling_method=method, resampling_implementation=impl,
        return_log_marginal_likelihood=True, return_log_weights=True,
        return_ancestral_indices=True)
    return {k: _numpy(v) for k, v in out.items()
            if v is not None and k != "last_latent"}


def sampler_problem(y, prior_scale, scale):
    """Prior N(0, s0^2 I), likelihood N(y; x, s^2 I) (one particle)."""
    import math
    y = torch.tensor(np.asarray(y, np.float32))
    d = y.shape[0]
    c0 = d * math.log(prior_scale * math.sqrt(2 * math.pi))
    c = d * math.log(scale * math.sqrt(2 * math.pi))

    def log_prior(x):
        return -0.5 * torch.sum((x / prior_scale) ** 2) - c0

    def log_lik(x):
        return -0.5 * torch.sum(((x - y) / scale) ** 2) - c

    return log_prior, log_lik


def sampler_case(dp, pp, x0, y, prior_scale, scale, seed=0,
                 waste_free_chains=None, num_moves=2, step_size=0.4,
                 draws=None):
    """`smc_sampler` with a distributed resampler: this rank's block of
    the `[K, D]` cloud in and out (or the message of the ValueError)."""
    from aesmc_tpu_torch import samplers
    m = mesh(dp, pp)
    x_b = block(_tensor(x0), m, {0: "particle"})
    try:
        out = samplers.smc_sampler(
            *sampler_problem(y, prior_scale, scale), x_b,
            noise=_noise(draws, seed), num_moves=num_moves,
            step_size=step_size, waste_free_chains=waste_free_chains,
            resampling_implementation=parallel.make_distributed_resampler(m))
    except ValueError as e:
        return {"error": str(e)}
    return {k: _numpy(v) for k, v in out.items()}


def if2_build():
    from aesmc_tpu_torch.models import lgssm
    initial = lgssm.Initial(0.0, 1.0)
    emission = lgssm.Emission(1.0, 0.5)

    def build(theta):
        transition = lgssm.Transition(mult=theta["mult"], scale=1.0)

        def proposal(previous_latents=None, time=None, observations=None):
            if time == 0:
                return initial()
            return transition(previous_latents=previous_latents, time=time)

        return initial, transition, emission, proposal

    return build


def if2_case(dp, pp, obs, theta0, num_particles, num_iterations, seed=0,
             cooling=0.9, draws=None):
    """`if2` with the fused distributed resampler; ``theta0`` global
    (`[B]` leaves are cut to this rank's rows), seeded or on ``draws``."""
    from aesmc_tpu_torch import if2
    m = mesh(dp, pp)
    out = if2.if2(block(_tensor(obs), m, {1: "data"}), if2_build(),
                  _tensor(theta0), {"mult": 0.1},
                  num_particles=num_particles,
                  num_iterations=num_iterations, cooling=cooling,
                  noise=_noise(draws, seed), resampling_implementation=(
                      parallel.make_distributed_fused_resampler(m)))
    return {k: _numpy(v) for k, v in out.items()}


# ---- slice E3: residual resampling, the low-rank OT, TMC and the score
# estimator on a mesh -------------------------------------------------------

def residual_case(dp, pp, obs, params, num_particles, draws=None, seed=0,
                  online=False):
    """'residual' with ``mesh``: `infer`'s ancestors, traced latents and
    log-Z; with ``online`` the streaming filter's ancestors, log-
    predictives and final log-Z."""
    m = mesh(dp, pp)
    comps = lgssm_components(params)
    obs_b = block(_tensor(obs), m, {1: "data"})
    noise = _noise(draws, seed)
    if online:
        init_fn, step_fn = port.online.make_online_filter(
            *comps, num_particles, resampling_method="residual",
            return_ancestors=True, mesh=m)
        fs = init_fn(obs_b[0], noise)
        preds, ancestors = [], []
        for t in range(1, obs_b.shape[0]):
            fs, info = step_fn(fs, obs_b[t], noise)
            preds.append(_numpy(info["log_pred"]))
            ancestors.append(_numpy(info["ancestral_index"]))
        return {"log_pred": np.stack(preds),
                "ancestral_indices": np.stack(ancestors),
                "log_marginal_likelihood": _numpy(
                    port.online.log_marginal_likelihood(fs, m))}
    out = port.inference.infer(
        "smc", obs_b, *comps, num_particles, noise=noise,
        resampling_method="residual", return_log_marginal_likelihood=True,
        return_ancestral_indices=True, mesh=m)
    return {k: _numpy(out[k]) for k in (
        "ancestral_indices", "latents", "log_marginal_likelihood")}


def residual_direct_case(dp, pp, log_weight, value, seed=0):
    """`distributed_residual_resample` on this rank's blocks of global
    `[B, K]` log-weights and a value with a float32 and an int32 leaf,
    and with no value; the gradient of sum(x^2) with respect to this
    rank's x. 'auto' routes to the kernels' wrappers (their plain
    versions on CPU tensors), and each wrapper's calls are counted."""
    from aesmc_tpu_torch import resampling
    from aesmc_tpu_torch.ops import (gather_sorted_cuda, range_sum_cuda,
                                     resample_sorted_cuda,
                                     searchsorted_sorted_cuda)
    m = mesh(dp, pp)
    dims = {0: "data", 1: "particle"}
    lw = block(_tensor(log_weight), m, dims)
    x = block(_tensor(value["x"]), m, dims).clone().requires_grad_(True)
    s = block(_tensor(value["s"]), m, dims)
    patches = [(resampling, "_route", lambda device, impl: "cuda")]
    calls = {}
    for module, name in ((searchsorted_sorted_cuda, "searchsorted_sorted"),
                         (resample_sorted_cuda, "resample_and_gather_sorted"),
                         (range_sum_cuda, "range_sum"),
                         (gather_sorted_cuda, "gather_sorted")):
        def counted(*args, _f=getattr(module, name), _n=name, **kw):
            calls.setdefault(_n, []).append(tuple(args[1].shape))
            return _f(*args, **kw)
        patches.append((module, name, counted))
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, fn in patches:
        setattr(mod, name, fn)
    try:
        idx, out = dist_resampling.distributed_residual_resample(
            lw, _noise(None, seed), {"x": x, "s": s},
            m.get_group("particle"), m.get_group("data"))
        (out["x"] ** 2).sum().backward()
        indices_only, _ = dist_resampling.distributed_residual_resample(
            lw, _noise(None, seed), None, m.get_group("particle"),
            m.get_group("data"))
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return {"idx": idx.numpy(), "x": _numpy(out["x"]), "s": out["s"].numpy(),
            "grad_x": x.grad.numpy(), "indices_only": indices_only.numpy(),
            "calls": calls}


def lowrank_case(dp, pp, log_weight, value, rank, num_iterations, draws):
    """`ot.lowrank_ot_resample(group=)` on this rank's blocks, its jitter
    this rank's blocks of the global ``draws``: the transported value and
    the gradients of sum(x^2) + sum(y) with respect to this rank's
    log-weights and x."""
    from aesmc_tpu_torch import ot
    from aesmc_tpu_torch.sharding_utils import Cloud
    m = mesh(dp, pp)
    dims = {0: "data", 1: "particle"}
    lw = block(_tensor(log_weight), m, dims).clone().requires_grad_(True)
    val = {k: block(_tensor(v), m, dims).clone() for k, v in value.items()}
    val["x"].requires_grad_(True)
    out, new_lw = ot.lowrank_ot_resample(
        lw, val, rank=rank, num_iterations=num_iterations,
        noise=Cloud(m).noise(ListNoise(**draws)),
        group=m.get_group("particle"))
    ((out["x"] ** 2).sum() + out["y"].sum()).backward()
    return {"value": _numpy(out), "new_log_weight": _numpy(new_lw),
            "grad_lw": lw.grad.numpy(), "grad_x": val["x"].grad.numpy()}


def lowrank_engine_case(dp, pp, obs, params, num_particles, rank,
                        num_iterations, draws=None, seed=0, online=False):
    """'ot' with ``ot_rank`` and ``mesh``: `infer`'s log-Z and last latent,
    or with ``online`` the streaming filter's log-predictives."""
    m = mesh(dp, pp)
    comps = lgssm_components(params)
    obs_b = block(_tensor(obs), m, {1: "data"})
    noise = _noise(draws, seed)
    kwargs = dict(resampling_method="ot", ot_rank=rank,
                  ot_num_iterations=num_iterations)
    if online:
        init_fn, step_fn = port.online.make_online_filter(
            *comps, num_particles, mesh=m, **kwargs)
        fs = init_fn(obs_b[0], noise)
        preds = []
        for t in range(1, obs_b.shape[0]):
            fs, info = step_fn(fs, obs_b[t], noise)
            preds.append(_numpy(info["log_pred"]))
        return {"log_pred": np.stack(preds)}
    out = port.inference.infer(
        "smc", obs_b, *comps, num_particles, noise=noise,
        return_log_marginal_likelihood=True, return_latents=False,
        return_log_weight=False, mesh=m, **kwargs)
    return {"log_marginal_likelihood": _numpy(out["log_marginal_likelihood"]),
            "last_latent": _numpy(out["last_latent"])}


def loss_case(dp, pp, obs, params, num_particles, algorithm, draws=None,
              seed=0, **kwargs):
    """`get_loss(mesh=...)` and this rank's backward pass: the loss and the
    parameters' gradients (the mean of the ranks' is the single-device
    gradient)."""
    m = mesh(dp, pp)
    comps = lgssm_components(params)
    loss = port.losses.get_loss(
        block(_tensor(obs), m, {1: "data"}), num_particles, algorithm,
        *comps, noise=_noise(draws, seed), mesh=m, **kwargs)
    loss.backward()
    return {"loss": float(loss.detach()), "grads": _grads(comps)}
