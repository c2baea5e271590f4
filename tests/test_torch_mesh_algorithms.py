"""The algorithms that take a mesh since slice E2 of the port: FFBS,
PaRIS, streaming PaRIS and genealogy, the RBPF, SMC^2, twisted SMC, the
distributed OT, and resample-move, the block PF, the annealed sampler
and IF2 through a distributed resampler; and the ring's two transports.
Each against the port on one device and against the JAX package's mesh
call.

Every case runs in ONE world of 4 gloo ranks on the CPU (`torch_dist`),
on (2, 2) and (1, 4) meshes; the JAX references run (jitted) in the
pytest process on its 8 fake devices ((2, 4) meshes, as
`tests/test_parallel.py` runs them), since both are held to one device's
result. T = 5, B = 4, K = 32. Per-row parameters are built over the
global batch and cut to each rank's rows: the twists' `[T, B]` tables,
IF2's `[B]` starting centres, SMC^2's thetas (sharded over the data
axis); resample-move's per-row adaptive scales follow its rows.

Against the port on one device (the same seed: a mesh run draws its
block of the single-device draws): FFBS trajectories exactly, pairwise
and rejection, also with an exact fallback of one lane, where the ranks'
own open lanes would stop the loop at different rounds and the mesh's
count keeps them together; PaRIS within 1e-5 (its smoothed sum and log-Z
cross the particle group in another order), the rejection diagnostics
exactly; streaming PaRIS and genealogy within 1e-5 of the unsharded
stream, its final tau within rtol 2e-5 / atol 1e-4 of the offline
`paris` (`tests/test_online.py`'s bar); the RBPF's regimes exactly;
twisted SMC's and the block PF's ancestors exactly; `learn_twist`'s
twists, evidence and scores within 1e-8 relative in float64, on every
rank; resample-move, IF2 and SMC^2 within 1e-5 (its thetas exactly, on
every rank, also where every step rejuvenates); the sampler within
`tests/test_samplers.py`'s bars (the same rungs, log Z within 1e-4,
particle means within 1e-3) at pp = 4, classic and waste-free (a mesh
with a data axis is refused: the sampler's cloud has no batch axis); OT
within 1e-4.

Against the JAX mesh calls with the JAX draws replayed (the key
schedules of `tests/test_torch_smoothing.py`, `test_torch_rbpf.py`,
`test_torch_smc2.py`, `test_torch_twisted.py` and
`test_torch_samplers.py`): FFBS atol 1e-5, PaRIS 1e-4 (the JAX tests'
bars), the stream's tau rtol 2e-5 / atol 1e-4 of the JAX mesh PaRIS (the
JAX stream on the same keys is that smoother), the RBPF's log-Z 1e-4 and
filtered means 1e-3, SMC^2's and twisted SMC's evidence 1e-4, the
sampler on (1, 4) within the JAX (1, 4) sampler's bars, the distributed
OT 1e-4 and its gradients atol 2e-4 / rtol 1e-3, 'ot' in `infer` 1e-4;
`learn_twist` with jittered design points within 1e-8 relative in
float64; resample-move, the block PF and IF2 (per-row centres) through
the JAX distributed resampler on the replay tests' problems and key
schedules (`tests/test_torch_resample_move.py`, `test_torch_blockpf.py`,
`test_torch_if2.py`) at those tests' bars: the block PF's ancestors
exactly, the rest within 1e-5 (acceptance rates 1e-6) relative. The ring
stages device tensors through host copies under gloo; both forms move
the same bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_blockpf as blockpf_tests
import test_torch_if2 as if2_tests
import test_torch_resample_move as rm_tests
import test_torch_samplers as samplers_tests
import test_torch_smc2 as smc2_tests
import test_torch_twisted as twisted_tests
import torch_dist
import torch_threads  # noqa: F401
from aesmc_tpu import blockpf as jax_blockpf
from aesmc_tpu import gradients as jax_gradients
from aesmc_tpu import if2 as jax_if2
from aesmc_tpu import inference as jax_inference
from aesmc_tpu import losses as jax_losses
from aesmc_tpu import ot as jax_ot_module
from aesmc_tpu import parallel as jax_parallel
from aesmc_tpu import rbpf as jax_rbpf
from aesmc_tpu import resample_move as jax_rm
from aesmc_tpu import samplers as jax_samplers
from aesmc_tpu import smc2 as jax_smc2
from aesmc_tpu import smoothing as jax_smoothing
from aesmc_tpu import statistics as jax_statistics
from aesmc_tpu import twisted as jax_twisted
from aesmc_tpu.models import lgssm as jax_lgssm
from aesmc_tpu.models import lorenz as jax_lorenz
from aesmc_tpu_torch import (blockpf, gradients, if2, inference, losses,
                             online, ot, rbpf, resample_move, resampling,
                             samplers, smc2, smoothing, train, twisted)
from aesmc_tpu_torch.models import hmm
from aesmc_tpu_torch.noise import NoiseSource
from torch_replay import (fields, lgssm_params, normal_draw, proposal_eps,
                          replayed_noise)

A, Q, EM, R0 = 0.9, 1.0, 1.0, 0.5
T, B, K, M = 5, 4, 32, 8
MESHES = [(2, 2), (1, 4)]
WORLD = 4


def _jax_components():
    prec_t = 1.0 / Q + EM ** 2 / R0
    prec_0 = 1.0 / 1.0 + EM ** 2 / R0
    return (jax_lgssm.Initial(0.0, 1.0),
            jax_lgssm.Transition.create(A, np.sqrt(Q)),
            jax_lgssm.Emission.create(EM, np.sqrt(R0)),
            jax_lgssm.Proposal(
                lin_0_weight=jnp.asarray((EM / R0) / prec_0),
                lin_0_bias=jnp.asarray(0.0),
                lin_t_weight=jnp.asarray([(A / Q) / prec_t,
                                          (EM / R0) / prec_t]),
                lin_t_bias=jnp.asarray(0.0),
                scale_0=float(np.sqrt(1.0 / prec_0)),
                scale_t=float(np.sqrt(1.0 / prec_t))))


PARAMS = lgssm_params(_jax_components())


def _observations(seed=11):
    rng = np.random.RandomState(seed)
    x = rng.randn(B)
    ys = []
    for _ in range(T):
        ys.append(EM * x + np.sqrt(R0) * rng.randn(B))
        x = A * x + np.sqrt(Q) * rng.randn(B)
    return np.asarray(ys, np.float32)


OBS = _observations()
FFBS_KEY, PARIS_KEY, RBPF_KEY = (jax.random.PRNGKey(2), jax.random.PRNGKey(3),
                                 jax.random.PRNGKey(4))
_FILTER = jax.jit(lambda o: jax_inference.infer(
    "smc", o, *_jax_components(), K, key=jax.random.PRNGKey(1),
    return_original_latents=True, return_log_weights=True,
    return_latents=False, return_log_weight=False))(jnp.asarray(OBS))
LATENTS = np.asarray(_FILTER["original_latents"])
LOG_WEIGHTS = np.asarray(_FILTER["log_weights"])
RBPF_OBS = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (6, B, 1)))


def _ffbs_draws():
    """FFBS's Gumbel noise from ``FFBS_KEY``: `[B, M, K]` for the last step,
    then one a step from `split(key, T-1)[t]`, last step first."""
    key_rest, sub = jax.random.split(FFBS_KEY)
    step_keys = jax.random.split(key_rest, T - 1)
    return {"gumbel": [np.asarray(jax.random.gumbel(sub, (B, M, K)))] + [
        np.asarray(jax.random.gumbel(step_keys[t], (B, M, K)))
        for t in range(T - 2, -1, -1)]}


def _paris_draws():
    """PaRIS's draws from ``PARIS_KEY`` (`split(key, (T, 3))`)."""
    step_keys = jax.random.split(PARIS_KEY, (T, 3))
    normals = [normal_draw(step_keys[0, 1], (K,), (B,), batch_expanded=True)]
    uniforms, gumbels = [], []
    for t in range(1, T):
        uniforms.append(np.asarray(jax.random.uniform(step_keys[t, 0],
                                                      (B, 1))))
        normals.append(normal_draw(step_keys[t, 1], (), (B, K)))
        gumbels += [np.asarray(jax.random.gumbel(k, (B, K, K)))
                    for k in jax.random.split(step_keys[t, 2], 2)]
    return {"uniform": uniforms, "normal": normals, "gumbel": gumbels}


def _rbpf_draws():
    key, k0 = jax.random.split(RBPF_KEY)
    gumbels = [np.asarray(jax.random.gumbel(k0, (B, K, 2)))]
    uniforms = []
    for _ in range(1, RBPF_OBS.shape[0]):
        key, k_res, k_prop = jax.random.split(key, 3)
        uniforms.append(np.asarray(jax.random.uniform(k_res, (B, 1))))
        gumbels.append(np.asarray(jax.random.gumbel(k_prop, (B, K, 2))))
    return {"uniform": uniforms, "gumbel": gumbels}


# ---- SMC^2 (the SMC^2 tests' problem: T = 6, B = 2, M = 8, K = 32).
S2_KEY = jax.random.PRNGKey(9)
S2_OBS = smc2_tests._obs(smc2_tests.T, smc2_tests.B)
S2_THETA0 = {"mult": np.asarray(
    0.8 + 0.3 * jax.random.normal(jax.random.PRNGKey(2), (smc2_tests.M,)),
    np.float32)}
S2 = dict(obs=S2_OBS, theta0=S2_THETA0, num_particles=smc2_tests.K,
          ess_threshold=0.8, num_moves=2)


def _s2_jax():
    build, log_prior = smc2_tests._problem("jax")
    mesh = jax_parallel.make_mesh(data=2, particle=4)
    return jax.jit(lambda o: jax_smc2.smc2(
        o, build, {"mult": jnp.asarray(S2_THETA0["mult"])}, log_prior,
        smc2_tests.K, key=S2_KEY, ess_threshold=0.8, num_moves=2,
        mesh=mesh))(jnp.asarray(S2_OBS))


S2_JAX = _s2_jax()


def _s2_draws():
    replay = smc2_tests._replay(S2_KEY, S2_JAX, smc2_tests.T, smc2_tests.B,
                                smc2_tests.M, 0.8, 2)
    return {"uniform": [u.numpy() for u in replay.uniforms],
            "normal": [e.numpy() for e in replay.normals]}


# ---- twisted SMC on the LGSSM, with the exact per-row twist.
TW_KEY = jax.random.PRNGKey(2)
TW_OBS = twisted_tests._lgssm_obs(T, B, seed=3)
_TWIST = jax_twisted.exact_lgssm_twist(
    jnp.asarray(TW_OBS), 0.0, 1.0, twisted_tests.A_TR, twisted_tests.S_TR,
    twisted_tests.C_EM, twisted_tests.S_EM)
TWIST = {"A": np.asarray(_TWIST.A), "b": np.asarray(_TWIST.b),
         "c": np.asarray(_TWIST.c)}
HMM_OBS = np.asarray(np.random.RandomState(5).randn(T, B), np.float32)
HMM_STATES = 3

# ---- resample-move, the block PF, the sampler, IF2.
_LORENZ = jax_lorenz.make_model(dim=8, obs_indices=(0, 2, 4, 6),
                                emission_scale=0.5, transition_scale=0.4,
                                proposal="bootstrap")
LORENZ_PARAMS = {name: fields(c) for name, c in
                 zip(("initial", "transition", "emission"), _LORENZ[:3])}
RNG = np.random.RandomState(7)
LGSSM_OBS = RNG.randn(T, B).astype(np.float32)
LORENZ_OBS = RNG.randn(T, B, 4).astype(np.float32)
SAMPLER = dict(x0=2.0 * RNG.randn(256, 2).astype(np.float32),
               y=np.asarray([0.7, -0.3], np.float32), prior_scale=2.0,
               scale=0.5)
IF2_THETA0 = {"mult": np.asarray([0.2, 0.5, 0.8, 0.4], np.float32)}


def _sampler_jax():
    """The JAX sampler on a (1, 4) mesh with its distributed resampler (the
    JAX test's setting, `tests/test_samplers.py:160-195`), on the
    sampler tests' problem at K = 256 (`tests/test_torch_samplers.py`)."""
    from jax.sharding import NamedSharding, PartitionSpec
    mesh = jax_parallel.make_mesh(data=1, particle=4)
    dist = jax_parallel.make_distributed_resampler(mesh)
    x0 = jax.device_put(jnp.asarray(samplers_tests._x0()),
                        NamedSharding(mesh, PartitionSpec("particle", None)))
    return jax.jit(lambda x: jax_samplers.smc_sampler(
        *samplers_tests._problem("jax"), x, key=samplers_tests.KEY,
        num_moves=2, step_size=0.4, resampling_implementation=dist))(x0)


SAMPLER_JAX = _sampler_jax()


def _sampler_draws():
    replay = samplers_tests._Draws(
        samplers_tests.KEY, [(samplers_tests.D,)], samplers_tests.K, 2,
        "systematic").noise(int(SAMPLER_JAX["num_steps"]))
    return {"uniform": [u.numpy() for u in replay.uniforms],
            "normal": [e.numpy() for e in replay.normals]}


# ---- resample-move, the block PF and IF2 on the JAX draws: each on its
# replay test's problem and key schedule (tests/test_torch_resample_move.py,
# test_torch_blockpf.py, test_torch_if2.py); IF2 with per-row centres.
def _lists(replay):
    return {"uniform": [u.numpy() for u in replay.uniforms],
            "normal": [e.numpy() for e in replay.normals]}


RM_OBS = np.asarray(jax_statistics.sample_from_prior(
    *rm_tests._components("jax", "bootstrap")[:3], rm_tests.T, rm_tests.B,
    jax.random.PRNGKey(11))[1])
BPF_OBS = np.asarray(jax_statistics.sample_from_prior(
    *blockpf_tests._models()[0][:3], blockpf_tests.T, blockpf_tests.B,
    jax.random.PRNGKey(1))[1])
BPF_BLOCKS = ((0, 1, 2, 3), (4, 5, 6, 7))
IF2_OBS = if2_tests._obs(if2_tests.T, if2_tests.B)
IF2_ROWS = {"mult": np.asarray([0.3, 0.6], np.float32)}


# ---- the distributed OT, on the smoothing tests' LGSSM.
OT_EPS, OT_ITERS, OT_KEY = 0.5, 24, jax.random.PRNGKey(3)
OT_LW = np.random.RandomState(11).randn(B, K).astype(np.float32)
OT_VALUE = {"x": np.random.RandomState(12).randn(B, K).astype(np.float32),
            "y": np.random.RandomState(13).randn(B, K, 2).astype(np.float32)}
OT_OBS = np.asarray(np.random.RandomState(11).randn(5, B), np.float32)
_OT_JAX = (jax_lgssm.Initial(0.0, 1.0), jax_lgssm.Transition.create(0.9, 1.0),
           jax_lgssm.Emission.create(1.0, 0.5),
           jax_lgssm.Proposal.create(1.0, 1.0, jax.random.PRNGKey(0)))
OT_PARAMS = lgssm_params(_OT_JAX)
OT = dict(obs=OT_OBS, params=OT_PARAMS, num_particles=K)


def _ot_normals(key, num_timesteps):
    step_keys = jax.random.split(key, (num_timesteps, 2))
    return {"normal": [normal_draw(step_keys[0, 1], (K,), (B,),
                                   batch_expanded=True)] +
            [normal_draw(step_keys[t, 1], (), (B, K))
             for t in range(1, num_timesteps)]}


LGSSM_PARAMS = lgssm_params((jax_lgssm.Initial(0.0, 1.0),
                       jax_lgssm.Transition.create(0.9, 1.0),
                       jax_lgssm.Emission.create(1.0, 0.5),
                       jax_lgssm.Proposal.create(1.0, 1.0,
                                                 jax.random.PRNGKey(3))))

FFBS = dict(latents=LATENTS, log_weights=LOG_WEIGHTS, obs=OBS,
            params=PARAMS, num_trajectories=M)
PARIS = dict(obs=OBS, params=PARAMS, num_particles=K)
CASES = {}
for _dp, _pp in MESHES:
    for _backward in ("pairwise", "rejection"):
        CASES[("ffbs", _dp, _pp, _backward)] = ("ffbs_case", dict(
            FFBS, dp=_dp, pp=_pp, backward=_backward))
        CASES[("paris", _dp, _pp, _backward)] = ("paris_case", dict(
            PARIS, dp=_dp, pp=_pp, backward=_backward,
            exchange="ring" if _pp == 4 else "allgather"))
    CASES[("online", _dp, _pp)] = ("online_e2_case", dict(
        PARIS, dp=_dp, pp=_pp))
    CASES[("rbpf", _dp, _pp)] = ("rbpf_case", dict(
        dp=_dp, pp=_pp, obs=RBPF_OBS, num_particles=K,
        via_callable=_pp == 4))
# The rejection loops with an exact fallback of one lane: they run rounds
# until at most one lane of the whole mesh is open.
CASES["ffbs_rounds"] = ("ffbs_case", dict(FFBS, dp=2, pp=2,
                                          backward="rejection",
                                          max_exact_lanes=1))
CASES["paris_rounds"] = ("paris_case", dict(PARIS, dp=2, pp=2,
                                            backward="rejection",
                                            max_exact_lanes=1))
CASES["ffbs_jax"] = ("ffbs_case", dict(FFBS, dp=2, pp=2,
                                       draws=_ffbs_draws()))
CASES["paris_jax"] = ("paris_case", dict(PARIS, dp=2, pp=2,
                                         draws=_paris_draws()))
CASES["rbpf_jax"] = ("rbpf_case", dict(dp=2, pp=2, obs=RBPF_OBS,
                                       num_particles=K,
                                       draws=_rbpf_draws()))

for _dp, _pp in MESHES:
    for _threshold in (0.95, 1.0):
        CASES[("smc2", _dp, _pp, _threshold)] = ("smc2_case", dict(
            S2, dp=_dp, pp=_pp, ess_threshold=_threshold))
    CASES[("twisted", _dp, _pp)] = ("twisted_case", dict(
        dp=_dp, pp=_pp, obs=TW_OBS, num_particles=K, twist=TWIST))
    CASES[("twisted_hmm", _dp, _pp)] = ("twisted_case", dict(
        dp=_dp, pp=_pp, obs=HMM_OBS, num_particles=K,
        twist={"logpsi": np.asarray(np.random.RandomState(8).randn(
            T, B, HMM_STATES), np.float32)}, discrete=HMM_STATES))
    CASES[("rm", _dp, _pp)] = ("resample_move_case", dict(
        dp=_dp, pp=_pp, obs=LGSSM_OBS, params=LGSSM_PARAMS, num_particles=K,
        exchange="ring" if _pp == 4 else "allgather",
        target_acceptance=0.4))
    CASES[("bpf", _dp, _pp)] = ("block_pf_case", dict(
        dp=_dp, pp=_pp, obs=LORENZ_OBS, params=LORENZ_PARAMS,
        num_particles=K, block_size=4, obs_indices=(0, 2, 4, 6),
        fused=_pp == 4))
    CASES[("sampler", _dp, _pp)] = ("sampler_case", dict(
        SAMPLER, dp=_dp, pp=_pp))
    CASES[("if2", _dp, _pp)] = ("if2_case", dict(
        dp=_dp, pp=_pp, obs=LGSSM_OBS, theta0=IF2_THETA0, num_particles=K,
        num_iterations=2))
    CASES[("ot", _dp, _pp)] = ("ot_case", dict(
        dp=_dp, pp=_pp, log_weight=OT_LW, value=OT_VALUE, epsilon=OT_EPS,
        num_iterations=OT_ITERS, grad=True))
    CASES[("ot_infer", _dp, _pp)] = ("ot_engine_case", dict(
        OT, dp=_dp, pp=_pp, num_iterations=OT_ITERS, explicit=_pp == 4))
CASES["ot_infer_jax"] = ("ot_engine_case", dict(
    OT, dp=2, pp=2, num_iterations=OT_ITERS,
    draws=_ot_normals(OT_KEY, OT_OBS.shape[0])))
CASES["ot_online"] = ("ot_engine_case", dict(
    OT, dp=1, pp=4, num_iterations=OT_ITERS, online=True))
CASES["ring_forms"] = ("ring_forms_case", dict(dp=1, pp=4))
CASES["smc2_jax"] = ("smc2_case", dict(S2, dp=2, pp=2, draws=_s2_draws()))
CASES["twisted_jax"] = ("twisted_case", dict(
    dp=2, pp=2, obs=TW_OBS, num_particles=K, twist=TWIST,
    draws={kind[:-1]: v for kind, v in twisted_tests._smc_draws(
        TW_KEY, T, B, K).items()}))
CASES["sampler_waste_free"] = ("sampler_case", dict(
    SAMPLER, dp=1, pp=4, waste_free_chains=32))
CASES["sampler_jax"] = ("sampler_case", dict(
    dp=1, pp=4, x0=samplers_tests._x0(), y=samplers_tests.Y,
    prior_scale=samplers_tests.S0, scale=samplers_tests.S,
    draws=_sampler_draws()))
# The stream on the JAX PaRIS draws: the JAX stream fed rows of
# `split_step_keys(key, T, num_streams=3)` is the offline `paris(key=)`
# (`tests/test_online.py`), so the JAX mesh PaRIS is its reference.
CASES["online_jax"] = ("online_e2_case", dict(PARIS, dp=2, pp=2,
                                              draws=_paris_draws()))
# learn_twist on the SV problem of tests/test_torch_twisted.py (float64,
# B = 2 rows, K = 64): 'best' seeded, 'last' with jittered design points
# on the JAX draws.
LEARN = dict(obs=twisted_tests._sv_problem()[0],
             num_particles=twisted_tests.LK, fit_jitter=1.5)
LEARN_BEST = dict(keep="best", keep_num_particles=twisted_tests.LK_SCORE,
                  keep_num_seeds=2)
LEARN_KEY = jax.random.PRNGKey(5)
with jax.enable_x64(True):
    _LEARN_DRAWS = {kind[:-1]: v for kind, v in twisted_tests._learn_draws(
        LEARN_KEY, 2, 1.5, "last", 1).items()}
for _dp, _pp in MESHES:
    CASES[("learn_twist", _dp, _pp)] = ("learn_twist_case", dict(
        LEARN, dp=_dp, pp=_pp, **LEARN_BEST))
CASES["learn_twist_jax"] = ("learn_twist_case", dict(
    LEARN, dp=2, pp=2, draws=_LEARN_DRAWS))
CASES["rm_jax"] = ("resample_move_case", dict(
    dp=2, pp=2, obs=RM_OBS,
    params=lgssm_params(rm_tests._components("jax", "optimal")),
    num_particles=rm_tests.K,
    draws=_lists(rm_tests._replay(rm_tests.KEY, rm_tests.T, 2, "optimal"))))
CASES["bpf_jax"] = ("block_pf_case", dict(
    dp=2, pp=2, obs=BPF_OBS, params=LORENZ_PARAMS,
    num_particles=blockpf_tests.K, block_size=4,
    obs_indices=blockpf_tests.OBS,
    draws=_lists(blockpf_tests._replay(blockpf_tests.KEY, 2,
                                       "systematic"))))
CASES["if2_jax"] = ("if2_case", dict(
    dp=2, pp=2, obs=IF2_OBS, theta0=IF2_ROWS, num_particles=if2_tests.K,
    num_iterations=if2_tests.M, cooling=0.8,
    draws=_lists(if2_tests._replay(if2_tests.KEY, if2_tests.T,
                                   if2_tests.M, 1))))


# ---- slice E3: residual resampling, the low-rank OT, TMC and the score
# estimator on a mesh, on the file's LGSSM (T, B, K) = (5, 4, 32). The
# JAX draws are replayed from E3_KEY's schedule: `infer`'s `split(key, (T,
# 2))` (residual's `[B, K]` uniforms as stratified's, multinomial's K + 1
# exponentials, the proposal's eps recovered from the JAX latents), the
# low-rank jitter from `split(keys[t, 0])`, TMC's eps from the JAX
# `infer('is')` run with the same key (TMC samples as IS does).
E3_KEY = jax.random.PRNGKey(6)
LR_RANK, LR_ITERS, LR_KEY = 4, 10, jax.random.PRNGKey(8)
RES_LW = (3.0 * np.random.RandomState(15).randn(B, K)).astype(np.float32)
RES_VALUE = {"x": np.random.RandomState(16).randn(B, K).astype(np.float32),
             "s": np.arange(B * K, dtype=np.int32).reshape(B, K) - 50}


def _replay_lists(replay):
    return {kind: [np.asarray(x) for x in xs] for kind, xs in (
        ("uniform", replay.uniforms), ("normal", replay.normals),
        ("exponential", replay.exponentials)) if xs}


def _jax_run(method, components, obs):
    """The JAX `infer` on the (2, 4) mesh from E3_KEY: log-Z, latents and
    ancestors of ``method``."""
    mesh = jax_parallel.make_mesh(data=2, particle=4)
    return jax.jit(lambda o: jax_inference.infer(
        "smc", o, *components, K, key=E3_KEY, resampling_method=method,
        mesh=mesh, return_log_marginal_likelihood=True,
        return_original_latents=True, return_ancestral_indices=True,
        return_latents=False, return_log_weight=False))(jnp.asarray(obs))


# Residual against JAX on the OT cases' LGSSM: under the file's exact
# proposal every K w sits at 1, where the two packages' float32
# exponentials put floor(K w) on either side (one device against one
# device too); that proposal's weights are spread.
RES_JAX = _jax_run("residual", _OT_JAX, OT_OBS)
MULTINOMIAL_JAX = _jax_run("multinomial", _jax_components(), OBS)


def _e3_draws(run, method, components, obs):
    return _replay_lists(replayed_noise(
        components[3], obs, E3_KEY, run["original_latents"],
        run["ancestral_indices"], method))


def _lowrank_draws(key, num_timesteps):
    """The low-rank engine's draws from ``key``: the proposal's normals
    and each step's two `[B, K, r]` jitter draws before them."""
    keys = jax.random.split(key, (num_timesteps, 2))
    normals = [normal_draw(keys[0, 1], (K,), (B,), batch_expanded=True)]
    for t in range(1, num_timesteps):
        normals += [np.asarray(jax.random.normal(kk, (B, K, LR_RANK)))
                    for kk in jax.random.split(keys[t, 0])]
        normals.append(normal_draw(keys[t, 1], (), (B, K)))
    return {"normal": normals}


def _tmc_draws():
    latents = jax_inference.infer("is", jnp.asarray(OBS), *_jax_components(),
                                  K, key=E3_KEY)["latents"]
    return {"normal": proposal_eps(torch_dist.lgssm_components(PARAMS)[3],
                                   OBS, latents, None)}


LR_DIRECT_DRAWS = {"normal": [np.asarray(jax.random.normal(kk, (B, K,
                                                                LR_RANK)))
                              for kk in jax.random.split(LR_KEY)]}
E3 = dict(obs=OBS, params=PARAMS, num_particles=K)
for _dp, _pp in MESHES:
    CASES[("residual", _dp, _pp)] = ("residual_case", dict(E3, dp=_dp,
                                                           pp=_pp))
    CASES[("residual_online", _dp, _pp)] = ("residual_case", dict(
        E3, dp=_dp, pp=_pp, online=True))
    CASES[("residual_direct", _dp, _pp)] = ("residual_direct_case", dict(
        dp=_dp, pp=_pp, log_weight=RES_LW, value=RES_VALUE))
    CASES[("residual_loss", _dp, _pp)] = ("loss_case", dict(
        E3, dp=_dp, pp=_pp, algorithm="aesmc", resampling_method="residual"))
    CASES[("lowrank", _dp, _pp)] = ("lowrank_case", dict(
        dp=_dp, pp=_pp, log_weight=OT_LW, value=OT_VALUE, rank=LR_RANK,
        num_iterations=LR_ITERS, draws=LR_DIRECT_DRAWS))
    CASES[("lowrank_infer", _dp, _pp)] = ("lowrank_engine_case", dict(
        OT, dp=_dp, pp=_pp, rank=LR_RANK, num_iterations=LR_ITERS))
    CASES[("tmc", _dp, _pp)] = ("loss_case", dict(E3, dp=_dp, pp=_pp,
                                                  algorithm="tmc"))
    CASES[("tmc_train", _dp, _pp)] = ("train_case", dict(
        E3, dp=_dp, pp=_pp, algorithm="tmc", steps=2))
    for _baseline in ("batch", "none"):
        CASES[("score", _dp, _pp, _baseline)] = ("loss_case", dict(
            E3, dp=_dp, pp=_pp, algorithm="aesmc",
            resampling_method="multinomial", gradient_estimator="score",
            score_baseline=_baseline))
CASES["residual_jax"] = ("residual_case", dict(
    OT, dp=2, pp=2, draws=_e3_draws(RES_JAX, "residual", _OT_JAX, OT_OBS)))
CASES["lowrank_online"] = ("lowrank_engine_case", dict(
    OT, dp=1, pp=4, rank=LR_RANK, num_iterations=LR_ITERS, online=True))
CASES["lowrank_infer_jax"] = ("lowrank_engine_case", dict(
    OT, dp=2, pp=2, rank=LR_RANK, num_iterations=LR_ITERS,
    draws=_lowrank_draws(OT_KEY, OT_OBS.shape[0])))
CASES["tmc_jax"] = ("loss_case", dict(E3, dp=2, pp=2, algorithm="tmc",
                                      draws=_tmc_draws()))
for _baseline in ("batch", "none"):
    CASES[("score_jax", _baseline)] = ("loss_case", dict(
        E3, dp=2, pp=2, algorithm="aesmc", resampling_method="multinomial",
        gradient_estimator="score", score_baseline=_baseline,
        draws=_e3_draws(MULTINOMIAL_JAX, "multinomial", _jax_components(),
                        OBS)))



@pytest.fixture(scope="module")
def world():
    names = list(CASES)
    results = torch_dist.run_world(WORLD, [CASES[n] for n in names])
    return dict(zip(names, results))


def _components():
    return torch_dist.lgssm_components(PARAMS)


def _rows(results, key, dp, pp, dim=0):
    """A per-row output (the same on every particle rank), all rows."""
    return np.concatenate([results[d * pp][key] for d in range(dp)],
                          axis=dim)


def _seeded():
    return NoiseSource.seeded(0, "cpu")


@pytest.fixture(scope="module")
def jax_mesh():
    return jax_parallel.make_mesh(data=2, particle=4)


class TestBackwardSimulation:
    @pytest.mark.parametrize("dp,pp", MESHES)
    @pytest.mark.parametrize("backward", ["pairwise", "rejection"])
    def test_equals_single_device(self, world, dp, pp, backward):
        results = world[("ffbs", dp, pp, backward)]
        want = smoothing.backward_simulation(
            torch.tensor(LATENTS), torch.tensor(LOG_WEIGHTS),
            _components()[1], M, _seeded(), observations=torch.tensor(OBS),
            backward=backward)
        np.testing.assert_array_equal(_rows(results, "traj", dp, pp, 1),
                                      want.numpy())
        # The trajectories are replicated over the particle group.
        for r in range(WORLD):
            np.testing.assert_array_equal(
                results[r]["traj"], results[r - r % pp]["traj"])

    def test_rejection_rounds_follow_the_mesh(self, world):
        # One fallback lane: the loop runs while more than one lane of the
        # whole mesh is open. The ranks' own counts differ round by round,
        # and one rank alone would have stopped while another had lanes
        # open; every rank read the mesh's count and ran the same rounds.
        results = world["ffbs_rounds"]
        lanes = [r["lanes"] for r in results]
        assert len({len(x) for x in lanes}) == 1
        assert len(lanes[0]) > 1
        for i in range(len(lanes[0])):
            counts = [x[i] for x in lanes]
            assert len({total for _, total in counts}) == 1
            # FFBS's trajectories are the same on a particle group: the
            # data ranks' own counts add up to the mesh's.
            assert sum(own for own, _ in counts[::2]) == counts[0][1]
        assert any(min(own for own, _ in (x[i] for x in lanes)) <= 1 <
                   lanes[0][i][1] for i in range(len(lanes[0])))
        want = smoothing.backward_simulation(
            torch.tensor(LATENTS), torch.tensor(LOG_WEIGHTS),
            _components()[1], M, _seeded(), observations=torch.tensor(OBS),
            backward="rejection", max_exact_lanes=1)
        np.testing.assert_array_equal(_rows(results, "traj", 2, 2, 1),
                                      want.numpy())

    def test_matches_jax_mesh(self, world, jax_mesh):
        want = jax.jit(lambda lat, lw: jax_smoothing.backward_simulation(
            lat, lw, _jax_components()[1], M, FFBS_KEY,
            observations=jnp.asarray(OBS), mesh=jax_mesh))(
                jnp.asarray(LATENTS), jnp.asarray(LOG_WEIGHTS))
        np.testing.assert_allclose(
            _rows(world["ffbs_jax"], "traj", 2, 2, 1), np.asarray(want),
            atol=1e-5)


def _paris_single(backward, max_exact_lanes=None):
    with torch.no_grad():
        return smoothing.paris(
            torch.tensor(OBS), *_components(), K, h=torch_dist._paris_h,
            h0=torch_dist._paris_h0, noise=_seeded(), num_backward_draws=2,
            backward=backward, max_exact_lanes=max_exact_lanes)


@pytest.fixture(scope="module")
def jax_paris(jax_mesh):
    """The JAX PaRIS on the (2, 4) mesh from ``PARIS_KEY``."""
    return jax.jit(lambda o: jax_smoothing.paris(
        o, *_jax_components(), K, h=torch_dist._paris_h,
        h0=torch_dist._paris_h0, key=PARIS_KEY, num_backward_draws=2,
        mesh=jax_mesh))(jnp.asarray(OBS))


class TestParis:
    @pytest.mark.parametrize("dp,pp", MESHES)
    @pytest.mark.parametrize("backward", ["pairwise", "rejection"])
    def test_equals_single_device(self, world, dp, pp, backward):
        results = world[("paris", dp, pp, backward)]
        want = _paris_single(backward)
        for name in ("tau", "log_weight"):
            np.testing.assert_allclose(
                torch_dist.assemble([r[name] for r in results], dp, pp),
                want[name].numpy(), atol=1e-5, err_msg=name)
        for name in ("smoothed", "log_marginal_likelihood"):
            np.testing.assert_allclose(_rows(results, name, dp, pp),
                                       want[name].numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=name)
        if backward == "rejection":
            np.testing.assert_array_equal(
                _rows(results, "backward_accept_rate", dp, pp),
                want["backward_accept_rate"].numpy())
            np.testing.assert_array_equal(
                _rows(results, "backward_unconverged", dp, pp),
                want["backward_unconverged"].numpy())

    def test_rejection_rounds_follow_the_mesh(self, world):
        # Children are sharded: every rank's own open lanes add up to the
        # mesh's count, which every rank reads.
        results = world["paris_rounds"]
        lanes = [r["lanes"] for r in results]
        assert len({len(x) for x in lanes}) == 1
        for i in range(len(lanes[0])):
            counts = [x[i] for x in lanes]
            assert len({total for _, total in counts}) == 1
            assert sum(own for own, _ in counts) == counts[0][1]
        assert any(min(own for own, _ in (x[i] for x in lanes)) <= 1 <
                   lanes[0][i][1] for i in range(len(lanes[0])))
        want = _paris_single("rejection", max_exact_lanes=1)
        np.testing.assert_allclose(
            torch_dist.assemble([r["tau"] for r in results], 2, 2),
            want["tau"].numpy(), atol=1e-5)
        np.testing.assert_array_equal(
            _rows(results, "backward_unconverged", 2, 2),
            want["backward_unconverged"].numpy())

    def test_matches_jax_mesh(self, world, jax_paris):
        want = jax_paris
        results = world["paris_jax"]
        for name in ("tau", "log_weight"):
            np.testing.assert_allclose(
                torch_dist.assemble([r[name] for r in results], 2, 2),
                np.asarray(want[name]), atol=1e-4, err_msg=name)
        for name in ("smoothed", "log_marginal_likelihood"):
            np.testing.assert_allclose(_rows(results, name, 2, 2),
                                       np.asarray(want[name]), atol=1e-4,
                                       err_msg=name)


class TestStreaming:
    @pytest.mark.parametrize("dp,pp", MESHES)
    def test_paris_and_genealogy_equal_unsharded_stream(self, world, dp, pp):
        results = world[("online", dp, pp)]
        init_fn, step_fn = online.make_online_filter(
            *_components(), K, return_ancestors=True, track_genealogy=True,
            paris_h=torch_dist._paris_h, paris_h0=torch_dist._paris_h0)
        noise = _seeded()
        obs = torch.tensor(OBS)
        with torch.no_grad():
            fs = init_fn(obs[0], noise)
            for t in range(1, T):
                fs, info = step_fn(fs, obs[t], noise)
                infos = [r["infos"][t - 1] for r in results]
                np.testing.assert_array_equal(
                    torch_dist.assemble([i["ancestral_index"] for i in infos],
                                        dp, pp),
                    info["ancestral_index"].numpy())
                for name in ("paris_smoothed", "log_z_rel_var"):
                    np.testing.assert_allclose(
                        np.concatenate([infos[d * pp][name]
                                        for d in range(dp)]),
                        info[name].numpy(), rtol=1e-5, atol=1e-5,
                        err_msg=name)
        np.testing.assert_array_equal(
            torch_dist.assemble([r["eve"] for r in results], dp, pp),
            fs.eve.numpy())
        # The stream's tau against the offline smoother's.
        offline = _paris_single("pairwise")
        np.testing.assert_allclose(
            torch_dist.assemble([r["tau"] for r in results], dp, pp),
            offline["tau"].numpy(), rtol=2e-5, atol=1e-4)


    def test_matches_jax_mesh_paris(self, world, jax_paris):
        # The stream on the JAX draws against the JAX mesh PaRIS (the JAX
        # stream on the same keys is that offline smoother,
        # tests/test_online.py): tau within its rtol 2e-5 / atol 1e-4,
        # the last step's smoothed estimate within 1e-4.
        results = world["online_jax"]
        np.testing.assert_allclose(
            torch_dist.assemble([r["tau"] for r in results], 2, 2),
            np.asarray(jax_paris["tau"]), rtol=2e-5, atol=1e-4)
        np.testing.assert_allclose(
            np.concatenate([results[d * 2]["infos"][-1]["paris_smoothed"]
                            for d in range(2)]),
            np.asarray(jax_paris["smoothed"]), atol=1e-4)


class TestRbpf:
    @pytest.mark.parametrize("dp,pp", MESHES)
    def test_equals_single_device(self, world, dp, pp):
        # (1, 4): the distributed resampler alone, no mesh=.
        results = world[("rbpf", dp, pp)]
        want = rbpf.rbpf(torch.tensor(RBPF_OBS), num_particles=K,
                         noise=_seeded(), ess_threshold=0.5,
                         return_history=True,
                         **torch_dist.switching_rbpf_components())
        np.testing.assert_array_equal(
            torch_dist.assemble([r["nonlinear_latents_history"]
                                 for r in results], dp, pp, 1, 2),
            want["nonlinear_latents_history"].numpy())
        np.testing.assert_allclose(
            _rows(results, "log_marginal_likelihood", dp, pp),
            want["log_marginal_likelihood"].numpy(), rtol=1e-5)
        np.testing.assert_allclose(
            _rows(results, "filtered_means", dp, pp, 1),
            want["filtered_means"].numpy(), atol=1e-5)

    def test_matches_jax_mesh(self, world, jax_mesh):
        from aesmc_tpu import distributions as jax_dists
        from aesmc_tpu import math as jax_math

        def f(x):
            return jnp.asarray(np.asarray(x, np.float32))

        pmat = np.log([[0.85, 0.15], [0.3, 0.7]])
        a = np.array([[1.0, 0.1], [0.0, 1.0]])
        comps = dict(
            initial=lambda: jax_dists.Categorical(
                logits=f(np.log([0.6, 0.4]))),
            transition=lambda previous_latents, time: jax_dists.Categorical(
                logits=jax_math.table_lookup(f(pmat), previous_latents[0])),
            linear_initial=lambda u0: (f(np.zeros(2)), f(np.eye(2))),
            linear_dynamics=lambda u, time: (
                jax_math.table_lookup(f([0.95, 0.2]), u)[..., None, None] *
                f(a), f(np.zeros(2)), f(0.5 * np.eye(2))),
            linear_emission=lambda u, time: (f([[1.0, 0.5]]), f(np.zeros(1)),
                                             f([[0.09]])))
        want = jax.jit(lambda o: jax_rbpf.rbpf(
            o, num_particles=K, key=RBPF_KEY, ess_threshold=0.5,
            mesh=jax_mesh, **comps))(jnp.asarray(RBPF_OBS))
        results = world["rbpf_jax"]
        np.testing.assert_allclose(
            _rows(results, "log_marginal_likelihood", 2, 2),
            np.asarray(want["log_marginal_likelihood"]), atol=1e-4,
            rtol=1e-4)
        np.testing.assert_allclose(
            _rows(results, "filtered_means", 2, 2, 1),
            np.asarray(want["filtered_means"]), atol=1e-3)


class TestSMC2:
    @pytest.mark.parametrize("dp,pp", MESHES)
    @pytest.mark.parametrize("threshold", [0.95, 1.0])
    def test_equals_single_device(self, world, dp, pp, threshold):
        # The theta resampling and the PMMH reruns on the mesh: at 0.95
        # three of the five steps rejuvenate, at 1.0 every step.
        results = world[("smc2", dp, pp, threshold)]
        build, log_prior = torch_dist.smc2_problem()
        want = smc2.smc2(torch.tensor(S2_OBS), build,
                         {"mult": torch.tensor(S2_THETA0["mult"])},
                         log_prior, smc2_tests.K, noise=_seeded(),
                         ess_threshold=threshold, num_moves=2,
                         return_history=True)
        assert int(want["num_rejuvenations"]) == (
            smc2_tests.T - 1 if threshold == 1.0 else 3)
        # Every rank: the thetas are sharded over the data (theta) axis
        # and the same on every rank of a particle group.
        for rank, got in enumerate(results):
            assert int(got["num_rejuvenations"]) == int(
                want["num_rejuvenations"])
            for name in ("log_evidence", "ess_path", "acceptance_rate"):
                np.testing.assert_allclose(
                    got[name], want[name].detach().numpy(), rtol=1e-5,
                    atol=1e-5, err_msg=name)
            rows = slice(rank // pp * (smc2_tests.M // dp),
                         (rank // pp + 1) * (smc2_tests.M // dp))
            np.testing.assert_allclose(
                got["log_theta_weight"],
                want["log_theta_weight"].detach().numpy()[rows], rtol=1e-5,
                atol=1e-5)
            np.testing.assert_array_equal(
                got["theta"]["mult"],
                want["theta"]["mult"].detach().numpy()[rows])

    def test_matches_jax_mesh(self, world):
        got = world["smc2_jax"][0]
        np.testing.assert_allclose(got["log_evidence"],
                                   float(S2_JAX["log_evidence"]), atol=1e-4)
        np.testing.assert_allclose(got["ess_path"],
                                   np.asarray(S2_JAX["ess_path"]),
                                   rtol=1e-4)


class TestTwisted:
    def _components(self):
        spec = twisted.GaussianSSMSpec(
            initial_loc=0.0, initial_scale=1.0, transition_scale=1.0,
            mean_fn=lambda x, t: 0.9 * x)
        return spec, twisted_tests._emission("torch")

    @pytest.mark.parametrize("dp,pp", MESHES)
    def test_equals_single_device(self, world, dp, pp):
        results = world[("twisted", dp, pp)]
        spec, emission = self._components()
        want = twisted.twisted_smc(
            torch.tensor(TW_OBS), spec, emission,
            twisted.QuadraticTwist(**{k: torch.tensor(v)
                                      for k, v in TWIST.items()}),
            K, noise=_seeded(), return_latents=True,
            return_ancestral_indices=True)
        np.testing.assert_array_equal(
            torch_dist.assemble([r["ancestral_indices"] for r in results],
                                dp, pp, 1, 2),
            want["ancestral_indices"].detach().numpy())
        np.testing.assert_array_equal(
            torch_dist.assemble([r["latents"] for r in results], dp, pp,
                                1, 2), want["latents"].detach().numpy())
        np.testing.assert_allclose(
            _rows(results, "log_marginal_likelihood", dp, pp),
            want["log_marginal_likelihood"].detach().numpy(), rtol=1e-6)

    @pytest.mark.parametrize("dp,pp", MESHES)
    def test_hmm_equals_single_device(self, world, dp, pp):
        # int32 particles (K5 on the card), t = 0 draws particle-major.
        results = world[("twisted_hmm", dp, pp)]
        comps = hmm.make_model(num_states=HMM_STATES, emission_scale=0.6,
                               stay_prob=0.85, device="cpu")
        spec = twisted.DiscreteSSMSpec(comps[0].logits, comps[1].logits)
        logpsi = CASES[("twisted_hmm", dp, pp)][1]["twist"]["logpsi"]
        want = twisted.twisted_smc(
            torch.tensor(HMM_OBS), spec, comps[2],
            twisted.TabularTwist(logpsi=torch.tensor(logpsi)), K,
            noise=_seeded(), return_latents=True,
            return_ancestral_indices=True)
        latents = torch_dist.assemble([r["latents"] for r in results], dp,
                                      pp, 1, 2)
        assert latents.dtype == np.int32
        np.testing.assert_array_equal(latents,
                                      want["latents"].detach().numpy())
        np.testing.assert_allclose(
            _rows(results, "log_marginal_likelihood", dp, pp),
            want["log_marginal_likelihood"].detach().numpy(), rtol=1e-6)

    def test_matches_jax_mesh(self, world):
        spec = twisted_tests._spec("jax")
        mesh = jax_parallel.make_mesh(data=2, particle=4)
        want = jax.jit(lambda o: jax_twisted.twisted_smc(
            o, spec, twisted_tests._emission("jax"), _TWIST, K, key=TW_KEY,
            mesh=mesh))(jnp.asarray(TW_OBS))
        np.testing.assert_allclose(
            _rows(world["twisted_jax"], "log_marginal_likelihood", 2, 2),
            np.asarray(want["log_marginal_likelihood"]), atol=1e-4)


class TestLearnTwist:
    @pytest.mark.parametrize("dp,pp", MESHES)
    def test_equals_single_device(self, world, dp, pp):
        # Every rank holds the global twist, evidence and scores.
        results = world[("learn_twist", dp, pp)]
        want_tw, want = twisted.learn_twist(
            torch.tensor(LEARN["obs"]), *torch_dist.sv_twist_problem(),
            LEARN["num_particles"], noise=_seeded(),
            fit_jitter=LEARN["fit_jitter"], **LEARN_BEST)
        for r in results:
            for name in ("A", "b", "c"):
                np.testing.assert_allclose(
                    r[name], getattr(want_tw, name).numpy(), rtol=1e-8,
                    atol=1e-10, err_msg=name)
            for name in ("log_marginal_likelihood", "scores"):
                np.testing.assert_allclose(r[name], want[name].numpy(),
                                           rtol=1e-8, err_msg=name)
            np.testing.assert_array_equal(r["selected"],
                                          want["selected"].numpy())

    def test_matches_jax_mesh(self, world, jax_mesh):
        # The JAX learn_twist with mesh= among its keyword arguments (its
        # runs are `infer(mesh=)`), float64, at the replay test's bars
        # (tests/test_torch_twisted.py).
        _, emission, spec = twisted_tests._sv_problem()
        with jax.enable_x64(True):
            tw, info = jax_twisted.learn_twist(
                jnp.asarray(LEARN["obs"]), spec("jax"), emission("jax"),
                LEARN["num_particles"], key=LEARN_KEY, num_iterations=2,
                fit_jitter=LEARN["fit_jitter"], mesh=jax_mesh)
            want = {"A": np.asarray(tw.A), "b": np.asarray(tw.b),
                    "c": np.asarray(tw.c),
                    "log_marginal_likelihood": np.asarray(
                        info["log_marginal_likelihood"])}
        for r in world["learn_twist_jax"]:
            for name in ("A", "b", "c"):
                np.testing.assert_allclose(r[name], want[name], rtol=1e-8,
                                           atol=1e-10, err_msg=name)
            np.testing.assert_allclose(r["log_marginal_likelihood"],
                                       want["log_marginal_likelihood"],
                                       rtol=1e-8)


@pytest.mark.parametrize("dp,pp", MESHES)
def test_resample_move_equals_single_device(world, dp, pp):
    results = world[("rm", dp, pp)]
    want = resample_move.resample_move_filter(
        torch.tensor(LGSSM_OBS), *torch_dist.lgssm_components(LGSSM_PARAMS), K,
        noise=_seeded(), target_acceptance=0.4)
    np.testing.assert_allclose(
        _rows(results, "log_marginal_likelihood", dp, pp),
        want["log_marginal_likelihood"].detach().numpy(), rtol=1e-5)
    np.testing.assert_allclose(_rows(results, "acceptance_rate", dp, pp, 1),
                               want["acceptance_rate"].detach().numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(
        torch_dist.assemble([r["latents"] for r in results], dp, pp, 1, 2),
        want["latents"].detach().numpy(), atol=1e-5)


def test_resample_move_matches_jax_mesh(world, jax_mesh):
    # The JAX filter through its distributed resampler on the (2, 4) mesh,
    # at the replay test's bars (tests/test_torch_resample_move.py).
    want = jax.jit(lambda o: jax_rm.resample_move_filter(
        o, *rm_tests._components("jax", "optimal"), rm_tests.K,
        key=rm_tests.KEY,
        resampling_implementation=jax_parallel.make_distributed_resampler(
            jax_mesh)))(jnp.asarray(RM_OBS))
    results = world["rm_jax"]
    np.testing.assert_allclose(_rows(results, "acceptance_rate", 2, 2, 1),
                               np.asarray(want["acceptance_rate"]),
                               rtol=1e-6)
    np.testing.assert_allclose(
        _rows(results, "log_marginal_likelihood", 2, 2),
        np.asarray(want["log_marginal_likelihood"]), rtol=1e-5, atol=1e-5)
    for name in ("latents", "log_weight"):
        dims = (1, 2) if name == "latents" else (0, 1)
        np.testing.assert_allclose(
            torch_dist.assemble([r[name] for r in results], 2, 2, *dims),
            np.asarray(want[name]), rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("dp,pp", MESHES)
def test_block_pf_equals_single_device(world, dp, pp):
    results = world[("bpf", dp, pp)]
    comps = torch_dist.lorenz_components(LORENZ_PARAMS)
    want = blockpf.block_pf(
        torch.tensor(LORENZ_OBS), *comps[:3], K,
        blockpf.contiguous_blocks(8, 4), noise=_seeded(),
        obs_indices=(0, 2, 4, 6), return_log_marginal_likelihood=True,
        return_ancestral_indices=True)
    np.testing.assert_array_equal(
        torch_dist.assemble([r["ancestral_indices"] for r in results],
                            dp, pp, 2, 3),
        want["ancestral_indices"].detach().numpy())
    np.testing.assert_array_equal(
        torch_dist.assemble([r["latents"] for r in results], dp, pp, 1, 2),
        want["latents"].detach().numpy())
    np.testing.assert_allclose(
        _rows(results, "log_marginal_likelihood", dp, pp),
        want["log_marginal_likelihood"].detach().numpy(), rtol=1e-6)


def test_block_pf_matches_jax_mesh(world, jax_mesh):
    # The JAX block filter vmaps its distributed resampler over the blocks;
    # the replay test's bars: ancestors exactly, the rest within 1e-5.
    comps = blockpf_tests._models()[0][:3]
    want = jax.jit(lambda o: jax_blockpf.block_pf(
        o, *comps, blockpf_tests.K, BPF_BLOCKS, key=blockpf_tests.KEY,
        obs_indices=blockpf_tests.OBS,
        resampling_implementation=jax_parallel.make_distributed_resampler(
            jax_mesh), return_log_marginal_likelihood=True,
        return_log_weights=True, return_ancestral_indices=True))(
            jnp.asarray(BPF_OBS))
    results = world["bpf_jax"]
    np.testing.assert_array_equal(
        torch_dist.assemble([r["ancestral_indices"] for r in results],
                            2, 2, 2, 3), np.asarray(want["ancestral_indices"]))
    for name, dims in (("latents", (1, 2)), ("log_weights", (1, 2)),
                       ("log_weight", (0, 1))):
        np.testing.assert_allclose(
            torch_dist.assemble([r[name] for r in results], 2, 2, *dims),
            np.asarray(want[name]), rtol=1e-5, atol=1e-5, err_msg=name)
    np.testing.assert_allclose(
        _rows(results, "log_marginal_likelihood", 2, 2),
        np.asarray(want["log_marginal_likelihood"]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dp,pp", MESHES)
def test_sampler_equals_single_device(world, dp, pp):
    results = world[("sampler", dp, pp)]
    if dp > 1:
        # The cloud has no batch axis to put on the data axis.
        assert all("data axis" in r["error"] for r in results)
        return
    want = samplers.smc_sampler(
        *torch_dist.sampler_problem(SAMPLER["y"], SAMPLER["prior_scale"],
                                    SAMPLER["scale"]),
        torch.tensor(SAMPLER["x0"]), noise=_seeded(), num_moves=2,
        step_size=0.4)
    got = results[0]
    assert int(got["num_steps"]) == int(want["num_steps"])
    np.testing.assert_allclose(got["log_normalizer"],
                               float(want["log_normalizer"]), rtol=1e-4,
                               atol=1e-4)
    particles = np.concatenate([results[p]["particles"] for p in range(pp)])
    np.testing.assert_allclose(particles.mean(0),
                               want["particles"].detach().numpy().mean(0),
                               atol=1e-3)


def test_sampler_matches_jax_mesh(world):
    # The JAX test's bars on its mesh (tests/test_samplers.py:160-195): the
    # same rungs, log Z within 1e-4, particle means within 1e-3.
    results = world["sampler_jax"]
    want = SAMPLER_JAX
    assert int(results[0]["num_steps"]) == int(want["num_steps"])
    np.testing.assert_allclose(results[0]["log_normalizer"],
                               float(want["log_normalizer"]), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(
        np.concatenate([r["particles"] for r in results]).mean(0),
        np.asarray(want["particles"]).mean(0), atol=1e-3)


def test_waste_free_sampler_equals_single_device(world):
    results = world["sampler_waste_free"]
    want = samplers.smc_sampler(
        *torch_dist.sampler_problem(SAMPLER["y"], SAMPLER["prior_scale"],
                                    SAMPLER["scale"]),
        torch.tensor(SAMPLER["x0"]), noise=_seeded(), num_moves=2,
        step_size=0.4, waste_free_chains=32)
    assert int(results[0]["num_steps"]) == int(want["num_steps"])
    np.testing.assert_allclose(results[0]["log_normalizer"],
                               float(want["log_normalizer"]), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(
        np.concatenate([r["particles"] for r in results]).mean(0),
        want["particles"].detach().numpy().mean(0), atol=1e-3)


@pytest.mark.parametrize("dp,pp", MESHES)
def test_if2_equals_single_device(world, dp, pp):
    results = world[("if2", dp, pp)]
    want = if2.if2(torch.tensor(LGSSM_OBS), torch_dist.if2_build(),
                   {"mult": torch.tensor(IF2_THETA0["mult"])},
                   {"mult": 0.1}, num_particles=K, num_iterations=2,
                   noise=_seeded())
    np.testing.assert_allclose(
        _rows(results, "log_likelihoods", dp, pp, 1),
        want["log_likelihoods"].detach().numpy(), rtol=1e-5)
    np.testing.assert_allclose(
        np.concatenate([results[d * pp]["theta_mean"]["mult"]
                        for d in range(dp)]),
        want["theta_mean"]["mult"].detach().numpy(), atol=1e-5)
    np.testing.assert_allclose(
        torch_dist.assemble([r["theta"]["mult"] for r in results], dp, pp),
        want["theta"]["mult"].detach().numpy(), atol=1e-5)


def test_if2_matches_jax_mesh(world, jax_mesh):
    # Per-row centres on a (2, n) mesh; the replay test's bars
    # (tests/test_torch_if2.py).
    want = jax.jit(lambda o: jax_if2.if2(
        o, if2_tests._build("jax"), IF2_ROWS, {"mult": 0.1},
        num_particles=if2_tests.K, num_iterations=if2_tests.M,
        key=if2_tests.KEY, cooling=0.8,
        resampling_implementation=jax_parallel.make_distributed_resampler(
            jax_mesh)))(jnp.asarray(IF2_OBS))
    results = world["if2_jax"]
    np.testing.assert_allclose(
        torch_dist.assemble([r["theta"]["mult"] for r in results], 2, 2),
        np.asarray(want["theta"]["mult"]), rtol=1e-5, atol=1e-6)
    for name, dim in (("theta_mean", 0), ("theta_trajectory", 1)):
        np.testing.assert_allclose(
            np.concatenate([results[d * 2][name]["mult"] for d in range(2)],
                           axis=dim),
            np.asarray(want[name]["mult"]), rtol=1e-5, atol=1e-6,
            err_msg=name)
    np.testing.assert_allclose(_rows(results, "log_likelihoods", 2, 2, 1),
                               np.asarray(want["log_likelihoods"]),
                               rtol=1e-5)


@pytest.fixture(scope="module")
def jax_ot(jax_mesh):
    """The JAX distributed OT on the (2, 4) mesh: the transported value
    and the gradients of sum(x^2) + sum(y)."""
    value = {k: jnp.asarray(v) for k, v in OT_VALUE.items()}
    dist = jax_parallel.make_distributed_ot_resampler(
        jax_mesh, epsilon=OT_EPS, num_iterations=OT_ITERS)

    def loss(lw_, vx):
        out, _ = dist(lw_, {**value, "x": vx})
        return jnp.sum(out["x"] ** 2) + jnp.sum(out["y"])

    got, _ = jax.jit(dist)(jnp.asarray(OT_LW), value)
    grads = jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(OT_LW),
                                                    value["x"])
    return got, dict(zip(("grad_lw", "grad_x"), grads))


class TestDistributedOT:
    @pytest.mark.parametrize("dp,pp", MESHES)
    def test_matches_jax_and_single_device(self, world, jax_ot, dp, pp):
        results = world[("ot", dp, pp)]
        got_jax, grads = jax_ot
        single, _ = ot.ot_resample(
            torch.tensor(OT_LW), {k: torch.tensor(v)
                                  for k, v in OT_VALUE.items()},
            epsilon=OT_EPS, num_iterations=OT_ITERS)
        for k in OT_VALUE:
            got = torch_dist.assemble([r["value"][k] for r in results],
                                      dp, pp)
            np.testing.assert_allclose(got, np.asarray(got_jax[k]),
                                       atol=1e-4, rtol=1e-4)
            np.testing.assert_allclose(got, single[k].numpy(), atol=1e-4,
                                       rtol=1e-4)
        assert not any(r["new_log_weight"].any() for r in results)
        for name, want in grads.items():
            np.testing.assert_allclose(
                torch_dist.assemble([r[name] for r in results], dp, pp),
                np.asarray(want), atol=2e-4, rtol=1e-3, err_msg=name)

    @pytest.mark.parametrize("dp,pp", MESHES)
    def test_engine_equals_single_device(self, world, dp, pp):
        # (2, 2): infer's default ring; (1, 4): the explicit resampler.
        results = world[("ot_infer", dp, pp)]
        want = inference.infer(
            "smc", torch.tensor(OT_OBS),
            *torch_dist.lgssm_components(OT_PARAMS), K, noise=_seeded(),
            resampling_method="ot", ot_num_iterations=OT_ITERS,
            return_log_marginal_likelihood=True, return_latents=False)
        np.testing.assert_allclose(
            _rows(results, "log_marginal_likelihood", dp, pp),
            want["log_marginal_likelihood"].detach().numpy(), atol=1e-4)

    def test_engine_matches_jax_mesh(self, world, jax_mesh):
        dist = jax_parallel.make_distributed_ot_resampler(
            jax_mesh, epsilon=OT_EPS, num_iterations=OT_ITERS)
        want = jax.jit(lambda o: jax_inference.infer(
            "smc", o, *_OT_JAX, K, key=OT_KEY, resampling_method="ot",
            resampling_implementation=dist, mesh=jax_mesh,
            ot_num_iterations=OT_ITERS, return_log_marginal_likelihood=True,
            return_latents=False, return_log_weight=False))(
                jnp.asarray(OT_OBS))
        np.testing.assert_allclose(
            _rows(world["ot_infer_jax"], "log_marginal_likelihood", 2, 2),
            np.asarray(want["log_marginal_likelihood"]), atol=1e-4)

    def test_streaming_filter_equals_single_device(self, world):
        init_fn, step_fn = online.make_online_filter(
            *torch_dist.lgssm_components(OT_PARAMS), K,
            resampling_method="ot", ot_num_iterations=OT_ITERS)
        noise = _seeded()
        obs = torch.tensor(OT_OBS)
        fs = init_fn(obs[0], noise)
        preds = []
        for t in range(1, OT_OBS.shape[0]):
            fs, info = step_fn(fs, obs[t], noise)
            preds.append(info["log_pred"].detach().numpy())
        np.testing.assert_allclose(world["ot_online"][0]["log_pred"],
                                   np.stack(preds), atol=1e-4)


def test_ring_shift_forms_are_bit_equal(world):
    # gloo stages device tensors through host copies (`_shift_staged`);
    # on host tensors it sends them as they are. Both forms move the same
    # bits, one rank along the ring and back.
    results = world["ring_forms"]
    for rank, r in enumerate(results):
        assert not r["staged_for_host_tensors"]
        for step in (1, -1):
            direct, staged = r[step]
            src = results[(rank + step) % WORLD]
            for d, s in zip(direct, staged):
                assert d.dtype == s.dtype
                np.testing.assert_array_equal(d, s)
            for d, mine in zip(direct, src["mine"]):
                np.testing.assert_array_equal(d, mine)


# ---- slice E3 ----------------------------------------------------------

def _single_lgssm(params=PARAMS):
    return torch_dist.lgssm_components(params)


def _mean_grads(results):
    """The mean of the ranks' gradients: the single-device gradient
    (`parallel.sharded`)."""
    return [np.mean([r["grads"][i] for r in results], axis=0)
            for i in range(len(results[0]["grads"]))]


def _single_grads(algorithm, noise, params=PARAMS, obs=OBS, **kwargs):
    comps = _single_lgssm(params)
    loss = losses.get_loss(torch.tensor(obs), K, algorithm, *comps,
                           noise=noise, **kwargs)
    loss.backward()
    return float(loss.detach()), torch_dist._grads(comps)


def _assert_grads(got, want, rtol, atol=0.0):
    """Each leaf within ``rtol`` times its largest entry, plus ``atol``."""
    for i, (g, w) in enumerate(zip(got, want)):
        bar = rtol * float(np.abs(w).max()) + atol
        np.testing.assert_allclose(g, w, rtol=0, atol=bar, err_msg=f"{i}")


class TestResidual:
    """Residual resampling on a mesh (the residual exchange) against the
    single-device port call on the same seed: ancestors and latents
    exactly (every rank computes the copies and the residual CDF on the
    gathered rows with one device's arithmetic, and counts cross ranks as
    integers; the file's exact proposal puts every K w at 1, where a
    distributed logsumexp's last bit moved 23 of 32 first-step slots),
    log-Z within 1e-5 relative (the engine's log-Z terms cross the
    particle group); against the JAX mesh call on its replayed draws
    (the OT cases' LGSSM, see RES_JAX), ancestors exactly and log-Z
    within 1e-5 relative."""

    @pytest.mark.parametrize("dp,pp", MESHES)
    def test_infer_equals_single_device(self, world, dp, pp):
        results = world[("residual", dp, pp)]
        want = inference.infer(
            "smc", torch.tensor(OBS), *_single_lgssm(), K, noise=_seeded(),
            resampling_method="residual",
            return_log_marginal_likelihood=True,
            return_ancestral_indices=True)
        layout = dict(row_dim=1, particle_dim=2)
        np.testing.assert_array_equal(
            torch_dist.assemble([r["ancestral_indices"] for r in results],
                                dp, pp, **layout),
            want["ancestral_indices"].numpy())
        np.testing.assert_array_equal(
            torch_dist.assemble([r["latents"] for r in results], dp, pp,
                                **layout), want["latents"].detach().numpy())
        np.testing.assert_allclose(
            _rows(results, "log_marginal_likelihood", dp, pp),
            want["log_marginal_likelihood"].detach().numpy(), rtol=1e-5)

    @pytest.mark.parametrize("dp,pp", MESHES)
    def test_stream_equals_single_device(self, world, dp, pp):
        results = world[("residual_online", dp, pp)]
        init_fn, step_fn = online.make_online_filter(
            *_single_lgssm(), K, resampling_method="residual",
            return_ancestors=True)
        noise, obs = _seeded(), torch.tensor(OBS)
        fs = init_fn(obs[0], noise)
        preds, ancestors = [], []
        for t in range(1, T):
            fs, info = step_fn(fs, obs[t], noise)
            preds.append(info["log_pred"].detach().numpy())
            ancestors.append(info["ancestral_index"].numpy())
        np.testing.assert_array_equal(
            torch_dist.assemble([r["ancestral_indices"] for r in results],
                                dp, pp, row_dim=1, particle_dim=2),
            np.stack(ancestors))
        # log_pred is a difference of two log-Z values: 1e-5 of those.
        np.testing.assert_allclose(_rows(results, "log_pred", dp, pp, 1),
                                   np.stack(preds), rtol=0, atol=1e-4)
        np.testing.assert_allclose(
            _rows(results, "log_marginal_likelihood", dp, pp),
            online.log_marginal_likelihood(fs).detach().numpy(), rtol=1e-5)

    @pytest.mark.parametrize("dp,pp", MESHES)
    def test_exchange_equals_single_device_through_the_kernels(
            self, world, dp, pp):
        # The direct call, with 'auto' routed to the kernels' wrappers: K4
        # searches the residual draws and, with no value, the slots; K3
        # gathers the float32 leaf with K2 as its backward; K5 moves the
        # int32 leaf. The indices are one device's exactly.
        results = world[("residual_direct", dp, pp)]
        want = resampling.residual_indices(torch.tensor(RES_LW),
                                           _seeded()).numpy()
        idx = torch_dist.assemble([r["idx"] for r in results], dp, pp)
        np.testing.assert_array_equal(idx, want)
        np.testing.assert_array_equal(
            torch_dist.assemble([r["indices_only"] for r in results], dp,
                                pp), want)
        for k, v in RES_VALUE.items():
            np.testing.assert_array_equal(
                torch_dist.assemble([r[k] for r in results], dp, pp),
                np.take_along_axis(v, want, axis=1))
        # d sum(x[idx]^2) / dx_i = 2 x_i times its count.
        counts = np.stack([np.bincount(row, minlength=K) for row in want])
        np.testing.assert_allclose(
            torch_dist.assemble([r["grad_x"] for r in results], dp, pp),
            2.0 * counts * RES_VALUE["x"], rtol=1e-6)
        shape = (B // dp, K // pp)
        for r in results:
            assert r["calls"] == {
                "searchsorted_sorted": [shape] * 3,
                "resample_and_gather_sorted": [shape],
                "range_sum": [shape],
                "gather_sorted": [shape]}, r["calls"]

    @pytest.mark.parametrize("dp,pp", MESHES)
    def test_aesmc_gradients_equal_single_device(self, world, dp, pp):
        results = world[("residual_loss", dp, pp)]
        loss, grads = _single_grads("aesmc", _seeded(),
                                    resampling_method="residual")
        for r in results:
            np.testing.assert_allclose(r["loss"], loss, rtol=1e-5)
        _assert_grads(_mean_grads(results), grads, rtol=1e-5)

    def test_matches_jax_mesh(self, world):
        results = world["residual_jax"]
        np.testing.assert_array_equal(
            torch_dist.assemble([r["ancestral_indices"] for r in results],
                                2, 2, row_dim=1, particle_dim=2),
            np.asarray(RES_JAX["ancestral_indices"]))
        np.testing.assert_allclose(
            _rows(results, "log_marginal_likelihood", 2, 2),
            np.asarray(RES_JAX["log_marginal_likelihood"]), rtol=1e-5)


@pytest.fixture(scope="module")
def jax_lowrank():
    """The JAX low-rank transport of the OT cases' cloud (one device; its
    mesh form is `infer`'s) and the gradients of sum(x^2) + sum(y)."""
    value = {k: jnp.asarray(v) for k, v in OT_VALUE.items()}

    def loss(lw_, vx):
        out = jax_ot_module.lowrank_ot_resample(
            lw_, {**value, "x": vx}, rank=LR_RANK,
            num_iterations=LR_ITERS, key=LR_KEY)[0]
        return jnp.sum(out["x"] ** 2) + jnp.sum(out["y"]), out

    (_, got), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(jnp.asarray(OT_LW), value["x"])
    return got, dict(zip(("grad_lw", "grad_x"), grads))


class TestLowRankOT:
    """The low-rank transport on a particle group: within 1e-4 of the
    single-device port call (same jitter) and of the JAX call (its
    jitter replayed), gradients within atol 2e-4 / rtol 1e-3 (the 'ot'
    cases' bars); in `infer` and the stream within 1e-4 of one device,
    and of the JAX mesh `infer` on its replayed draws."""

    @pytest.mark.parametrize("dp,pp", MESHES)
    def test_matches_jax_and_single_device(self, world, jax_lowrank, dp,
                                           pp):
        results = world[("lowrank", dp, pp)]
        got_jax, jax_grads = jax_lowrank
        lw = torch.tensor(OT_LW).requires_grad_(True)
        value = {k: torch.tensor(v) for k, v in OT_VALUE.items()}
        value["x"].requires_grad_(True)
        single, _ = ot.lowrank_ot_resample(
            lw, value, rank=LR_RANK, num_iterations=LR_ITERS,
            noise=torch_dist.ListNoise(**LR_DIRECT_DRAWS))
        ((single["x"] ** 2).sum() + single["y"].sum()).backward()
        for k in OT_VALUE:
            got = torch_dist.assemble([r["value"][k] for r in results],
                                      dp, pp)
            np.testing.assert_allclose(got, single[k].detach().numpy(),
                                       atol=1e-4, rtol=1e-4)
            np.testing.assert_allclose(got, np.asarray(got_jax[k]),
                                       atol=1e-4, rtol=1e-4)
        assert not any(r["new_log_weight"].any() for r in results)
        for name, want in (("grad_lw", lw.grad), ("grad_x", value["x"].grad)):
            got = torch_dist.assemble([r[name] for r in results], dp, pp)
            np.testing.assert_allclose(got, want.numpy(), atol=2e-4,
                                       rtol=1e-3, err_msg=name)
            np.testing.assert_allclose(got, np.asarray(jax_grads[name]),
                                       atol=2e-4, rtol=1e-3, err_msg=name)

    @pytest.mark.parametrize("dp,pp", MESHES)
    def test_engine_equals_single_device(self, world, dp, pp):
        results = world[("lowrank_infer", dp, pp)]
        want = inference.infer(
            "smc", torch.tensor(OT_OBS), *_single_lgssm(OT_PARAMS), K,
            noise=_seeded(), resampling_method="ot", ot_rank=LR_RANK,
            ot_num_iterations=LR_ITERS, return_log_marginal_likelihood=True,
            return_latents=False)
        np.testing.assert_allclose(
            _rows(results, "log_marginal_likelihood", dp, pp),
            want["log_marginal_likelihood"].detach().numpy(), atol=1e-4)
        np.testing.assert_allclose(
            torch_dist.assemble([r["last_latent"] for r in results], dp,
                                pp), want["last_latent"].detach().numpy(),
            atol=1e-4)

    def test_stream_equals_single_device(self, world):
        init_fn, step_fn = online.make_online_filter(
            *_single_lgssm(OT_PARAMS), K, resampling_method="ot",
            ot_rank=LR_RANK, ot_num_iterations=LR_ITERS)
        noise, obs = _seeded(), torch.tensor(OT_OBS)
        fs = init_fn(obs[0], noise)
        preds = []
        for t in range(1, OT_OBS.shape[0]):
            fs, info = step_fn(fs, obs[t], noise)
            preds.append(info["log_pred"].detach().numpy())
        np.testing.assert_allclose(world["lowrank_online"][0]["log_pred"],
                                   np.stack(preds), atol=1e-4)

    def test_engine_matches_jax_mesh(self, world, jax_mesh):
        want = jax.jit(lambda o: jax_inference.infer(
            "smc", o, *_OT_JAX, K, key=OT_KEY, resampling_method="ot",
            ot_rank=LR_RANK, ot_num_iterations=LR_ITERS, mesh=jax_mesh,
            return_log_marginal_likelihood=True, return_latents=False,
            return_log_weight=False))(jnp.asarray(OT_OBS))
        np.testing.assert_allclose(
            _rows(world["lowrank_infer_jax"], "log_marginal_likelihood", 2,
                  2), np.asarray(want["log_marginal_likelihood"]), atol=1e-4)


class TestTMC:
    """TMC on a mesh: the loss within 1e-5 relative of the single-device
    port's, and the mean of the ranks' gradients within 1e-5 relative of
    its gradient plus 1e-6 absolute (the proposal's bias gradient is
    ~0.009 here, the largest entries ~10); the loss within 1e-5 relative
    of JAX `get_loss('tmc', mesh=)` on the replayed draws; parameters
    after 2 sharded Adam steps within 1e-5 relative of
    `train.make_train_step`'s."""

    @pytest.mark.parametrize("dp,pp", MESHES)
    def test_loss_and_gradients_equal_single_device(self, world, dp, pp):
        results = world[("tmc", dp, pp)]
        loss, grads = _single_grads("tmc", _seeded())
        for r in results:
            np.testing.assert_allclose(r["loss"], loss, rtol=1e-5)
        _assert_grads(_mean_grads(results), grads, rtol=1e-5, atol=1e-6)

    @pytest.mark.parametrize("dp,pp", MESHES)
    def test_sharded_steps_equal_single_device(self, world, dp, pp):
        results = world[("tmc_train", dp, pp)]
        comps = _single_lgssm()
        step = train.make_train_step(K, "tmc", torch.optim.Adam(
            train.get_chained_params(*comps), lr=1e-2))
        for i in range(2):
            loss = float(step(comps, torch.tensor(OBS),
                              NoiseSource.seeded(i, "cpu")))
            for r in results:
                np.testing.assert_allclose(r["losses"][i], loss, rtol=1e-5)
        for r in results:
            for got, want in zip(r["params"],
                                 train.get_chained_params(*comps)):
                np.testing.assert_allclose(got, want.detach().numpy(),
                                           rtol=1e-5, atol=1e-7)

    def test_matches_jax_mesh(self, world, jax_mesh):
        want = jax.jit(lambda o: jax_losses.get_loss(
            o, K, "tmc", *_jax_components(), key=E3_KEY, mesh=jax_mesh))(
                jnp.asarray(OBS))
        for r in world["tmc_jax"]:
            np.testing.assert_allclose(r["loss"], float(want), rtol=1e-5)


class TestScore:
    """The score estimator on a mesh: the loss equal to the single-device
    port's within 1e-6 relative (the per-step logsumexps cross the
    particle group in another order). The mean of the ranks' gradients
    within 1e-5 of each leaf's largest entry of the single-device port's
    plus 10 times that leaf's float32 rounding, measured as the
    single-device gradient's distance from a float64 evaluation of the
    same surrogate on the same engine output: the score term sums K
    per-particle gradients times advantages of several nats, which cancel
    to a gradient far smaller than its terms (here up to 1.8e-4 of a
    leaf, baseline 'none'; on the card's draws in `chip_smoke.py` phase
    37 a leaf of 127 cancelled terms of ~1e4), and the mesh sums them in
    another order.
    Against the JAX mesh call on replayed draws: the loss within 1e-4,
    gradients within rtol 1e-3 / atol 1e-4 (`tests/test_torch_gradients.
    py`'s bars), baselines 'batch' and 'none'."""

    @pytest.mark.parametrize("dp,pp", MESHES)
    @pytest.mark.parametrize("baseline", ["batch", "none"])
    def test_equals_single_device(self, world, dp, pp, baseline):
        results = world[("score", dp, pp, baseline)]
        loss, grads = _single_grads(
            "aesmc", _seeded(), resampling_method="multinomial",
            gradient_estimator="score", score_baseline=baseline)
        for r in results:
            np.testing.assert_allclose(r["loss"], loss, rtol=1e-6)
        comps = _single_lgssm()
        result = inference.infer(
            "smc", torch.tensor(OBS), *comps, K, noise=_seeded(),
            resampling_method="multinomial", return_log_weights=True,
            return_ancestral_indices=True, return_latents=False)
        wide = dict(result, log_weights=result["log_weights"].double())
        gradients.score_surrogate_from_result(wide, baseline).backward()
        rounding = [np.abs(g - w).max() for g, w in
                    zip(grads, torch_dist._grads(comps))]
        for i, (got, want) in enumerate(zip(_mean_grads(results), grads)):
            np.testing.assert_allclose(
                got, want, rtol=0, err_msg=f"{i}",
                atol=1e-5 * np.abs(want).max() + 10 * rounding[i])

    @pytest.mark.parametrize("baseline", ["batch", "none"])
    def test_matches_jax_mesh(self, world, jax_mesh, baseline):
        def loss_fn(trainable):
            return jax_gradients.score_gradient_loss(
                jnp.asarray(OBS), K, _jax_components()[0], *trainable,
                key=E3_KEY, baseline=baseline, mesh=jax_mesh)

        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
            tuple(_jax_components()[1:]))
        results = world[("score_jax", baseline)]
        for r in results:
            np.testing.assert_allclose(r["loss"], float(loss), atol=1e-4)
        # The port's chained parameters, in order: the transition's and
        # the emission's mult, then the proposal's four fields.
        leaves = ((0, "mult"), (1, "mult"), (2, "lin_0_weight"),
                  (2, "lin_0_bias"), (2, "lin_t_weight"), (2, "lin_t_bias"))
        for (i, name), got in zip(leaves, _mean_grads(results)):
            np.testing.assert_allclose(got, np.asarray(getattr(grads[i],
                                                               name)),
                                       rtol=1e-3, atol=1e-4,
                                       err_msg=f"{i}.{name}")
