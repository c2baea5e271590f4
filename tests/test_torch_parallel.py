"""The port's mesh layer: `make_mesh`, `infer`/`get_loss`/the streaming
filter with ``mesh=``, the sharded train step, and the port's form of
`__graft_entry__.dryrun_multichip`.

The port runs on one 8-rank gloo world on the CPU (`torch_dist`; every
case of the file in one spawn). Against the port on one device (same
seed, the draws of the single-device run, which a mesh run replays
through `noise.ShardNoise`): ancestors and lineages exact, log-Z within
1e-6 relative, gradients of the sharded step within 1e-5 relative of
`train.make_train_step`'s. Against the JAX package (`tests/
test_parallel.py`): `infer` with the JAX draws replayed (keys split as
`aesmc_tpu.inference.infer` splits them), the JAX mesh `infer` and the
JAX sharded train step's loss.
"""

import jax
import numpy as np
import optax
import pytest
import torch

import torch_dist
import torch_threads  # noqa: F401
from aesmc_tpu import inference as jax_inference
from aesmc_tpu import parallel as jax_parallel
from aesmc_tpu.models import lgssm as jax_lgssm
from aesmc_tpu_torch import inference, online, parallel, train
from aesmc_tpu_torch.noise import NoiseSource
from torch_replay import lgssm_params, normal_draw, resampling_draws

KEY = jax.random.PRNGKey(3)
T, B, K = 6, 4, 32
MESHES = [(2, 4), (1, 8)]


def _jax_components(transition_mult=0.9):
    return (jax_lgssm.Initial(0.0, 1.0),
            jax_lgssm.Transition.create(transition_mult, 1.0),
            jax_lgssm.Emission.create(1.0, 0.2),
            jax_lgssm.Proposal.create(1.0, 1.0, KEY))


PARAMS = lgssm_params(_jax_components())
TRAIN_PARAMS = lgssm_params(_jax_components(0.0))
OBS = np.asarray(np.random.RandomState(0).randn(T, B), np.float32)


def _draws(key, method):
    """The draws of `aesmc_tpu.inference.infer` from ``key``, as
    `torch_dist.ListNoise` kinds: the proposal's eps a step
    (``split(key, (T, 2))[t, 1]``) and the resampling noise."""
    step_keys = jax.random.split(key, (T, 2))
    normals = [normal_draw(step_keys[0, 1], (K,), (B,), batch_expanded=True)]
    normals += [normal_draw(step_keys[t, 1], (), (B, K))
                for t in range(1, T)]
    resampling = resampling_draws(key, T, B, K, method)
    draws = {"normal": normals}
    for kind, values in resampling.items():
        draws[kind[:-1]] = values
    return draws


CASES = {("mesh", 2, 4): ("mesh_info", dict(dp=2, pp=4)),
         "errors": ("mesh_errors", dict(dp=2, pp=4, obs=OBS,
                                        params=PARAMS))}
for _dp, _pp in MESHES:
    for _exchange, _method, _criterion in (
            (None, "systematic", "always"), ("allgather", "systematic",
                                             "always"),
            ("ring", "systematic", "always"), (None, "plain", "always"),
            (None, "multinomial", 0.5), (None, "soft", "always")):
        CASES[("infer", _dp, _pp, _exchange, _method, _criterion)] = (
            "infer_case", dict(dp=_dp, pp=_pp, obs=OBS, params=PARAMS,
                               num_particles=K, exchange=_exchange,
                               method=_method, criterion=_criterion,
                               return_latents=_method != "soft"))
    for _apf, _window, _remat in ((True, 1, False), (False, 2, True)):
        CASES[("engine", _dp, _pp, _apf, _window, _remat)] = (
            "infer_case", dict(dp=_dp, pp=_pp, obs=OBS, params=PARAMS,
                               num_particles=K, apf=_apf, window=_window,
                               remat=_remat, return_latents=True))
    for _method in ("systematic", "stratified"):
        CASES[("hmm", _dp, _pp, _method)] = ("hmm_case", dict(
            dp=_dp, pp=_pp, obs=OBS, method=_method))
    CASES[("is", _dp, _pp)] = ("infer_case", dict(
        dp=_dp, pp=_pp, obs=OBS, params=PARAMS, num_particles=K,
        algorithm="is", return_latents=True))
    CASES[("jax_draws", _dp, _pp)] = ("infer_case", dict(
        dp=_dp, pp=_pp, obs=OBS, params=PARAMS, num_particles=K,
        draws=_draws(KEY, "systematic")))
    for _method, _exchange, _explicit in (
            ("systematic", None, False), ("systematic", None, True),
            ("systematic", "ring", False), ("soft", "allgather", False),
            ("soft", "ring", False)):
        CASES[("train", _dp, _pp, _method, _exchange, _explicit)] = (
            "train_case", dict(dp=_dp, pp=_pp, obs=OBS,
                               params=TRAIN_PARAMS, num_particles=K,
                               steps=3, method=_method, exchange=_exchange,
                               explicit=_explicit))
    for _method, _exchange, _lag, _criterion in (
            ("systematic", None, 2, "always"),
            ("systematic", "ring", 0, 0.5), ("soft", None, 0, "always")):
        CASES[("online", _dp, _pp, _method, _exchange)] = (
            "online_case", dict(dp=_dp, pp=_pp, obs=OBS, params=PARAMS,
                                num_particles=K, method=_method,
                                exchange=_exchange, fixed_lag=_lag,
                                criterion=_criterion))
def _train_jax_draws():
    """The JAX sharded step's draws at K = 16 from ``KEY`` (its `infer`'s
    keys): the proposal's eps a step, then the systematic uniforms."""
    step_keys = jax.random.split(KEY, (T, 2))
    return {"normal": [normal_draw(step_keys[0, 1], (16,), (B,),
                                   batch_expanded=True)] +
            [normal_draw(step_keys[t, 1], (), (B, 16))
             for t in range(1, T)],
            "uniform": resampling_draws(KEY, T, B, 16,
                                        "systematic")["uniforms"]}


CASES["train_jax"] = ("train_case", dict(
    dp=2, pp=4, obs=OBS, params=TRAIN_PARAMS, num_particles=16,
    draws=_train_jax_draws()))
CASES["dryrun"] = ("dryrun", {})


@pytest.fixture(scope="module")
def world():
    names = list(CASES)
    results = torch_dist.run_world(8, [CASES[n] for n in names])
    return dict(zip(names, results))


def _rows(results, key, dp, pp):
    """A per-row output (the same on every particle rank), all rows."""
    return np.concatenate([results[d * pp][key] for d in range(dp)])


def _components(params=PARAMS):
    return torch_dist.lgssm_components(params)


class TestMakeMesh:
    def test_shape(self, world):
        info = world[("mesh", 2, 4)]
        assert info[0]["shape"] == (2, 4)
        assert info[0]["names"] == ("data", "particle")
        assert [r["coords"] for r in info] == [(d, p) for d in range(2)
                                               for p in range(4)]

    def test_too_many_ranks_raises(self, world):
        message = world[("mesh", 2, 4)][0]["too_many"]
        assert message is not None and "256 ranks" in message

    def test_no_card_and_no_cpu_request_raises(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(RuntimeError, match="CUDA"):
            parallel.make_mesh(1, 1)

    def test_bad_device_type_raises(self):
        with pytest.raises(ValueError, match="device_type"):
            parallel.make_mesh(1, 1, device_type="tpu")

    def test_data_particle_specs_and_shard_batch_are_blocks(self, world):
        info = world[("mesh", 2, 4)]
        for rank, r in enumerate(info):
            d, p = divmod(rank, 4)
            assert r["specs"] == ((4 * d, 4 * d + 4), (8 * p, 8 * p + 8))
            np.testing.assert_array_equal(
                r["shard"], np.arange(16.0).reshape(2, 8)[:, 4 * d:4 * d + 4])
            assert r["round_trip"]


class TestInferMesh:
    @pytest.mark.parametrize("dp,pp", MESHES)
    @pytest.mark.parametrize("exchange,method,criterion", [
        (None, "systematic", "always"), ("allgather", "systematic", "always"),
        ("ring", "systematic", "always"), (None, "plain", "always"),
        (None, "multinomial", 0.5), (None, "soft", "always")])
    def test_equals_single_device(self, world, dp, pp, exchange, method,
                                  criterion):
        results = world[("infer", dp, pp, exchange, method, criterion)]
        resampling_method = "systematic" if method == "plain" else method
        latents = method != "soft"
        want = inference.infer(
            "smc", torch.tensor(OBS), *_components(), K,
            noise=NoiseSource.seeded(0, "cpu"),
            resampling_method=resampling_method,
            resampling_criterion=criterion,
            return_log_marginal_likelihood=True, return_latents=latents,
            return_ancestral_indices=True)
        np.testing.assert_array_equal(
            torch_dist.assemble([r["ancestral_indices"] for r in results],
                                dp, pp, 1, 2),
            want["ancestral_indices"].numpy())
        np.testing.assert_allclose(
            _rows(results, "log_marginal_likelihood", dp, pp),
            want["log_marginal_likelihood"].detach().numpy(), rtol=1e-6)
        if latents:
            np.testing.assert_array_equal(
                torch_dist.assemble([r["latents"] for r in results], dp, pp,
                                    1, 2),
                want["latents"].detach().numpy())

    @pytest.mark.parametrize("dp,pp", MESHES)
    @pytest.mark.parametrize("apf,window,remat", [(True, 1, False),
                                                  (False, 2, True)])
    def test_engine_options_equal_single_device(self, world, dp, pp, apf,
                                                window, remat):
        # The auxiliary PF (its scores ride the exchange as one more
        # column) and a history window of 2 regathered across ranks,
        # rematerialized.
        results = world[("engine", dp, pp, apf, window, remat)]
        want = inference.infer(
            "smc", torch.tensor(OBS), *_components(), K,
            noise=NoiseSource.seeded(0, "cpu"),
            lookahead=torch_dist.apf_lookahead() if apf else None,
            history_window=window, remat=remat,
            return_log_marginal_likelihood=True, return_latents=True,
            return_ancestral_indices=True)
        np.testing.assert_array_equal(
            torch_dist.assemble([r["ancestral_indices"] for r in results],
                                dp, pp, 1, 2),
            want["ancestral_indices"].numpy())
        np.testing.assert_allclose(
            _rows(results, "log_marginal_likelihood", dp, pp),
            want["log_marginal_likelihood"].detach().numpy(), rtol=1e-6)
        np.testing.assert_array_equal(
            torch_dist.assemble([r["latents"] for r in results], dp, pp,
                                1, 2), want["latents"].detach().numpy())

    @pytest.mark.parametrize("dp,pp", MESHES)
    @pytest.mark.parametrize("method", ["systematic", "stratified"])
    def test_int32_particles_equal_single_device(self, world, dp, pp,
                                                 method):
        # The HMM: its int32 particles are gathered apart from the CDF
        # (K5 on the card), its t = 0 draws particle-major.
        from aesmc_tpu_torch.models import hmm
        results = world[("hmm", dp, pp, method)]
        comps = hmm.make_model(num_states=3, emission_scale=0.6,
                               stay_prob=0.85, device="cpu")
        want = inference.infer(
            "smc", torch.tensor(OBS), *comps, K,
            noise=NoiseSource.seeded(0, "cpu"), resampling_method=method,
            return_log_marginal_likelihood=True, return_latents=True,
            return_ancestral_indices=True)
        np.testing.assert_array_equal(
            torch_dist.assemble([r["ancestral_indices"] for r in results],
                                dp, pp, 1, 2),
            want["ancestral_indices"].numpy())
        latents = torch_dist.assemble([r["latents"] for r in results], dp,
                                      pp, 1, 2)
        assert latents.dtype == np.int32
        np.testing.assert_array_equal(latents, want["latents"].numpy())
        np.testing.assert_allclose(
            _rows(results, "log_marginal_likelihood", dp, pp),
            want["log_marginal_likelihood"].detach().numpy(), rtol=1e-6)

    @pytest.mark.parametrize("dp,pp", MESHES)
    def test_importance_sampling(self, world, dp, pp):
        results = world[("is", dp, pp)]
        want = inference.infer(
            "is", torch.tensor(OBS), *_components(), K,
            noise=NoiseSource.seeded(0, "cpu"),
            return_log_marginal_likelihood=True)
        np.testing.assert_allclose(
            _rows(results, "log_marginal_likelihood", dp, pp),
            want["log_marginal_likelihood"].detach().numpy(), rtol=1e-6)
        np.testing.assert_array_equal(
            torch_dist.assemble([r["latents"] for r in results], dp, pp,
                                1, 2), want["latents"].detach().numpy())

    @pytest.mark.parametrize("dp,pp", MESHES)
    def test_matches_jax_mesh_infer(self, world, dp, pp):
        results = world[("jax_draws", dp, pp)]
        mesh = jax_parallel.make_mesh(data=dp, particle=pp)
        want = jax.jit(lambda o, k: jax_inference.infer(
            "smc", o, *_jax_components(), K, key=k, mesh=mesh,
            return_log_marginal_likelihood=True, return_latents=False,
            return_ancestral_indices=True))(OBS, KEY)
        np.testing.assert_array_equal(
            torch_dist.assemble([r["ancestral_indices"] for r in results],
                                dp, pp, 1, 2),
            np.asarray(want["ancestral_indices"]))
        np.testing.assert_allclose(
            _rows(results, "log_marginal_likelihood", dp, pp),
            np.asarray(want["log_marginal_likelihood"]), rtol=1e-5)


class TestShardedTrainStep:
    @pytest.mark.parametrize("dp,pp", MESHES)
    @pytest.mark.parametrize("method,exchange,explicit", [
        ("systematic", None, False), ("systematic", None, True),
        ("systematic", "ring", False), ("soft", "allgather", False),
        ("soft", "ring", False)])
    def test_equals_single_device_step(self, world, dp, pp, method,
                                       exchange, explicit):
        results = world[("train", dp, pp, method, exchange, explicit)]
        comps = _components(TRAIN_PARAMS)
        params = train.get_chained_params(*comps)
        optimizer = torch.optim.Adam(params, lr=1e-2)
        step = train.make_train_step(K, "aesmc", optimizer,
                                     resampling_method=method)
        losses = [float(step(comps, torch.tensor(OBS),
                             NoiseSource.seeded(i, "cpu")))
                  for i in range(3)]
        np.testing.assert_allclose(results[0]["losses"], losses, rtol=1e-5)
        for got, p in zip(results[0]["grads"], params):
            np.testing.assert_allclose(got, p.grad.numpy(), rtol=1e-5,
                                       atol=1e-5 * float(p.grad.abs().max()))
        for got, p in zip(results[0]["params"], params):
            np.testing.assert_allclose(got, p.detach().numpy(), rtol=1e-5)
        for r in results[1:]:
            for a, b in zip(r["params"], results[0]["params"]):
                np.testing.assert_array_equal(a, b)

    @pytest.mark.parametrize("dp,pp", MESHES)
    def test_explicit_resampler_matches_default_route(self, world, dp, pp):
        default = world[("train", dp, pp, "systematic", None, False)]
        explicit = world[("train", dp, pp, "systematic", None, True)]
        np.testing.assert_allclose(explicit[0]["losses"],
                                   default[0]["losses"], rtol=1e-5)

    def test_loss_matches_jax_sharded_step(self, world):
        # The JAX sharded step's loss at its first step, against the port's
        # with the JAX draws replayed (the module world's "train_jax").
        comps = _jax_components(0.0)
        mesh = jax_parallel.make_mesh(data=2, particle=4)
        opt = optax.adam(1e-2)
        step = jax_parallel.make_sharded_train_step(16, "aesmc", opt, mesh)
        _, _, loss = step(comps, opt.init(comps),
                          jax_parallel.shard_batch(OBS, mesh), KEY)
        results = world["train_jax"]
        np.testing.assert_allclose(results[0]["losses"][0], float(loss),
                                   rtol=1e-5)


class TestOnlineMesh:
    @pytest.mark.parametrize("dp,pp", MESHES)
    @pytest.mark.parametrize("method,exchange,lag,criterion", [
        ("systematic", None, 2, "always"), ("systematic", "ring", 0, 0.5),
        ("soft", None, 0, "always")])
    def test_equals_unsharded_filter(self, world, dp, pp, method, exchange,
                                     lag, criterion):
        results = world[("online", dp, pp, method, exchange)]
        init_fn, step_fn = online.make_online_filter(
            *_components(), K, resampling_method=method,
            resampling_criterion=criterion, return_ancestors=True,
            fixed_lag=lag)
        noise = NoiseSource.seeded(0, "cpu")
        obs = torch.tensor(OBS)
        fs = init_fn(obs[0], noise)
        for t in range(1, T):
            fs, info = step_fn(fs, obs[t], noise)
            infos = [r["infos"][t - 1] for r in results]
            np.testing.assert_array_equal(
                torch_dist.assemble([i["ancestral_index"] for i in infos],
                                    dp, pp),
                info["ancestral_index"].numpy())
            # log_pred is a difference of two log-Z values of up to ~70:
            # 1e-6 of those, not of the difference.
            np.testing.assert_allclose(
                np.concatenate([infos[d * pp]["log_pred"]
                                for d in range(dp)]),
                info["log_pred"].detach().numpy(), rtol=0, atol=1e-4)
            if lag:
                np.testing.assert_array_equal(
                    torch_dist.assemble([i["lagged_latent"] for i in infos],
                                        dp, pp),
                    info["lagged_latent"].detach().numpy())
        np.testing.assert_allclose(
            _rows(results, "log_z", dp, pp),
            online.log_marginal_likelihood(fs).detach().numpy(), rtol=1e-6)
        np.testing.assert_allclose(
            _rows(results, "ess", dp, pp),
            online.effective_sample_size(fs).detach().numpy(), rtol=1e-5)


class TestErrors:
    # kind None: the call runs on a mesh ('ot', streaming PaRIS and
    # genealogy since the slice that ported them; the low-rank OT,
    # residual resampling and TMC since the one that closed those
    # refusals; their results are held in
    # tests/test_torch_mesh_algorithms.py).
    @pytest.mark.parametrize("name,kind,match", [
        ("ot", None, None),
        ("ot_rank", None, None),
        ("residual", None, None),
        ("no_mesh", "ValueError", "mesh="),
        ("paris", None, None),
        ("genealogy", None, None),
        ("tmc", None, None),
        ("split", "ValueError", "particle shards")])
    def test_refused_on_a_mesh(self, world, name, kind, match):
        got = world["errors"][0][name]
        if kind is None:
            assert got is None, got
        else:
            assert (got is not None and got[0] == kind and
                    match in got[1]), got


def test_dryrun_multichip(world):
    out = world["dryrun"][0]
    assert np.isfinite(out["step"]) and np.isfinite(out["soft"])
    assert np.isfinite(out["ring"]).all()
    assert np.isfinite(out["islands"]).all()
