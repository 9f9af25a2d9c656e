"""The sharded posterior of the port on four gloo ranks on the CPU
(float64), second part: priors, time-sharded gain parameters,
minibatches, structured covariances, main-param sub-slices, the coupling
chain, what the port refuses, and the counterparts of
__graft_entry__.dryrun_multichip's production and pixel stages; each
against the JAX package on the 8-device CPU mesh and the single-process
port at the JAX bars (tests/_torch_dist.py). Also the JAX package's
WedgeFilter chain under baseline sharding (ROADMAP queue C item 9).
"""
import numpy as np
import pytest

import _torch_dist as D

WORLD = 4
EVAL = ["prior", "prior_out", "batch2", "cov_freq", "cov_time", "main_like",
        "main_post", "coupling"]
NAMES = EVAL + ["gains_t", "refusals", "prod_time", "prod_bl", "pixels"]


def jax_production(kind):
    import __graft_entry__ as ge
    kw = dict(Ntimes_per_batch=4) if kind == "time" else \
        dict(Ntimes_per_batch=2, bl_axis_n=2)
    spec = D.PRODUCTION[kind]
    return D.jax_sharded(None, ge._build_production(Nbatch=2, **kw), spec)


def jax_pixels():
    from bayeslim_tpu.inference import LogProb
    from bayeslim_tpu.parallel import make_mesh, shard_pixels
    prob, pd = D.pixel_prob(D.JaxPkg())
    sp = LogProb(shard_pixels(prob.model, make_mesh({"model": 4}),
                              pix_axis="model"), prob.target)
    v, g = sp.value_and_grad(pd)
    return float(v), {k: np.asarray(x) for k, x in g.items()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    run = D.start_ranks(WORLD, NAMES, tmp_path_factory.mktemp("ranks"))
    refs = {n: (D.jax_sharded(n), D.torch_single(n))
            for n in EVAL + ["gains_t"]}
    for kind in ("time", "bl"):
        refs["prod_" + kind] = (jax_production(kind), D.torch_single(
            None, D.production(kind)[0]))
    prob, pd = D.pixel_prob(D.TorchPkg())
    v, g = prob.value_and_grad(pd)
    refs["pixels"] = (jax_pixels(), (float(v), D.np_tree(g)))
    return D.join_ranks(run), refs


@pytest.mark.parametrize("name", EVAL + ["prod_time", "prod_bl"])
def test_sharded_matches_jax_and_single_process(ranks, name):
    results, refs = ranks
    D.assert_same_bits(results, name)
    jax_ref, single = refs[name]
    D.assert_close(results[0][name], single)
    D.assert_close(results[0][name], jax_ref, conj=True)


def test_time_sharded_gain_parameters(ranks):
    """Per-time gains cut over 'data' (param_shardings): every rank
    holds and returns its slice; gathered in rank order the slices are
    the single-process and the JAX gradients."""
    results, refs = ranks
    key = "models.cal.params"
    v0 = results[0]["gains_t"][0]
    assert all(r["gains_t"][0] == v0 for r in results)
    slices = [r["gains_t"][1][key] for r in results]
    assert all(s.shape[3] == 2 for s in slices)
    g = dict(results[0]["gains_t"][1], **{key: np.concatenate(slices, 3)})
    jax_ref, single = refs["gains_t"]
    D.assert_close((v0, g), single)
    D.assert_close((v0, g), jax_ref, conj=True)


def test_pixel_sharded_stage(ranks):
    """shard_pixels over {'model': 4} (each rank reduces a quarter of
    the padded FOV cut): the single-process loss and whole gradient on
    every rank."""
    results, refs = ranks
    v, g, (ncut, local) = results[0]["pixels"]
    assert local == ncut // 4
    for r in results[1:]:
        assert r["pixels"][0] == v
        for k in g:
            np.testing.assert_array_equal(r["pixels"][1][k], g[k])
    jax_ref, single = refs["pixels"]
    D.assert_close((v, g), single)
    D.assert_close((v, g), jax_ref)


@pytest.mark.parametrize("key,words", [
    ("cov_time_under_time", "couples an axis"),
    ("cov_bl_under_bl", "couples an axis"),
    ("wedge_under_bl", "WedgeFilter"),
    ("set_bls_mismatch", "do not match"),
    ("indivisible_expansion", "divisible"),
    ("host_metadata_block", "host metadata"),
    ("param_shardings_fwd_priors", "prior_dict"),
])
def test_refusals(ranks, key, words):
    """What cannot be sharded fails loudly, on every rank alike: a
    covariance coupling a sharded axis, a host-indexed block (the
    WedgeFilter) or a set_bls block pinned in another order under
    baseline sharding, an expansion whose counts do not divide,
    module-attached priors on a cut parameter."""
    results, _ = ranks
    msg = results[0]["refusals"][key]
    assert msg is not None and words in msg, msg
    assert all(r["refusals"][key] == msg for r in results)


def test_auto_pin_leaves_the_callers_chain(ranks):
    results, _ = ranks
    assert all(r["refusals"]["auto_pin_nondestructive"] for r in results)


def test_queue_c9_jax_wedge_filter_under_baseline_sharding():
    """ROADMAP queue C item 9, shown, not pinned: the JAX package's
    WedgeFilter looks its baselines up in the VisData it is given, and
    the JAX ShardedLogProb's guard checks only blocks exposing set_bls,
    so a WedgeFilter chain passes under baseline sharding. Its loss and
    gradients are printed against the single-device ones; the port
    refuses the chain there (test_refusals) and carries it under time
    sharding (tests/test_torch_parallel_opt.py)."""
    from bayeslim_tpu.parallel import ShardedLogProb, make_mesh
    prob, spec = D.build(D.JaxPkg(), "wedge_bl")
    pd = prob.collect_main_params()
    v0, g0 = prob.value_and_grad(pd)
    sp = ShardedLogProb(prob, make_mesh(spec["mesh"]), bl_axis="model")
    try:
        v1, g1 = sp.smap_value_and_grad(pd)
    except Exception as e:         # the difference may be an error
        print(f"C9: the JAX bl-sharded WedgeFilter chain raises "
              f"{type(e).__name__}: {e}")
        return
    rel = {k: float(np.abs(np.asarray(g1[k]) - np.asarray(g0[k])).max()
                    / np.abs(np.asarray(g0[k])).max()) for k in g0}
    print(f"C9: loss single {float(v0)!r} bl-sharded {float(v1)!r}; "
          f"gradient differences / max |g|: {rel}")
