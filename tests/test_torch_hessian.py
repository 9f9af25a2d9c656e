"""The port's Hessians (inference/hessian.py), LBFGS.t_hist, the
force_chunked context and the second derivatives of the port's own
autograd Functions, against the JAX package at float64 on the CPU.

Cases: tests/test_hessian.py's eight rebuilt on both sides, the JAX
side of tests/test_reference_parity.py's compute_hessian and
main_params_kron_inv_hess cases, a hex-2 RIME chain's Hessian (antenna
positions and gains, through ops.rime_kernel.force_chunked) against the
JAX package's under force_xla, reverse-over-reverse HVPs through the
chunk and psky checkpoints against the forward-over-reverse rows, and
the named error of a second derivative through the fused Functions.
Inputs come from numpy seeds; the tolerance is 1e-9 relative."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

import bayeslim_tpu as bl
import bayeslim_tpu_torch as bt
from bayeslim_tpu.inference import hessian as jh
from bayeslim_tpu_torch.inference import hessian as th
from bayeslim_tpu_torch.ops import rime_cuda, rime_kernel

from _torch_graft import (build_cal_jax, build_cal_torch, cal_target,
                          cal_truth)

TOL = 1e-9
T64 = dict(device="cpu", dtype=torch.float64)
ANTVECS, GAINS = "models.rime.array.antvecs", "models.cal.params"


def _relerr(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


# ----------------------------------------------- the Gaussian posterior
class _JGauss(bl.utils.Module):
    def __init__(self, n):
        super().__init__(name="gauss")
        self.params = jnp.zeros(n)
        self.set_param("params")

    def forward(self, inp=None, prior_cache=None, **kwargs):
        return self.params


class _TGauss(bt.Module):
    def __init__(self, n):
        super().__init__(name="gauss")
        self.register_buffer("params", torch.zeros(n, dtype=torch.float64))
        self.set_param("params")

    def forward(self, inp=None, prior_cache=None, **kwargs):
        return self.params


def _normal_probs(N, seed=0):
    """tests/test_inference.py's setup_NormalProb in both packages: a
    Gaussian of a known mean and full covariance."""
    rng = np.random.default_rng(seed)
    mean = rng.normal(0, 1, N)
    A = rng.normal(0, 1, (N, N)) / np.sqrt(N)
    cov = A @ A.T + np.eye(N) * 0.5
    icov = np.linalg.inv(cov)
    jt = bl.data.containers.TensorData()
    jt.setup_data(data=jnp.asarray(mean), cov=jnp.asarray(cov),
                  cov_axis="full", icov=jnp.asarray(icov))
    tt = bt.data.TensorData()
    tt.setup_data(data=torch.as_tensor(mean), cov=torch.as_tensor(cov),
                  cov_axis="full", icov=torch.as_tensor(icov))
    jp = bl.inference.LogProb(_JGauss(N), jt, complex_circular=False)
    tp = bt.LogProb(_TGauss(N), tt, complex_circular=False)
    return jp, tp, cov


def test_hessian_matches_icov_vs_jax():
    jp, tp, cov = _normal_probs(12)
    JH, jidx = jh.compute_hessian(jp)
    H, idx = th.compute_hessian(tp)
    assert idx == {"params": slice(0, 12)} == jidx
    assert _relerr(_np(H), np.asarray(JH)) <= TOL
    assert _relerr(_np(H), np.linalg.inv(cov)) <= 1e-9
    H2, _ = th.compute_hessian(tp, rows_chunk=5)
    assert _relerr(_np(H2), _np(H)) <= TOL
    C = th.invert_hessian(H)
    assert _relerr(_np(C), np.asarray(jh.invert_hessian(JH))) <= 1e-8


def test_mask_unmask_vs_jax():
    rng = np.random.default_rng(0)
    H = rng.normal(size=(6, 6)) + np.diag([5., 0, 5, 5, 0, 5])
    jHs, jmask = jh.mask_hessian(jnp.asarray(H), thresh=1.0)
    Hs, mask = th.mask_hessian(torch.as_tensor(H), thresh=1.0)
    assert list(mask) == list(jmask) == [True, False, True, True, False,
                                         True]
    assert np.array_equal(_np(Hs), np.asarray(jHs))
    for kw in (dict(val=2.0), dict(maskleft=True)):
        a = th.unmask_hessian(Hs, mask, **kw)
        b = jh.unmask_hessian(jHs, jmask, **kw)
        assert a.shape == b.shape
        assert np.array_equal(_np(a), np.asarray(b))


@pytest.mark.parametrize("case", ["diag", "idx", "rm_thresh", "pdict",
                                  "eps", "rm_offdiag"])
def test_invert_hessian_options_vs_jax(case):
    rng = np.random.default_rng(1)
    A = rng.normal(size=(5, 5))
    H = A @ A.T + 5 * np.eye(5)
    if case == "diag":
        args, kw = np.asarray([2.0, 0.5, 4.0]), dict(diag=True,
                                                     rm_thresh=1.0,
                                                     rm_fill=9.0)
    elif case == "idx":
        args, kw = H, dict(idx=[0, 2, 4], rm_fill=7.0)
    elif case == "rm_thresh":
        args, kw = np.diag([3.0, 1e-8, 2.0]), dict(rm_thresh=1e-3,
                                                   rm_fill=0.0)
    elif case == "eps":
        args, kw = H, dict(eps=0.3, inv="inv")
    elif case == "rm_offdiag":
        args, kw = H, dict(rm_offdiag=True)
    else:
        a = th.invert_hessian(bt.ParamDict({"a": torch.as_tensor(H)}))
        b = jh.invert_hessian(bl.utils.ParamDict({"a": jnp.asarray(H)}))
        assert _relerr(_np(a["a"]), np.asarray(b["a"])) <= TOL
        return
    a = th.invert_hessian(torch.as_tensor(args), **kw)
    b = jh.invert_hessian(jnp.asarray(args), **kw)
    assert _relerr(_np(a), np.asarray(b)) <= TOL


def _lbfgs_pair(N, steps, history_size=25):
    jp, tp, cov = _normal_probs(N)
    jo = bl.inference.LBFGS(jp, history_size=history_size)
    to = bt.LBFGS(tp, history_size=history_size)
    jo.minimize(steps)
    to.minimize(steps)
    return jo, to, cov


def test_lbfgs_t_hist_vs_jax():
    jo, to, _ = _lbfgs_pair(20, 5)
    assert len(to.t_hist) == len(jo.t_hist) == len(to.s_hist) > 0
    assert _relerr(to.t_hist, jo.t_hist) <= 1e-8


def test_factored_inv_hessian_vs_jax():
    jo, to, cov = _lbfgs_pair(20, 40)
    jf = jh.FactoredInvHessian.from_lbfgs(jo)
    tf = th.FactoredInvHessian.from_lbfgs(to)
    assert len(tf.u) == len(jf.u)
    H = _np(tf.to_dense())
    assert _relerr(H, np.asarray(jf.to_dense())) <= 1e-8
    v = np.random.default_rng(1).normal(size=20)
    assert _relerr(_np(tf.matvec(torch.as_tensor(v))), H @ v) <= 1e-10
    assert _relerr(_np(tf.lvp(torch.as_tensor(v))),
                   np.asarray(jf.lvp(jnp.asarray(v)))) <= 1e-8
    ratio = np.diag(H) / np.diag(cov)
    assert (ratio > 0.3).all() and (ratio < 3.0).all()
    L = _np(tf.chol())
    assert _relerr(L @ L.T, H) <= 1e-10
    # the samplers' cov_L protocol, and a dense H0 / L0 pair
    assert _relerr(_np(tf(torch.as_tensor(v))), L @ v) <= 1e-10
    d = np.linspace(0.5, 2.0, 20)
    tf0 = th.FactoredInvHessian.from_lbfgs(to, H0=torch.as_tensor(d),
                                           L0=torch.as_tensor(np.sqrt(d)))
    jf0 = jh.FactoredInvHessian.from_lbfgs(jo, H0=jnp.asarray(d),
                                           L0=jnp.asarray(np.sqrt(d)))
    assert _relerr(_np(tf0.to_dense()), np.asarray(jf0.to_dense())) <= 1e-8


@pytest.mark.parametrize("rank2", [True, False])
def test_factor_pairs_and_implicit_to_dense_vs_jax(rank2):
    rng = np.random.default_rng(3)
    n = 6
    # a step s = -alpha H g of the inverse Hessian H = I / 2 on a
    # curvature B = I + 0.01 M M^T / n: y = B s, H y
    g = rng.normal(size=n)
    M = rng.normal(size=(n, n))
    s = -0.7 * 0.5 * g
    y = (np.eye(n) + 0.01 * M @ M.T / n) @ s
    Hy = None if rank2 else 0.5 * y
    a = th.factor_pairs(*(torch.as_tensor(x) for x in (s, y, g)), 0.7,
                        None if Hy is None else torch.as_tensor(Hy),
                        rank2=rank2)
    b = jh.factor_pairs(s, y, g, 0.7, Hy, rank2=rank2)
    assert a[2] == b[2]
    for x, z in zip(a[:2], b[:2]):
        assert _relerr(_np(x), np.asarray(z)) <= TOL
    H0 = np.eye(n) * 0.5
    S = [rng.normal(size=n) for _ in range(3)]
    Y = [x + 0.1 * rng.normal(size=n) for x in S]
    assert _relerr(_np(th.implicit_to_dense(H0, s=S, y=Y)),
                   np.asarray(jh.implicit_to_dense(H0, s=S, y=Y))) <= TOL
    M = rng.normal(size=(n, n))
    dense = th.implicit_to_dense(lambda v: torch.as_tensor(M) @ v, n=n)
    assert _relerr(_np(dense), M) <= TOL


def test_grad_mods_vs_jax():
    jp, tp, _ = _normal_probs(6)
    _, g0 = tp.value_and_grad()
    gmax = float(g0["params"].abs().max())
    for mods in ({"params": ("clamp", gmax / 2)}, {"params": ("mult", 0.0)},
                 {"params": ("clip", 1.0)}, None):
        jp.set_grad_mod(mods)
        tp.set_grad_mod(mods)
        _, jg = jp.value_and_grad(jp.collect_main_params())
        _, tg = tp.value_and_grad()
        assert np.allclose(_np(tg["params"]), np.asarray(jg["params"]),
                           rtol=TOL, atol=1e-14)


def test_compute_hessian_row_block_vs_jax():
    jp, tp, _ = _normal_probs(8)
    H, _ = th.compute_hessian(tp)
    Hb, _ = th.compute_hessian(tp, Nstart=2, Nrows=3)
    JHb, _ = jh.compute_hessian(jp, Nstart=2, Nrows=3)
    assert Hb.shape == (3, 8)
    assert _relerr(_np(Hb), np.asarray(JHb)) <= TOL
    assert _relerr(_np(Hb), _np(H)[2:5]) <= TOL
    Hd, _ = th.compute_hessian(tp, rm_offdiag=True, out_ftype=torch.float32)
    assert Hd.dtype == torch.float32
    assert np.allclose(_np(Hd), np.diag(np.diag(_np(H))), atol=1e-4)
    with pytest.raises(NotImplementedError):
        th.compute_hessian(tp, grad_real=False)


def test_compute_hessian_refuses_a_sharded_posterior():
    """A ShardedLogProb is taken (tests/test_torch_parallel_opt.py), but
    not one whose parameters are cut over the ranks (param_shardings):
    its rows would be the local slice's."""
    class ShardedLogProb:
        Nbatch = 1
        param_shardings = {"models.cal.params": (None, None, None, "data")}

        def local_objective(self, pdict=None, idx=None):
            raise AssertionError("not reached")
    with pytest.raises(NotImplementedError, match="param_shardings"):
        th.compute_hessian(ShardedLogProb())


@pytest.mark.parametrize("method", ["chol", "svd"])
def test_main_params_kron_inv_hess_vs_jax(method):
    rng = np.random.default_rng(0)
    A = rng.normal(size=(12, 12))
    H = A @ A.T + 12 * np.eye(12)
    index = {"p": slice(0, 12)}
    a = th.main_params_kron_inv_hess(torch.as_tensor(H), index, "p", (3, 4),
                                     method=method)
    b = jh.main_params_kron_inv_hess(jnp.asarray(H), index, "p", (3, 4),
                                     method=method)
    assert a.shape == b.shape == (12, 3)
    assert _relerr(_np(a), np.asarray(b)) <= 1e-8


def test_kron_inv_hess_reference_parity_case_vs_jax():
    """tests/test_reference_parity.py's kron case (a sub-block, inv)."""
    rng = np.random.default_rng(23)
    B = rng.normal(size=(8, 8))
    hess = B @ B.T + 8 * np.eye(8)
    a = th.main_params_kron_inv_hess(torch.as_tensor(hess),
                                     {"p": slice(1, 7)}, "p", (2, 3),
                                     method="chol", inv="inv")
    b = jh.main_params_kron_inv_hess(jnp.asarray(hess), {"p": slice(1, 7)},
                                     "p", (2, 3), method="chol", inv="inv")
    assert _relerr(_np(a), np.asarray(b)) <= TOL


def test_quadratic_prob_reference_parity_case_vs_jax():
    """tests/test_reference_parity.py's compute_hessian case: an object
    with collect_main_params and forward only."""
    N = 12
    rng = np.random.default_rng(3)
    a = rng.normal(size=(N, 2 * N))
    icov = np.linalg.inv(a @ a.T / (2 * N))
    x0 = np.random.default_rng(0).normal(size=N) * 0.1

    def quad(pkg, arr):
        class QuadProb:
            Nbatch = 1

            def __init__(self):
                self.pd = pkg.ParamDict({"params": arr(x0)})

            def collect_main_params(self):
                return self.pd.copy()

            def forward(self, pdict=None, idx=None, **k):
                xv = (pdict if pdict is not None else self.pd)["params"]
                return 0.5 * xv @ arr(icov) @ xv
        return QuadProb()
    H, _ = th.compute_hessian(quad(bt, torch.as_tensor))
    JH, _ = jh.compute_hessian(quad(bl.utils, jnp.asarray))
    assert _relerr(_np(H), np.asarray(JH)) <= TOL
    assert _relerr(_np(H), icov) <= 1e-8


def test_main_params_index_vs_jax():
    jp, tp, _ = _normal_probs(6)
    assert th.main_params_index(tp) == jh.main_params_index(jp)
    for prob in (tp, jp):
        prob.set_main_params({"params": [1, 3, 4]} if prob is tp
                             else {"params": np.asarray([1, 3, 4])})
    a = th.main_params_index(tp, param="params", sub_index=[0, 2])
    b = jh.main_params_index(jp, param="params", sub_index=[0, 2])
    assert np.array_equal(a, b)


# ------------------------------------------------- the point-source chain
def _point_chain(pkg, times, batched, target=None):
    """tests/test_hessian.py's minibatch case: 2 point sources, a
    uniform beam (fixed), hex-2's first 6 baselines, 4 channels; one
    time group, or a group a time (targets given per group)."""
    from tests.test_rime import JD0, setup_Telescope
    jT = setup_Telescope()
    rng = np.random.default_rng(0)
    freqs = np.linspace(100e6, 120e6, 4)
    ra0 = bt.TelescopeModel(jT.location).JD2RA(JD0)
    angs = np.stack([ra0 + rng.uniform(-20, 20, 2),
                     -30.72152777 + rng.uniform(-20, 20, 2)])
    params = np.zeros((1, 1, 2, 2))
    params[0, 0, 0] = rng.uniform(1, 10, 2)
    params[0, 0, 1] = -2.2
    ants, antvecs = bt.utils.make_hex(2, D=15.0)
    tg = [times[:1], times[1:]] if batched else times
    bls = None
    if pkg is bl:
        R = bl.models.sky.PointSkyResponse(freqs, freq_mode="powerlaw",
                                           f0=freqs[0])
        sky = bl.models.sky.PointSky(jnp.asarray(params), jnp.asarray(angs),
                                     R=R)
        arr = bl.ArrayModel(bl.utils.AntposDict(ants, antvecs), freqs=freqs)
        beam = bl.PixelBeam(jnp.ones((1, 1, 1, 1, 1)), freqs,
                            R=bl.beam_model.UniformResponse(), pol="e",
                            powerbeam=True, fov=180.0, parameter=False)
        bls = arr.get_bls(keep_autos=False)[:6]
        rime = bl.RIME(sky, jT, beam, arr, bls, tg, freqs)
        arrf = jnp.asarray
    else:
        R = bt.PointSkyResponse(freqs, freq_mode="powerlaw",
                                f0=float(freqs[0]), **T64)
        sky = bt.PointSky(params, angs, R=R, **T64)
        arr = bt.ArrayModel(bt.utils.AntposDict(ants, antvecs), freqs=freqs,
                            **T64)
        beam = bt.PixelBeam(np.ones((1, 1, 1, 1, 1)), freqs,
                            R=bt.UniformResponse(), pol="e", powerbeam=True,
                            fov=180.0, parameter=False, **T64)
        bls = arr.get_bls(keep_autos=False)[:6]
        rime = bt.RIME(sky, bt.TelescopeModel((21.428305555, -30.72152777,
                                               1073.0)), beam, arr, bls,
                       tg, freqs)
        arrf = torch.as_tensor
    if target is None:
        return rime
    tgts = []
    groups = [(times[i:i + 1], target[:, :, :, i:i + 1])
              for i in range(len(times))] if batched else [(times, target)]
    for t, d in groups:
        v = pkg.VisData()
        v.setup_data(bls, t, freqs, pol="ee", data=arrf(d),
                     icov=arrf(np.ones(d.shape)))
        tgts.append(v)
    return pkg.LogProb(rime, tgts, compute="like") if pkg is bt \
        else bl.inference.LogProb(rime, tgts, compute="like")


def test_compute_hessian_minibatch_and_multiprob_vs_jax():
    times = 2458168.3 + np.asarray([0.0, 5e-4])
    with torch.no_grad():
        target = _point_chain(bt, times, False)().data.numpy()
    full = _point_chain(bt, times, False, target)
    batched = _point_chain(bt, times, True, target)
    H, idx = th.compute_hessian(full)
    JH, jidx = jh.compute_hessian(_point_chain(bl, times, False, target))
    assert idx == jidx
    assert _relerr(_np(H), np.asarray(JH)) <= TOL
    Hb, _ = th.compute_hessian(batched)
    JHb, _ = jh.compute_hessian(_point_chain(bl, times, True, target))
    assert _relerr(_np(Hb), np.asarray(JHb)) <= TOL
    assert _relerr(_np(Hb), _np(H)) <= TOL
    H2, _ = th.compute_hessian([full, full])
    assert _relerr(_np(H2), 2 * _np(H)) <= 1e-12


# ---------------------------------------------------- the hex-2 RIME chain
@pytest.fixture(scope="module")
def cal_pair():
    """The small hera-cal chain (hex-2, antenna positions and gains
    trainable) in both packages at a start away from its target."""
    tp = build_cal_torch()
    truth = cal_truth(tp.model.rime.array.antvecs.detach().numpy())
    target = cal_target(tp, truth)
    tp = build_cal_torch(target=target)
    jp = build_cal_jax(target)
    return tp, jp


def test_chain_hessian_vs_jax_force_xla(cal_pair):
    """All 133 rows (21 antenna coordinates, 112 gain real pairs) of the
    chain's Hessian, through force_chunked, against the JAX package's
    jacfwd(grad) under force_xla; no kernel launched, no fused Function
    used (use_kernel=True would route to them outside the block)."""
    tp, jp = cal_pair
    tp.model.rime.use_kernel = True
    n0 = (rime_cuda.launches, rime_cuda.dtau_launches)
    H, idx = th.compute_hessian(tp)
    assert (rime_cuda.launches, rime_cuda.dtau_launches) == n0
    JH, jidx = jh.compute_hessian(jp)
    assert {k: (v.start, v.stop) for k, v in idx.items()} == \
        {k: (v.start, v.stop) for k, v in jidx.items()}
    assert H.shape == (133, 133)
    assert _relerr(_np(H), np.asarray(JH)) <= TOL
    assert _relerr(_np(H), _np(H).T) <= 1e-12
    tp.model.rime.use_kernel = "auto"


def test_chain_hessian_keys_row_block_vs_jax(cal_pair):
    """compute_hessian(keys=[antenna positions], Nstart=0, Nrows=6):
    hera-hess's row block at hex-2."""
    tp, jp = cal_pair
    H, idx = th.compute_hessian(tp, keys=[ANTVECS], Nstart=0, Nrows=6)
    JH, _ = jh.compute_hessian(jp, keys=[ANTVECS], Nstart=0, Nrows=6)
    assert H.shape == (6, 21) and idx == {ANTVECS: slice(0, 21)}
    assert _relerr(_np(H), np.asarray(JH)) <= TOL
    assert _relerr(_np(H[:, :6]), _np(H[:, :6]).T) <= 1e-12


def test_chain_hessian_rows_chunk_vs_jax(cal_pair):
    """compute_hessian with rows_chunk (reverse-over-reverse, 4 rows a
    gradient graph) over a row block that starts and ends inside a
    chunk, against its forward-over-reverse rows and the JAX package's;
    no kernel launched."""
    tp, jp = cal_pair
    kw = dict(keys=[ANTVECS], Nstart=3, Nrows=7)
    n0 = (rime_cuda.launches, rime_cuda.dtau_launches)
    H4, _ = th.compute_hessian(tp, rows_chunk=4, **kw)
    assert (rime_cuda.launches, rime_cuda.dtau_launches) == n0
    H1, _ = th.compute_hessian(tp, **kw)
    JH, _ = jh.compute_hessian(jp, rows_chunk=4, **kw)
    assert H4.shape == (7, 21)
    assert _relerr(_np(H4), _np(H1)) <= 1e-12
    assert _relerr(_np(H4), np.asarray(JH)) <= TOL


@pytest.mark.parametrize("remat", [False, True])
def test_reverse_over_reverse_through_checkpoints(cal_pair, remat):
    """Double backward (create_graph) through the RIME's pixel-chunk
    checkpoints and its per-time psky checkpoint (remat=True: the whole
    time step's) gives the same HVPs as compute_hessian's rows: the
    checkpoints' second derivatives are right, not only defined."""
    tp, _ = cal_pair
    rime = tp.model.rime
    rime.remat, chunk = remat, rime.pix_chunk
    rime.pix_chunk = 96                     # several chunks a time
    try:
        H, _ = th.compute_hessian(tp, keys=[ANTVECS])
        pd = tp.collect_main_params()
        x = pd[ANTVECS].detach().clone().requires_grad_(True)
        with rime_kernel.force_chunked():
            loss = tp(bt.ParamDict({ANTVECS: x}))
            g, = torch.autograd.grad(loss, x, create_graph=True)
            v = torch.as_tensor(np.random.default_rng(5).normal(
                size=x.shape))
            hv, = torch.autograd.grad(g, x, v)
    finally:
        rime.remat, rime.pix_chunk = False, chunk
    assert _relerr(_np(hv).ravel(), _np(H) @ _np(v).ravel()) <= TOL


def test_double_backward_outside_force_chunked_names_it():
    """A float32 chain with use_kernel=True takes the fused Functions
    (their plain versions on the CPU): a double backward through them,
    or forward-mode AD over them, raises an error naming force_chunked;
    inside force_chunked the same double backward runs."""
    tp = build_cal_torch(dtype=torch.float32)
    tp.model.rime.use_kernel = True
    x = tp.collect_main_params()[ANTVECS].detach().clone()
    x.requires_grad_(True)
    g, = torch.autograd.grad(tp(bt.ParamDict({ANTVECS: x})), x,
                             create_graph=True)
    with pytest.raises(RuntimeError, match="force_chunked"):
        torch.autograd.grad(g.sum(), x)
    with fwAD.dual_level():
        xd = fwAD.make_dual(x.detach(), torch.ones_like(x))
        with pytest.raises(RuntimeError, match="force_chunked"):
            tp(bt.ParamDict({ANTVECS: xd}))
    with rime_kernel.force_chunked():
        g, = torch.autograd.grad(tp(bt.ParamDict({ANTVECS: x})), x,
                                 create_graph=True)
        hv, = torch.autograd.grad(g.sum(), x)
    assert torch.isfinite(hv).all()


def test_force_chunked_restores_and_nests():
    assert not rime_kernel.chunked_forced()
    with rime_kernel.force_chunked():
        with rime_kernel.force_chunked():
            assert rime_kernel.chunked_forced()
        assert rime_kernel.chunked_forced()
    assert not rime_kernel.chunked_forced()


# ----------------------------------- the port's own autograd Functions
def _fn_cases():
    from bayeslim_tpu_torch.ops.linalg import _Einsum
    from bayeslim_tpu_torch.ops.sph_harm import _GlnProduct, _YlmProduct
    rng = np.random.default_rng(7)

    def c(*s):
        return torch.as_tensor(rng.normal(size=s) + 1j * rng.normal(size=s))

    def r(*s):
        return torch.as_tensor(rng.normal(size=s))
    return [("_Einsum", lambda a, b: _Einsum.apply("...ij,...jk->...ik",
                                                    a, b), (c(2, 3, 4),
                                                           c(2, 4, 5))),
            ("_YlmProduct", _YlmProduct.apply, (c(3, 4), c(4, 6))),
            ("_GlnProduct", _GlnProduct.apply, (r(2, 3, 4, 2), r(3, 5, 4)))]


@pytest.mark.parametrize("case", range(3))
def test_functions_second_derivatives(case):
    """gradgradcheck of the port's product Functions (their backward
    differentiated again), for every subset of inputs taking a
    gradient, and their jvp against finite differences."""
    name, fn, args = _fn_cases()[case]
    for need in ((True, True), (True, False), (False, True)):
        a = [x.clone().requires_grad_(n) for x, n in zip(args, need)]
        assert torch.autograd.gradgradcheck(fn, a), (name, need)
    a = [x.clone().requires_grad_(True) for x in args]
    assert torch.autograd.gradcheck(fn, a, check_forward_ad=True), name


def test_sum64_forward_over_reverse():
    """_Sum64 (a float32 chi^2 summed in float64) under forward-mode AD
    over its backward: the Hessian-vector product of sum(x^3) is
    6 x v."""
    from bayeslim_tpu_torch.inference.prob import _sum_chisq
    x = torch.as_tensor(np.random.default_rng(2).uniform(0.5, 2, 50),
                        dtype=torch.float32)
    v = torch.ones_like(x)
    with fwAD.dual_level():
        xd = fwAD.make_dual(x.clone().requires_grad_(True), v)
        loss = _sum_chisq(xd ** 3)
        assert loss.dtype == torch.float64
        g, = torch.autograd.grad(loss, xd)
        hv = fwAD.unpack_dual(g).tangent
    assert _relerr(_np(hv), 6 * _np(x)) <= 1e-6


@pytest.mark.parametrize("shared,cplx", [(True, False), (True, True),
                                         (False, True), (False, False)])
@pytest.mark.parametrize("conj", [False, True])
def test_chunk_reduce_second_derivatives(shared, cplx, conj):
    """rime_reduce's pixel chunk (ops/rime_kernel._ChunkReduce: inputs
    kept, the fringe recomputed in its backward by explicit formulas):
    gradcheck with forward-mode AD and gradgradcheck, psky shared across
    baselines or per baseline, real or complex, either sign."""
    from bayeslim_tpu_torch.ops.rime_kernel import _ChunkReduce
    rng = np.random.default_rng(11)
    freqs = np.asarray([1.0, 1.3, 1.7])       # unit scales for the
    shp = (2, 3, 4) if shared else (2, 5, 3, 4)   # finite differences
    ps = rng.standard_normal(shp) + (1j * rng.standard_normal(shp)
                                     if cplx else 0)
    ps = torch.tensor(ps, requires_grad=True)
    tau = torch.tensor(rng.uniform(-1, 1, (5, 4)), requires_grad=True)

    def fn(p, t):
        return _ChunkReduce.apply(p, t, freqs, conj, shared,
                                  torch.complex128)
    assert torch.autograd.gradcheck(fn, (ps, tau), check_forward_ad=True)
    assert torch.autograd.gradgradcheck(fn, (ps, tau))


@pytest.mark.parametrize("cplx", [False, True])
def test_chunk_reduce_model_pairs_second_derivatives(cplx):
    """_ChunkReduce with a baseline -> model-pair index: ps kept per pair
    (3 pairs, 5 baselines, one pair unused), gradcheck with forward-mode
    AD and gradgradcheck, and the values equal to the chunk reduced over
    the gathered per-baseline sky."""
    from bayeslim_tpu_torch.ops.rime_kernel import _ChunkReduce
    rng = np.random.default_rng(12)
    freqs = np.asarray([1.0, 1.3, 1.7])
    shp = (2, 3, 3, 4)
    ps = rng.standard_normal(shp) + (1j * rng.standard_normal(shp)
                                     if cplx else 0)
    ps = torch.tensor(ps, requires_grad=True)
    tau = torch.tensor(rng.uniform(-1, 1, (5, 4)), requires_grad=True)
    mp = torch.tensor([2, 0, 0, 2, 0])

    def fn(p, t):
        return _ChunkReduce.apply(p, t, freqs, False, False,
                                  torch.complex128, mp)
    ref = _ChunkReduce.apply(ps.index_select(-3, mp), tau, freqs, False,
                             False, torch.complex128)
    assert _relerr(_np(fn(ps, tau)), _np(ref)) <= 1e-12
    assert torch.autograd.gradcheck(fn, (ps, tau), check_forward_ad=True)
    assert torch.autograd.gradgradcheck(fn, (ps, tau))
