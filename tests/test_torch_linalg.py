"""The port's ops/linalg.py against the JAX package's, function by
function, at float64 on the CPU (1e-9 relative). Inputs come from numpy
seeds."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayeslim_tpu.ops import linalg as jla
from bayeslim_tpu_torch.ops import linalg as tla

TOL = 1e-9


def _relerr(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def _c(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _spd(rng, n, cplx=False):
    A = _c(rng, n, n) if cplx else rng.standard_normal((n, n))
    return A @ A.conj().T + n * np.eye(n)


def _check(name, args, kwargs=None):
    """Run ops.linalg.<name> on numpy args through both packages and
    compare every output."""
    kwargs = kwargs or {}

    def conv(f, x):
        return f(x) if isinstance(x, np.ndarray) else x
    ref = getattr(jla, name)(*[conv(jnp.asarray, a) for a in args],
                             **{k: conv(jnp.asarray, v)
                                for k, v in kwargs.items()})
    got = getattr(tla, name)(*[conv(torch.as_tensor, a) for a in args],
                             **{k: conv(torch.as_tensor, v)
                                for k, v in kwargs.items()})
    refs = ref if isinstance(ref, tuple) else (ref,)
    gots = got if isinstance(got, tuple) else (got,)
    assert len(refs) == len(gots)
    for r, g in zip(refs, gots):
        if r is None:
            assert g is None
            continue
        assert _relerr(g.resolve_conj().numpy(), np.asarray(r)) <= TOL, name


def _elementwise_cases():
    rng = np.random.default_rng(0)
    a, b = _c(rng, 3, 4), _c(rng, 3, 4)
    sq = _c(rng, 2, 3, 3)
    d1 = _c(rng, 1, 1, 5, 2)
    d2 = _c(rng, 2, 2, 5, 2)
    e2 = _c(rng, 2, 2, 5, 2)
    return [
        ("cmult", (a, b)), ("cdiv", (a, b)), ("cconj", (a,)),
        ("angle", (a,)), ("abs", (a,)), ("cinv", (sq,)),
        ("ceinsum", ("ij,kj->ik", a, b)),
        ("diag_matmul", (d1, _c(rng, 1, 1, 5, 2))),
        ("diag_matmul", (d2, e2)), ("diag_inv", (d1,)), ("diag_inv", (d2,)),
        ("cmatmul", (d1, _c(rng, 1, 1, 5, 2))), ("cmatmul", (d2, e2)),
        ("apply_phasor", (a, rng.standard_normal((3, 4)))),
        ("apply_phasor", (np.stack([a.real, a.imag], -1),
                          rng.standard_normal((3, 4)))),
    ]


@pytest.mark.parametrize("name,args", _elementwise_cases(),
                         ids=lambda x: x if isinstance(x, str) else "")
def test_elementwise_and_small_matrix_helpers(name, args):
    _check(name, args)


@pytest.mark.parametrize("kwargs", [dict(), dict(avg_axis=1),
                                    dict(select=(slice(None), slice(0, 1))),
                                    dict(avg_axis=0, select=(0,))])
@pytest.mark.parametrize("pairs", [False, True])
def test_project_out_phase(kwargs, pairs):
    rng = np.random.default_rng(1)
    z = _c(rng, 4, 5)
    if pairs:
        z = np.stack([z.real, z.imag], -1)
    _check("project_out_phase", (z,), kwargs)


@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_cholesky_inverse(cplx, ndim):
    rng = np.random.default_rng(2)
    if ndim == 1:
        A = rng.uniform(1, 2, 5)
    else:
        A = _spd(rng, 5, cplx)
        if ndim == 3:
            A = np.stack([A, _spd(rng, 5, cplx)])
    if ndim < 3:        # the JAX function takes one matrix
        _check("cholesky_inverse", (A,))
    if ndim > 1:
        Ainv, _ = tla.cholesky_inverse(torch.as_tensor(A))
        assert _relerr(Ainv.numpy(), np.linalg.inv(A)) <= TOL


def test_cholesky_inverse_rejects_indefinite():
    with pytest.raises(np.linalg.LinAlgError):
        tla.cholesky_inverse(torch.as_tensor(-np.eye(3)))
    Ainv, L = tla.cholesky_inverse(torch.as_tensor(-np.eye(3)),
                                   check_errors=False)
    assert torch.isnan(L).all()


@pytest.mark.parametrize("method", ["pinv", "chol", "lstsq", "diag", "inv"])
@pytest.mark.parametrize("eps", [0.0, 0.3])
@pytest.mark.parametrize("cplx", [False, True])
def test_invert_matrix(method, eps, cplx):
    rng = np.random.default_rng(3)
    A = _spd(rng, 6, cplx)
    kw = dict(method=method, eps=eps)
    if method == "pinv":
        kw["hermitian"] = True
    _check("invert_matrix", (A,), kw)
    _check("invert_matrix", (rng.uniform(1, 2, 6),), dict(method=method))


def test_pinv_takes_the_jax_cutoff():
    """A singular value between torch's default cut-off (max(M, N) eps)
    and JAX's (10 max(M, N) eps) is dropped, as the JAX package's
    default pinv drops it; torch's default would keep it."""
    A = np.diag([1.0, 3e-15])
    ref = np.asarray(jnp.linalg.pinv(jnp.asarray(A)))
    got = tla.pinv(torch.as_tensor(A)).numpy()
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=0)
    np.testing.assert_allclose(got, np.diag([1.0, 0.0]), atol=0)
    assert torch.linalg.pinv(torch.as_tensor(A))[1, 1] > 1e14


def _lsq_cases():
    cases = []
    for mode in ("matrix", "lstsq"):
        for ninv in ("none", "vec", "full_shape", "matrix"):
            norms = ("inv",) if mode == "lstsq" else \
                (None, "inv", "pinv", "chol", "diag")
            for norm in norms:
                # lstsq takes no per-sample diagonal; the JAX
                # cholesky_inverse takes no stack of matrices
                if ninv == "full_shape" and (mode == "lstsq"
                                             or norm == "chol"):
                    continue
                for dim in (0, -1):
                    cases.append((mode, ninv, norm, dim))
    return cases


@pytest.mark.parametrize("mode,ninv,norm,dim", _lsq_cases())
def test_least_squares(mode, ninv, norm, dim):
    rng = np.random.default_rng(4)
    Ns, Nf = 9, 3
    A = _c(rng, Ns, Nf)
    y = _c(rng, 4, Ns) if dim == -1 else _c(rng, Ns, 4)
    Ninv = {"none": None, "vec": rng.uniform(0.5, 2, Ns),
            "full_shape": rng.uniform(0.5, 2, y.shape),
            "matrix": _spd(rng, Ns)}[ninv]
    kw = dict(dim=dim, Ninv=Ninv, mode=mode, norm=norm, pinv=False)
    _check("least_squares", (A, y), kw)


@pytest.mark.parametrize("flags", [dict(pretran=True), dict(preconj=True),
                                   dict(return_D=False), dict(eps=0.1)])
def test_least_squares_options(flags):
    rng = np.random.default_rng(5)
    A = _c(rng, 8, 3)
    y = rng.standard_normal((2, 8))
    if flags.get("pretran"):
        A = A.T.copy()
    _check("least_squares", (A, y), dict(flags, norm="inv"))


def test_least_squares_recovers_the_solution():
    rng = np.random.default_rng(6)
    A = rng.standard_normal((20, 4))
    x = rng.standard_normal((3, 4))
    got, D = tla.least_squares(torch.as_tensor(A),
                               torch.as_tensor(x @ A.T))
    np.testing.assert_allclose(got.numpy(), x, rtol=1e-10)
    np.testing.assert_allclose(D.numpy(), np.linalg.inv(A.T @ A),
                               rtol=1e-9)


@pytest.mark.parametrize("cov_axis,shape,mode", [
    (None, (1, 1, 3, 2, 4), "vis"),
    ("full", (24, 24), "vis"),
    ("bl", (1, 1, 2, 4, 3, 3), "vis"),
    ("time", (1, 1, 3, 4, 2, 2), "vis"),
    ("freq", (1, 1, 3, 2, 4, 4), "vis"),
    ("freq", (1, 1, 5, 4, 4), "map"),
    ("pix", (1, 1, 4, 5, 5), "map"),
])
def test_cov_get_diag(cov_axis, shape, mode):
    rng = np.random.default_rng(7)
    cov = rng.standard_normal(shape)
    kw = dict(mode=mode)
    if cov_axis == "full":
        kw["shape"] = (1, 1, 3, 2, 4)
    _check("cov_get_diag", (cov, cov_axis), kw)
