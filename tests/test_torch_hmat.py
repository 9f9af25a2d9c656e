"""The port's inference/hmat.py against the JAX package's, operator by
operator, at float64 on the CPU (1e-9 relative): products, transposes
(lazy and conjugate), dense forms, diagonals, the reference's
transpose= / out= keywords, scalar_mul, least_squares, the solves,
SolveHierMat's Cholesky actions and logdet, and make_hodlr. Inputs
come from numpy seeds; each operator is built from the same arrays in
both packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayeslim_tpu.inference import hmat as jh
from bayeslim_tpu.utils import ParamDict as JParamDict
from bayeslim_tpu_torch.inference import hmat as th
from bayeslim_tpu_torch.utils import ParamDict

TOL = 1e-9
CPU = dict(dtype=torch.float64, device="cpu")


def _relerr(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def _close(got, ref, tol=TOL):
    got = got.resolve_conj().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert _relerr(got, ref) <= tol, _relerr(got, ref)


def _kernel_spd(n, width, ridge):
    """A smooth-kernel SPD matrix: low-rank off-diagonal blocks."""
    x = np.linspace(0, 1, n)
    return np.exp(-(x[:, None] - x[None]) ** 2 / width ** 2) \
        + ridge * np.eye(n)


def _data():
    rng = np.random.default_rng(0)
    A = rng.standard_normal((6, 6))
    d = rng.uniform(0.5, 2.0, 6)
    U, V = rng.standard_normal((6, 2)), rng.standard_normal((6, 2))
    S = A @ A.T + 6 * np.eye(6)
    Uc = rng.standard_normal((6, 2)) + 1j * rng.standard_normal((6, 2))
    Ac = rng.standard_normal((6, 6)) + 1j * rng.standard_normal((6, 6))
    H = _kernel_spd(16, 0.4, 0.7)
    h = 8
    u, sv, vt = np.linalg.svd(H[:h, h:])
    off = u[:, :4] * sv[:4]
    H[:h, h:] = off @ vt[:4]
    H[h:, :h] = H[:h, h:].T
    return dict(A=A, d=d, U=U, V=V, S=S, Uc=Uc, Ac=Ac, tri=rng.standard_normal(
        21), U8=rng.standard_normal((8, 2)), H=H, off=off, vt=vt[:4],
        K=_kernel_spd(32, 0.3, 0.5))


def _ops(m, conv, zkw):
    """name -> operator of hmat module m, arrays converted by conv; zkw
    the ZeroMat / OneMat dtype and device keywords."""
    D = {k: conv(v) for k, v in _data().items()}
    h = 8
    H = D["H"]
    return {
        "dense": lambda: m.DenseMat(D["A"]),
        "dense_complex": lambda: m.DenseMat(D["Ac"]),
        "diag": lambda: m.DiagMat(D["d"]),
        "diag_scalar": lambda: m.DiagMat(2.0, size=6),
        "triang_lower": lambda: m.TriangMat(D["A"]),
        "triang_upper": lambda: m.TriangMat(D["A"], lower=False),
        "triang_raveled": lambda: m.TriangMat(D["tri"]),
        "sparse": lambda: m.SparseMat(D["U"], D["V"], D["d"]),
        "sparse_sym": lambda: m.SparseMat(D["U"]),
        "sparse_reference": lambda: m.SparseMat((6, 6), D["U"], D["V"].T,
                                                Hdiag=D["d"][:4]),
        "sparse_hermitian": lambda: m.SparseMat((6, 6), D["Uc"],
                                                hermitian=True),
        "zero": lambda: m.ZeroMat((6, 6), **zkw),
        "one": lambda: m.OneMat((6, 6), 2.0, **zkw),
        "one_scalar": lambda: m.OneMat((6, 6), scalar=3.0, **zkw),
        "transposed": lambda: m.TransposedMat(m.SparseMat(D["U8"], D["V"])),
        "solve": lambda: m.SolveMat(A=D["S"]),
        "partitioned": lambda: m.PartitionedMat(
            [[m.DenseMat(D["A"][:3, :3]), m.ZeroMat((3, 3), **zkw)],
             [m.ZeroMat((3, 3), **zkw), m.DiagMat(D["d"][3:])]]),
        "hier_hodlr": lambda: m.make_hodlr(D["K"], min_size=8, rank=6),
        "hier_sym_scalar": lambda: m.HierMat(
            m.DenseMat(H[:h, :h]), m.DenseMat(H[h:, h:]),
            A10=m.SparseMat(D["vt"].T, D["off"]), sym=True, scalar=2.5),
        "column": lambda: m.MatColumn([m.DenseMat(D["A"]),
                                       m.DiagMat(D["d"])]),
        "row": lambda: m.MatRow([m.DenseMat(D["A"]), m.DiagMat(D["d"])]),
        "sum": lambda: m.MatSum([m.DenseMat(D["A"]), m.DiagMat(D["d"]),
                                 m.SparseMat(D["U"], D["V"])]),
        "solve_hier": lambda: m.SolveHierMat(m.make_hodlr(
            D["K"], min_size=8, rank=12)),
    }


def _pair(name):
    j = _ops(jh, jnp.asarray, {})[name]()
    t = _ops(th, torch.as_tensor, CPU)[name]()
    return j, t


@pytest.mark.parametrize("name", sorted(_ops(jh, np.asarray, {})))
def test_operator_matches_jax(name):
    """Products, transposes, dense form, diagonal, reference keywords and
    scalar_mul of one operator, both packages from the same arrays."""
    j, t = _pair(name)
    assert tuple(t.shape) == tuple(j.shape)
    rng = np.random.default_rng(1)
    n0, n1 = j.shape
    v = rng.standard_normal(n1)
    w = rng.standard_normal(n0)
    wc = w + 1j * rng.standard_normal(n0)
    M = rng.standard_normal((n1, 3))
    out0 = rng.standard_normal(n0)
    tv = torch.as_tensor
    _close(t.mat_vec_mul(tv(v)), j.mat_vec_mul(jnp.asarray(v)))
    _close(t @ tv(v), j @ jnp.asarray(v))
    _close(t.t_mat_vec_mul(tv(w)), j.t_mat_vec_mul(jnp.asarray(w)))
    _close(t.h_mat_vec_mul(tv(wc)), j.h_mat_vec_mul(jnp.asarray(wc)))
    _close(t.mat_vec_mul(tv(wc), transpose=True),
           j.mat_vec_mul(jnp.asarray(wc), transpose=True))
    _close(t.mat_vec_mul(tv(v), out=tv(out0)),
           j.mat_vec_mul(jnp.asarray(v), out=jnp.asarray(out0)))
    _close(t.mat_mat_mul(tv(M)), j.mat_mat_mul(jnp.asarray(M)))
    _close(t.to_dense(), j.to_dense())
    _close(t.to_dense(transpose=True), j.to_dense(transpose=True))
    if n0 == n1:
        _close(t.diagonal(), j.diagonal())
    tt, jt = t.to_transpose(), j.to_transpose()
    _close(tt.mat_vec_mul(tv(w)), jt.mat_vec_mul(jnp.asarray(w)))
    _close(tt.to_dense(), jt.to_dense())
    if name == "solve_hier":
        with pytest.raises(NotImplementedError):
            t.scalar_mul(2.0)
    else:
        _close(t.scalar_mul(2.0).to_dense(), j.scalar_mul(2.0).to_dense())


def test_hadamard_matches_jax():
    rng = np.random.default_rng(2)
    Hc = rng.standard_normal((4, 4)) + 1j * rng.standard_normal((4, 4))
    X = rng.standard_normal((4, 4))
    j, t = jh.HadamardMat(jnp.asarray(Hc)), th.HadamardMat(torch.as_tensor(Hc))
    for kw in ({}, {"transpose": True}, {"square": True}):
        _close(t.mat_mat_mul(torch.as_tensor(X), **kw),
               j.mat_mat_mul(jnp.asarray(X), **kw))
    _close(t.mat_vec_mul(torch.as_tensor(X), transpose=True),
           j.mat_vec_mul(jnp.asarray(X), transpose=True))
    _close(t.mat_vec_mul(torch.as_tensor(X), out=torch.as_tensor(X)),
           j.mat_vec_mul(jnp.asarray(X), out=jnp.asarray(X)))
    _close(t.to_dense(transpose=True), j.to_dense(transpose=True))
    _close(t.scalar_mul(3.0).to_dense(), j.scalar_mul(3.0).to_dense())


@pytest.mark.parametrize("weights", ["none", "vector", "operator"])
@pytest.mark.parametrize("op", ["dense", "sparse"])
def test_least_squares_matches_jax(op, weights):
    """Conjugate-gradient least squares: the same iterates as
    jax.scipy.sparse.linalg.cg."""
    rng = np.random.default_rng(3)
    if op == "dense":
        M = rng.standard_normal((30, 12))
        j, t = jh.DenseMat(jnp.asarray(M)), th.DenseMat(torch.as_tensor(M))
    else:
        U, V = rng.standard_normal((30, 12)), rng.standard_normal((12, 12))
        j = jh.SparseMat(jnp.asarray(U), jnp.asarray(V))
        t = th.SparseMat(torch.as_tensor(U), torch.as_tensor(V))
    y = rng.standard_normal(30)
    w = rng.uniform(0.5, 2.0, 30)
    nj = nt = None
    if weights == "vector":
        nj, nt = jnp.asarray(w), torch.as_tensor(w)
    elif weights == "operator":
        nj, nt = jh.DiagMat(jnp.asarray(w)), th.DiagMat(torch.as_tensor(w))
    # converged, stopped early by tol, stopped by maxiter (CG iterates
    # near convergence amplify rounding: the late ones are not compared)
    for tol, maxiter in ((1e-12, 500), (0.3, None), (1e-12, 3)):
        _close(t.least_squares(torch.as_tensor(y), Ninv=nt, tol=tol,
                               maxiter=maxiter),
               j.least_squares(jnp.asarray(y), Ninv=nj, tol=tol,
                               maxiter=maxiter), tol=1e-8)


@pytest.mark.parametrize("name", ["solve", "solve_chol", "solve_upper"])
def test_solve_mat_matches_jax(name):
    rng = np.random.default_rng(4)
    A = rng.standard_normal((5, 5))
    S = A @ A.T + 5 * np.eye(5)
    L = np.linalg.cholesky(S)
    kw = {"solve": lambda m, c: m.SolveMat(A=c(S)),
          "solve_chol": lambda m, c: m.SolveMat(chol=c(L)),
          "solve_upper": lambda m, c: m.SolveMat(chol=c(L.T), lower=False)}
    j = kw[name](jh, jnp.asarray)
    t = kw[name](th, torch.as_tensor)
    v = rng.standard_normal(5)
    for f in ("mat_vec_mul", "forward_sub", "back_sub"):
        _close(getattr(t, f)(torch.as_tensor(v)),
               getattr(j, f)(jnp.asarray(v)))
    _close(t.to_dense(), j.to_dense())
    _close(t.scalar_mul(4.0).mat_vec_mul(torch.as_tensor(v)),
           j.scalar_mul(4.0).mat_vec_mul(jnp.asarray(v)))


@pytest.mark.parametrize("case", ["halves", "scalar_sym", "forward_only"])
def test_solve_hier_mat_matches_jax(case):
    """SolveHierMat: A^-1 v, L v, L^-1 v, L^-T v and logdet, both
    packages from the same HODLR operator; the port's also against dense
    numpy."""
    d = _data()
    if case == "halves":
        def mk(m, c):
            return m.SolveHierMat(m.make_hodlr(c(_kernel_spd(64, 0.3, 0.5)),
                                               min_size=16, rank=16))
    elif case == "scalar_sym":
        def mk(m, c):
            H, h = d["H"], 8
            return m.HierMat(m.DenseMat(c(H[:h, :h])),
                             m.DenseMat(c(H[h:, h:])),
                             A10=m.SparseMat(c(d["vt"].T), c(d["off"])),
                             sym=True, scalar=2.5).to_SolveHierMat()
    else:
        def mk(m, c):
            return m.make_hodlr(c(d["K"]), min_size=8, rank=12) \
                .to_SolveHierMat(trans_solve=False)
    j, t = mk(jh, jnp.asarray), mk(th, torch.as_tensor)
    rng = np.random.default_rng(5)
    v = rng.standard_normal(t.shape[0])
    V2 = rng.standard_normal((t.shape[0], 3))
    for f in ("mat_vec_mul", "chol_mul", "forward_sub", "back_sub"):
        _close(getattr(t, f)(torch.as_tensor(v)),
               getattr(j, f)(jnp.asarray(v)))
        _close(getattr(t, f)(torch.as_tensor(V2)),
               getattr(j, f)(jnp.asarray(V2)))
    assert abs(float(t.logdet()) - float(j.logdet())) <= TOL * abs(
        float(j.logdet()))
    # L L^T of the port's factor is the operator it factored
    L = t.chol_mul(torch.eye(t.shape[0], dtype=torch.float64)).numpy()
    if case != "forward_only":
        Ainv = t.mat_vec_mul(torch.eye(t.shape[0], dtype=torch.float64))
        assert _relerr(np.linalg.inv(L @ L.T), Ainv.numpy()) < 1e-8
    sign, ld = np.linalg.slogdet(L @ L.T)
    assert sign > 0 and abs(float(t.logdet()) - ld) < 1e-8 * abs(ld)


@pytest.mark.parametrize("kw", [
    dict(min_size=32, rank=10), dict(min_size=16, Nrank=6),
    dict(min_size=8, rank=8, rcond=1e-6), dict(min_size=8, rank=8,
                                                sparse_tol=1e-4),
    dict(min_size=4, rank=4, depth=2),
    dict(indices=[slice(0, 40), slice(40, 64), slice(64, 100),
                  slice(100, 128)], rank=10),
    dict(min_size=32, rank=10, trisolve=True)], ids=lambda k: "-".join(k))
def test_make_hodlr_matches_jax(kw):
    """make_hodlr's compression (compared by its products and dense
    form, which do not depend on the SVD's sign choices)."""
    A = _kernel_spd(128, 0.2, 1.0)
    j = jh.make_hodlr(jnp.asarray(A), **kw)
    t = th.make_hodlr(torch.as_tensor(A), **kw)
    assert type(t).__name__ == type(j).__name__
    v = np.random.default_rng(6).standard_normal(128)
    _close(t.mat_vec_mul(torch.as_tensor(v)), j.mat_vec_mul(jnp.asarray(v)))
    if not kw.get("trisolve"):
        _close(t.to_dense(), j.to_dense())
        _close(t.diagonal(), j.diagonal())
        dl = t.diagonal(return_tensor=False)
        assert isinstance(dl, list) and sum(len(x) for x in dl) == 128


def test_matdict_matches_jax():
    rng = np.random.default_rng(7)
    A = rng.standard_normal((6, 6))
    x = rng.standard_normal((2, 3))
    y = rng.standard_normal(4)
    j = jh.MatDict({"a": jh.DenseMat(jnp.asarray(A))})
    t = th.MatDict({"a": th.DenseMat(torch.as_tensor(A))})
    jo = j(JParamDict({"a": jnp.asarray(x), "b": jnp.asarray(y)}))
    to = t(ParamDict({"a": torch.as_tensor(x), "b": torch.as_tensor(y)}))
    assert "a" in t and t["a"].shape == (6, 6)
    for k in ("a", "b"):
        _close(to[k], jo[k])


def test_complex_operand_on_real_operator():
    """A real operator applied to a complex vector promotes, as jnp
    does (complex momenta under a real mass matrix)."""
    rng = np.random.default_rng(8)
    S = _kernel_spd(32, 0.3, 0.5)
    vc = rng.standard_normal(32) + 1j * rng.standard_normal(32)
    for mk in (lambda m, c: m.DenseMat(c(S)),
               lambda m, c: m.TriangMat(c(np.linalg.cholesky(S))),
               lambda m, c: m.SolveMat(A=c(S)),
               lambda m, c: m.SolveHierMat(m.make_hodlr(c(S), min_size=8,
                                                        rank=12))):
        j, t = mk(jh, jnp.asarray), mk(th, torch.as_tensor)
        _close(t.mat_vec_mul(torch.as_tensor(vc)),
               j.mat_vec_mul(jnp.asarray(vc)))
