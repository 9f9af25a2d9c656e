"""The port's posterior step as a whole against the JAX package on
__graft_entry__.entry()'s shapes: loss and every gradient, three Adam
steps against optax.adam, the device rule, and the rule that the port
never imports JAX or the JAX package."""
import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import bayeslim_tpu as bl
import bayeslim_tpu_torch as bt
from bayeslim_tpu_torch.scripts import mosaic_spike

from _torch_graft import build_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_entry():
    import __graft_entry__ as ge
    fn, (pd, model, data, icov) = ge.entry()
    rng = np.random.default_rng(1)
    # away from the target's own parameters, so gradients are not ~0
    pert = {k: np.asarray(v) * (1 + 0.05 * rng.standard_normal(np.shape(v)))
            for k, v in pd.items()}
    return fn, model, data, icov, pert


def _relerr(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def _jax_vg(jax_entry, params):
    fn, model, data, icov, _ = jax_entry
    pd = bl.ParamDict({k: jnp.asarray(v) for k, v in params.items()})
    return jax.value_and_grad(fn)(pd, model, data, icov)


@pytest.mark.parametrize("dtype,use_kernel,tol", [
    (torch.float64, "auto", 1e-9),      # chunked path, float64
    (torch.float32, True, 1e-4),        # fused Function, kernel contract
])
def test_slice_loss_and_grads_vs_jax(jax_entry, dtype, use_kernel, tol):
    pert = jax_entry[4]
    jv, jg = _jax_vg(jax_entry, pert)
    target = torch.as_tensor(np.array(jax_entry[2]))[None, None]
    prob = build_torch(dtype=dtype, use_kernel=use_kernel,
                       target=target.to(torch.complex64
                                        if dtype == torch.float32
                                        else torch.complex128))
    bt.load_numpy_pdict(prob.model, pert)
    tv, tg = prob.value_and_grad()
    assert tg.keys() == sorted(jg.keys()) == ["beam.params", "sky.params"]
    assert abs(tv.item() - float(jv)) / abs(float(jv)) <= tol
    for k in tg.keys():
        assert tg[k].dtype == dtype
        assert _relerr(tg[k].numpy(), jg[k]) <= tol, k


def test_trainer_adam_vs_optax(jax_entry):
    pert, lr = jax_entry[4], 1e-2
    opt = optax.adam(lr)
    p = bl.ParamDict({k: jnp.asarray(v) for k, v in pert.items()})
    state = opt.init(p)
    jlosses = []
    for _ in range(3):
        v, g = _jax_vg(jax_entry, {k: np.asarray(x) for k, x in p.items()})
        up, state = opt.update(g, state, p)
        p = optax.apply_updates(p, up)
        jlosses.append(float(v))
    prob = build_torch(target=torch.as_tensor(
        np.array(jax_entry[2]))[None, None])
    bt.load_numpy_pdict(prob.model, pert)
    tr = bt.Trainer(prob, lr=lr)
    losses = tr.train(3)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-9)
    for k, v in tr.pdict.items():
        assert _relerr(v.detach().numpy(), p[k]) <= 1e-8, k
        # train() writes the final parameters into the model
        np.testing.assert_array_equal(
            dict(prob.model.named_parameters())[k].detach().numpy(),
            v.detach().numpy())


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_never_imports_jax():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "bayeslim_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 15
    names = {os.path.relpath(f, REPO) for f in files}
    assert {"bayeslim_tpu_torch/inference/sampler.py",
            "bayeslim_tpu_torch/inference/hmat.py",
            "bayeslim_tpu_torch/ops/special.py",
            "bayeslim_tpu_torch/ops/sph_harm.py",
            "bayeslim_tpu_torch/models/cosmology.py",
            "bayeslim_tpu_torch/models/beam_ylm.py",
            "bayeslim_tpu_torch/models/linear_model.py",
            "bayeslim_tpu_torch/utils/multires.py",
            "bayeslim_tpu_torch/parallel/sharding.py",
            "bayeslim_tpu_torch/parallel/multihost.py"} <= names
    banned = ("jax", "jaxlib", "optax", "bayeslim_tpu")
    for f in files:
        for mod in _imports(f):
            assert mod.split(".")[0] not in banned, f"{f} imports {mod}"


def test_port_imports_h5py_and_mpmath_only_inside_functions():
    """h5py (write_Ylm / load_Ylm) and mpmath (hypF's exact route) are
    imported where they are asked for, so that the port loads without
    them (the card's machine has neither)."""
    lazy = ("h5py", "mpmath")
    for root, _, names in os.walk(os.path.join(REPO, "bayeslim_tpu_torch")):
        for n in names:
            if not n.endswith(".py"):
                continue
            path = os.path.join(root, n)
            tree = ast.parse(open(path).read(), path)
            for node in tree.body:
                mods = []
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    mods = [node.module]
                for mod in mods:
                    assert mod.split(".")[0] not in lazy, f"{path}: {mod}"


@pytest.mark.parametrize("make", [
    lambda: bt.resolve_device(None),
    lambda: bt.ArrayModel(bt.utils.AntposDict([0, 1], np.eye(2, 3))),
    lambda: bt.PixelSkyResponse(np.ones(2)),
    lambda: bt.PixelBeam(np.ones((1, 1, 1, 1, 2)), np.ones(2)),
    lambda: bt.PixelSky(np.ones((1, 1, 2, 3)), np.ones((2, 3)), 1.0,
                        R=None),
    lambda: bt.JonesModel(np.ones((1, 1, 2, 1, 2, 2)), [0, 1]),
    lambda: mosaic_spike.main(device=None),
    lambda: bt.inference.ZeroMat((2, 2)).to_dense(),
    lambda: bt.parallel.multihost.rank_device(None),
    lambda: bt.parallel.replicate(np.ones(3),
                                  bt.parallel.make_mesh({"data": 1})),
])
def test_default_device_is_cuda(make):
    """device=None means CUDA; without a GPU that raises rather than
    quietly running on the CPU."""
    if torch.cuda.is_available():
        assert bt.resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()
