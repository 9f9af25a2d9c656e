"""The port's training-state checkpoints (utils/checkpoint.py), logging
(utils/logging.py) and the Trainer's reporting against the JAX package:
a train state's round trip (atomic writes, restore in place into a
fresh optimizer), CheckpointManager's kept steps against the JAX
(orbax) manager's for the same calls, a CPU fit interrupted,
checkpointed, rebuilt, restored and resumed bit for bit equal to an
uninterrupted one, Metrics and the JSON-lines log equal in content to
the JAX ones for the same values, the Trainer's Nreport / logger /
metrics / verbose against the JAX Trainer's, and the torch.profiler
trace. Inputs come from numpy seeds on a hex-2 chain at float64."""
import json
import logging as pylogging
import os

import numpy as np
import pytest
import torch

import bayeslim_tpu as bl
import bayeslim_tpu_torch as bt
from bayeslim_tpu.data import io as jio
from bayeslim_tpu.inference.trainer import Trainer as JTrainer
from bayeslim_tpu.utils import checkpoint as jck
from bayeslim_tpu.utils import logging as jlog
from bayeslim_tpu_torch.data import io as tio
from bayeslim_tpu_torch.utils import checkpoint as tck
from bayeslim_tpu_torch.utils import logging as tlog

from test_torch_io import T64, _seq_dict, _write_target


@pytest.fixture
def target(tmp_path):
    return _write_target(tmp_path, _seq_dict())


def _prob(target, pkg="torch"):
    if pkg == "jax":
        return jio.build_prob(seq_dict=_seq_dict(), data=target)
    return tio.build_prob(seq_dict=_seq_dict(), data=target, **T64)


def _adam(params):
    return torch.optim.Adam(params, lr=1e-3)


def test_train_state_roundtrip(tmp_path, target):
    """save_train_state / restore_train_state: params, the optimizer's
    state_dict, step and extra; restore with like fills the given
    tensors and optimizer in place; no temporary file is left."""
    tr = bt.Trainer(_prob(target), optimizer=_adam, verbose=False)
    tr.train(2)
    path = str(tmp_path / "state.pt")
    assert tck.save_train_state(path, tr.pdict, tr.opt, step=2,
                                extra={"note": "x", "loss": 1.5}) == path
    assert not [f for f in os.listdir(tmp_path) if ".tmp" in f]
    st = tck.restore_train_state(path, device="cpu")
    assert st["step"] == 2 and st["extra"] == {"note": "x", "loss": 1.5}
    for k, v in tr.pdict.items():
        assert torch.equal(st["params"][k], v.detach())
    fresh = bt.Trainer(_prob(target), optimizer=_adam, verbose=False)
    held = {k: v for k, v in fresh.pdict.items()}
    st = tck.restore_train_state(path, like={"params": fresh.pdict,
                                             "opt_state": fresh.opt})
    for k, v in fresh.pdict.items():
        assert v is held[k] and torch.equal(v.detach(),
                                            tr.pdict[k].detach())
    a, b = fresh.opt.state_dict(), tr.opt.state_dict()
    for i in a["state"]:
        for key in a["state"][i]:
            assert torch.equal(a["state"][i][key], b["state"][i][key])
            assert a["state"][i][key].device == b["state"][i][key].device


@pytest.mark.parametrize("keep,every,nsteps", [(2, 1, 5), (3, 2, 9),
                                               (1, 3, 7)])
def test_checkpoint_manager_keeps_the_jax_managers_steps(tmp_path, keep,
                                                         every, nsteps):
    """The same maybe_save calls keep the same steps as the JAX (orbax)
    manager; restore_latest gives the latest one's values."""
    jm = jck.CheckpointManager(str(tmp_path / "jax"), max_to_keep=keep)
    tm = tck.CheckpointManager(str(tmp_path / "torch"), max_to_keep=keep)
    assert tm.latest_step is None and tm.restore_latest() is None
    for s in range(nsteps):
        a = jm.maybe_save(s, bl.ParamDict({"a": np.ones(3) * s}),
                          every=every)
        b = tm.maybe_save(s, bt.ParamDict({"a": torch.ones(3) * s}),
                          every=every)
        assert a == b
    assert tm.all_steps() == list(jm._mgr.all_steps())
    assert tm.latest_step == jm.latest_step
    st = tm.restore_latest(device="cpu")
    assert st["step"] == jm.latest_step
    assert torch.equal(st["params"]["a"], torch.ones(3) * jm.latest_step)
    jm.close()
    tm.close()
    # a new manager over the same directory sees the saved steps
    assert tck.CheckpointManager(str(tmp_path / "torch"),
                                 max_to_keep=keep).latest_step == \
        jm.latest_step


def test_checkpoint_manager_removes_stale_temporaries(tmp_path):
    """A temporary file left by a save that never finished goes at the
    next save; the saved steps and other files stay."""
    d = tmp_path / "ck"
    tm = tck.CheckpointManager(str(d), max_to_keep=2)
    tm.maybe_save(0, bt.ParamDict({"a": torch.zeros(2)}))
    (d / "1.pt.tmp-12345").write_bytes(b"partial")
    (d / "notes.txt").write_text("kept")
    assert tm.all_steps() == [0]
    tm.maybe_save(1, bt.ParamDict({"a": torch.ones(2)}))
    assert sorted(os.listdir(d)) == ["0.pt", "1.pt", "notes.txt"]
    st = tm.restore_latest(device="cpu")
    assert st["step"] == 1 and torch.equal(st["params"]["a"], torch.ones(2))


def test_interrupted_fit_resumes_bit_equal(tmp_path, target):
    """4 Adam steps in one run against 2 steps, a checkpoint each step,
    a fresh build of the chain restored from the latest checkpoint and
    2 more steps: the same losses and final parameters, bit for bit."""
    ref = bt.Trainer(_prob(target), optimizer=_adam, verbose=False)
    ref_losses = ref.train(4)
    mgr = tck.CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    first = bt.Trainer(_prob(target), optimizer=_adam, verbose=False)
    for step in range(2):
        first.train(1)
        mgr.maybe_save(step, first.pdict, first.opt, every=1,
                       extra={"losses": list(first.loss_history)})
    assert mgr.all_steps() == [0, 1]
    second = bt.Trainer(_prob(target), optimizer=_adam, verbose=False)
    st = mgr.restore_latest(like={"params": second.pdict,
                                  "opt_state": second.opt})
    second.loss_history = list(st["extra"]["losses"])
    second.train(2)
    assert second.loss_history == ref_losses
    for k, v in ref.pdict.items():
        assert torch.equal(second.pdict[k], v), k
        assert torch.equal(second.prob.model[k], ref.prob.model[k]), k


def test_metrics_and_jsonl_log_vs_jax(tmp_path):
    """Metrics summaries and JSON-lines exports, and log_event records
    through a JSON-lines logger, equal to the JAX package's for the
    same values (the time stamps aside)."""
    rng = np.random.default_rng(0)
    vals = rng.standard_normal(6)
    jm, tm = jlog.Metrics(), tlog.Metrics()
    for i, v in enumerate(vals):
        jm.log("loss", v, step=2 * i)
        tm.log("loss", torch.tensor(v), step=2 * i)
        jm.log("t", np.float32(v))
        tm.log("t", np.float32(v))
    assert tm.summary() == jm.summary()
    assert np.array_equal(tm["loss"], jm["loss"])
    fj, ft = str(tmp_path / "j.jsonl"), str(tmp_path / "t.jsonl")
    jm.to_jsonl(fj)
    tm.to_jsonl(ft)
    assert open(fj).read() == open(ft).read()
    recs = []
    for mod, name in ((jlog, "jaxlog"), (tlog, "torchlog")):
        path = str(tmp_path / f"{name}.jsonl")
        logger = mod.get_logger(name, jsonl_path=path)
        assert mod.get_logger(name, jsonl_path=path) is logger
        mod.log_event("step", logger=logger, loss=np.float64(1.25),
                      x=torch.tensor(2.5) if mod is tlog else 2.5,
                      n=3, tag="a")
        for h in logger.handlers:
            h.flush()
        lines = [json.loads(ln) for ln in open(path)]
        for rec in lines:
            rec.pop("t")
        recs.append(lines)
        for h in list(logger.handlers):
            logger.removeHandler(h)
            h.close()
    assert recs[0] == recs[1] == [{"event": "step", "loss": 1.25, "x": 2.5,
                                   "n": 3, "tag": "a"}]


def test_trainer_reporting_vs_jax(tmp_path, target, capsys):
    """Nreport through a logger (events), through verbose prints and
    through train(Nreport=); metrics per epoch: the same epochs and
    losses as the JAX Trainer's (Adam at lr 1e-2 in both)."""
    out = {}
    for pkg, mod, Trainer in (("jax", jlog, JTrainer),
                              ("torch", tlog, bt.Trainer)):
        path = str(tmp_path / f"{pkg}.jsonl")
        logger = mod.get_logger(f"trainer_{pkg}", jsonl_path=path)
        metrics = mod.Metrics()
        tr = Trainer(_prob(target, pkg), Nreport=2, metrics=metrics,
                     logger=logger)
        tr.train(5)
        for h in list(logger.handlers):
            h.flush()
            logger.removeHandler(h)
            h.close()
        events = [json.loads(ln) for ln in open(path)]
        tr2 = Trainer(_prob(target, pkg), verbose=True)
        capsys.readouterr()
        tr2.train(3, Nreport=1)
        printed = capsys.readouterr().out.splitlines()
        out[pkg] = (events, metrics, printed, tr.loss_history)
    (je, jm, jp, jl), (te, tm, tp, tl) = out["jax"], out["torch"]
    assert [e["epoch"] for e in te] == [e["epoch"] for e in je] == [0, 2, 4]
    np.testing.assert_allclose([e["loss"] for e in te],
                               [e["loss"] for e in je], rtol=1e-9)
    np.testing.assert_allclose(tl, jl, rtol=1e-9)
    assert tm.series["loss"]["steps"] == jm.series["loss"]["steps"]
    np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=1e-9)
    assert len(tm["epoch_time"]) == 5
    assert [ln.split("|")[:2] for ln in tp] == [ln.split("|")[:2]
                                                for ln in jp]
    quiet = bt.Trainer(_prob(target), Nreport=1, verbose=False)
    quiet.train(1)
    assert capsys.readouterr().out == ""


def test_trace_profile_memory_stats_and_log(tmp_path, target, capsys):
    """trace_profile writes a Chrome trace of the block (a Trainer's
    profile_dir too), and nothing when disabled; device_memory_stats is
    empty without a card; log prints as the JAX log does."""
    d = str(tmp_path / "prof")
    with tlog.trace_profile(d):
        torch.ones(4).sum()
    assert json.load(open(os.path.join(d, "trace.json")))
    with tlog.trace_profile(str(tmp_path / "off"), enabled=False):
        pass
    assert not os.path.exists(str(tmp_path / "off"))
    pd = str(tmp_path / "trainer")
    bt.Trainer(_prob(target), profile_dir=pd, verbose=False).train(1)
    assert os.path.exists(os.path.join(pd, "trace.json"))
    if not torch.cuda.is_available():
        assert tlog.device_memory_stats() == {}
    capsys.readouterr()
    for style in (1, 2, 3):
        printed = []
        for mod in (jlog, tlog):
            mod.log("hello", verbose=True, style=style)
            mod.log("quiet", verbose=False, style=style)
            printed.append(capsys.readouterr().out)
        assert printed[0] == printed[1] and "hello" in printed[1]
        assert "quiet" not in printed[1]
    assert isinstance(tlog.get_logger(), pylogging.Logger)
