"""
Model persistence and construction from configs.

Counterpart of bayeslim_tpu/data/io.py (get_model_description :34,
write_pkl :54, read_pkl :67, load_yaml :90, build_telescope :95,
build_array :103, build_sky :119, build_beam :163, build_rime :186,
build_calibration :269, build_sequential :290, build_prob :304). The
builders take kwargs, YAML-loaded dicts or pickle paths and return
ready model blocks, up to a LogProb; each takes device (None: CUDA) and
dtype (None: the default real dtype) and passes them on.

Pickles: write_pkl saves a port model (or any object) with torch.save
and read_pkl loads it with map_location onto device, so a model saved
on the card reads back on the CPU and the other way round. A JAX
package pickle holds a JAX tree definition and cannot be read without
JAX. yaml is imported in load_yaml; h5py in the HDF5 reads that
build_prob makes.
"""
from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

from ..utils.dtypes import resolve_device
from ..utils.indexing import AntposDict
from ..utils.module import Module, Sequential
from ..utils.paramdict import read_pdict
from .containers import load_data
from .dataset import Dataset

__all__ = [
    "get_model_description", "write_pkl", "read_pkl", "load_yaml",
    "build_sky", "build_beam", "build_telescope", "build_array",
    "build_rime", "build_calibration", "build_sequential", "build_prob",
]


def get_model_description(model, depth=0):
    """(the model tree as indented lines, a nested dict of its
    submodules by attribute name)."""
    name = getattr(model, "name", model.__class__.__name__)
    lines = ["  " * depth + f"{model.__class__.__name__}(name={name})"]
    args = {name: {}}
    for k, v in sorted(model._modules.items()):
        if isinstance(v, Module):
            sub_lines, sub_args = get_model_description(v, depth + 1)
            lines.append(sub_lines)
            args[name][k] = sub_args
        elif isinstance(v, nn.ModuleDict) and len(v) and \
                all(isinstance(x, Module) for x in v.values()):
            for dk, x in v.items():
                sub_lines, sub_args = get_model_description(x, depth + 1)
                lines.append(sub_lines)
                args[name][f"{k}.{dk}"] = sub_args
    return "\n".join(lines), args


def write_pkl(fname, model, overwrite=False):
    """Save a model (or any object) with torch.save; an existing file is
    kept unless overwrite."""
    if os.path.exists(fname) and not overwrite:
        print(f"{fname} exists, not overwriting")
        return
    torch.save(model, fname)


def _pdict(pdict, device):
    return read_pdict(pdict, device=device) if isinstance(pdict, str) \
        else pdict


def read_pkl(fname, pdict=None, device=None):
    """A model saved by write_pkl, its tensors on device (None: CUDA),
    or a model object moved there (Module.push); pdict (a ParamDict or
    its pickle) is then written into it (Module.update)."""
    dev = resolve_device(device)
    if isinstance(fname, str):
        model = torch.load(fname, map_location=dev, weights_only=False)
    else:
        model = fname
        if hasattr(model, "push"):
            model.push(dev)
    if pdict is not None:
        model.update(_pdict(pdict, dev))
    return model


def load_yaml(yfile):
    import yaml
    with open(yfile) as f:
        return yaml.load(f, Loader=yaml.FullLoader)


def build_telescope(modfile=None, location=None, device=None, dtype=None,
                    **kwargs):
    """TelescopeModel from a pickle or kwargs."""
    from ..models.telescope import TelescopeModel
    if isinstance(modfile, str):
        return read_pkl(modfile, device=device)
    return TelescopeModel(tuple(location), **kwargs)


def build_array(modfile=None, antpos=None, ants=None, antvecs=None,
                freqs=None, device=None, dtype=None, **kwargs):
    """ArrayModel from a pickle, an antpos dict (or its pickle), or
    (ants, antvecs)."""
    from ..models.telescope import ArrayModel
    if isinstance(modfile, str):
        return read_pkl(modfile, device=device)
    if antpos is None:
        antpos = AntposDict(ants, np.asarray(antvecs))
    elif isinstance(antpos, str):
        antpos = read_pkl(antpos, device=device)
    elif isinstance(antpos, dict):
        antpos = AntposDict(list(antpos.keys()),
                            np.stack([np.asarray(v) for v in antpos.values()]))
    return ArrayModel(antpos, freqs=freqs, device=device, dtype=dtype,
                      **kwargs)


def build_sky(multi=None, modfile=None, pdict=None, catfile=None,
              freqs=None, freq_interp="linear", parameter=True,
              set_param=None, unset_param=None, comp_kwargs=None,
              device=None, dtype=None, **kwargs):
    """Sky model from a pickle (modfile), a YAML point-source catalogue
    (catfile: a PointSky with its PointSkyResponse), or several such
    build dicts (multi: a list of (name, kwargs) pairs or a {name:
    kwargs} dict) composed into a CompositeModel(**comp_kwargs). pdict
    (a ParamDict or its pickle) updates the model; set_param /
    unset_param make an attribute trainable or not."""
    from ..models.sky import (CompositeModel, PointSky, PointSkyResponse,
                              read_catalogue)
    if multi is not None:
        items = multi.items() if isinstance(multi, dict) else list(multi)
        models = {name: build_sky(**dict(dict(device=device, dtype=dtype),
                                         **kw))
                  for name, kw in items}
        return CompositeModel(models, **(comp_kwargs or {}))
    if isinstance(modfile, str):
        model = read_pkl(modfile, pdict=pdict, device=device)
    elif catfile is not None:
        params, angs, meta = read_catalogue(catfile, freqs=freqs,
                                            freq_interp=freq_interp,
                                            device=device, dtype=dtype)
        if freqs is None:
            freqs = meta.get("freqs")
        if freqs is None:
            raise ValueError("a catalogue sky needs freqs")
        R = PointSkyResponse(freqs, freq_mode=meta["freq_mode"],
                             f0=meta.get("f0"), device=device, dtype=dtype)
        model = PointSky(params, angs, R=R, parameter=parameter,
                         name=kwargs.get("name"), device=device, dtype=dtype)
        if pdict is not None:
            model.update(_pdict(pdict, resolve_device(device)))
    else:
        raise ValueError("need multi, modfile or catfile")
    if set_param is not None and hasattr(model, set_param):
        model.set_param(set_param)
    if unset_param is not None and hasattr(model, unset_param):
        model.unset_param(unset_param)
    return model


def build_beam(modfile=None, pdict=None, kind="gauss", params=None,
               freqs=None, parameter=True, device=None, dtype=None,
               **kwargs):
    """PixelBeam from a pickle or kwargs: kind 'gauss', 'airy',
    'uniform', 'pixel' or 'ylm' picks the response (its kwargs in
    response_kwargs)."""
    from ..models.beam import (AiryResponse, GaussResponse, PixelBeam,
                               PixelResponse, UniformResponse)
    if isinstance(modfile, str):
        return read_pkl(modfile, pdict=pdict, device=device)
    resp = {"gauss": GaussResponse, "airy": AiryResponse,
            "uniform": UniformResponse}
    rkw = kwargs.pop("response_kwargs", {})
    if kind in resp:
        R = resp[kind](**rkw)
    elif kind == "pixel":
        R = PixelResponse(freqs, **rkw)
    elif kind == "ylm":
        from ..models.beam_ylm import YlmResponse
        R = YlmResponse(freqs=freqs, **dict(dict(device=device, dtype=dtype),
                                            **rkw))
    else:
        raise ValueError(f"unknown beam kind {kind}")
    return PixelBeam(params, freqs, R=R, parameter=parameter, device=device,
                     dtype=dtype, **kwargs)


def _build(builder, spec, device, dtype):
    """A block from a build dict or a pickle path; a built block passes
    through."""
    if isinstance(spec, str):
        spec = dict(modfile=spec)
    if isinstance(spec, dict):
        return builder(**dict(dict(device=device, dtype=dtype), **spec))
    return spec


def build_rime(modfile=None, sky=None, telescope=None, beam=None,
               array=None, sim_bls=None, times=None, freqs=None,
               time_batch=None, indexed_batching=False, redundant=False,
               device=None, dtype=None, **kwargs):
    """RIME from a pickle, or from its blocks (each a built model, a
    build dict or a pickle path). times, freqs, sim_bls and data_bls may
    be arrays or pickle paths; sim_bls and data_bls also a dict of
    ArrayModel.get_bls kwargs; sim_bls may be a list of baseline groups.
    time_batch splits the times into groups of that size (minibatches).
    redundant simulates one baseline a redundant group and expands to
    sim_bls. pdict (a ParamDict or its pickle) updates the model.

    indexed_batching chooses the JAX package's single compiled
    executable over batches; eager PyTorch has no counterpart, so it is
    accepted and the ordinary batching runs (the same visibilities).
    """
    from ..models.rime import RIME
    pdict = kwargs.pop("pdict", None)
    dev = resolve_device(device)
    if isinstance(modfile, str):
        return read_pkl(modfile, pdict=pdict, device=dev)
    sky = _build(build_sky, sky, device, dtype)
    telescope = _build(build_telescope, telescope, device, dtype)
    beam = _build(build_beam, beam, device, dtype)
    array = _build(build_array, array, device, dtype)
    if isinstance(times, str):
        times = read_pkl(times, device=dev)
    if isinstance(freqs, str):
        freqs = read_pkl(freqs, device=dev)
    if isinstance(sim_bls, str):
        sim_bls = read_pkl(sim_bls, device=dev)
    elif isinstance(sim_bls, dict):
        sim_bls = array.get_bls(**sim_bls)
    data_bls = kwargs.pop("data_bls", None)
    if isinstance(data_bls, str):
        data_bls = read_pkl(data_bls, device=dev)
    elif isinstance(data_bls, dict):
        data_bls = array.get_bls(**data_bls)
    if data_bls is not None:
        data_bls = [tuple(int(a) for a in bl) for bl in data_bls]
    grouped = (len(sim_bls) > 0 and not isinstance(sim_bls[0], tuple)
               and np.ndim(sim_bls[0]) > 1)
    if grouped:
        sim_bls = [[tuple(int(a) for a in bl) for bl in grp]
                   for grp in sim_bls]
    else:
        sim_bls = [tuple(int(a) for a in bl) for bl in sim_bls]
    if redundant and data_bls is None and not grouped:
        gids = sorted({array.bl2red[bl] for bl in sim_bls})
        data_bls = sim_bls
        sim_bls = [array.reds[g][0] for g in gids]
    times = np.asarray(times)
    if time_batch:
        tb = int(time_batch)
        if len(times) % tb:
            raise ValueError("time_batch must divide Ntimes for uniform "
                             "groups")
        times = [times[i:i + tb] for i in range(0, len(times), tb)]
    rime = RIME(sky, telescope, beam, array, sim_bls, times,
                np.asarray(freqs), data_bls=data_bls, **kwargs)
    if pdict is not None:
        rime.update(_pdict(pdict, dev))
    return rime


def build_calibration(modfile=None, pdict=None, kind="jones", params=None,
                      ants=None, device=None, dtype=None, **kwargs):
    """JonesModel (kind 'jones'), VisModel ('vis') or RedVisModel
    ('redvis') from a pickle or kwargs."""
    from ..models.calibration import JonesModel, RedVisModel, VisModel
    if isinstance(modfile, str):
        return read_pkl(modfile, pdict=pdict, device=device)
    if kind == "jones":
        return JonesModel(params, ants, device=device, dtype=dtype,
                          **kwargs)
    if kind == "vis":
        return VisModel(params, device=device, dtype=dtype, **kwargs)
    if kind == "redvis":
        return RedVisModel(params, device=device, dtype=dtype, **kwargs)
    raise ValueError(f"unknown calibration kind {kind}")


_BUILDERS = {"sky": build_sky, "beam": build_beam,
             "telescope": build_telescope, "array": build_array,
             "rime": build_rime, "calibration": build_calibration}


def build_sequential(modfile=None, order=None, kind=None, mdict=None,
                     device=None, dtype=None):
    """Sequential chain of blocks: order names them, kind gives each
    one's builder ('sky', 'beam', 'telescope', 'array', 'rime',
    'calibration' or 'sequential'), mdict each one's build dict."""
    if isinstance(modfile, str):
        return read_pkl(modfile, device=device)
    models = {}
    for mod, k in zip(order, kind):
        builder = build_sequential if k == "sequential" else _BUILDERS[k]
        models[mod] = builder(**dict(dict(device=device, dtype=dtype),
                                     **mdict[mod]))
    return Sequential(models)


def build_prob(modfile=None, seq_dict=None, data=None, start_inp=None,
               prior_dict=None, compute="post", negate=True,
               reduce_by_redundancy=False, redtol=1.0, device=None,
               dtype=None, **kwargs):
    """LogProb from a config: the model from seq_dict (build_sequential),
    the target from data (an HDF5 path, a list of them, or containers;
    load_data onto device), start_inp and prior_dict as objects or
    pickle paths. reduce_by_redundancy reduces each target to its
    redundant groups' sufficient statistics (exact gradients at a
    fraction of the cost); the chi^2 constants dropped are summed into
    the returned prob's chisq_const."""
    from ..inference.prob import LogProb
    dev = resolve_device(device)
    if isinstance(modfile, str):
        return read_pkl(modfile, device=dev)
    model = build_sequential(**dict(dict(device=device, dtype=dtype),
                                    **seq_dict))
    targets = load_data(data, device=dev)
    targets = targets if isinstance(targets, list) else [targets]
    chisq_const = 0.0
    if reduce_by_redundancy:
        reduced = []
        for t in targets:
            t, c = t.reduce_by_redundancy(redtol=redtol)
            chisq_const += c
            reduced.append(t)
        targets = reduced
    target = Dataset(targets if len(targets) > 1 else targets[0],
                     device=dev)
    if isinstance(start_inp, str):
        start_inp = read_pkl(start_inp, device=dev)
    if isinstance(prior_dict, str):
        prior_dict = read_pkl(prior_dict, device=dev)
    prob = LogProb(model, target, start_inp=start_inp,
                   prior_dict=prior_dict, compute=compute, negate=negate,
                   **kwargs)
    prob.chisq_const = chisq_const
    return prob
