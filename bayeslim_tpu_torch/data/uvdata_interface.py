"""
UVH5 and calfits files <-> VisData / CalData, and simulations driven by
an observation template.

Counterpart of bayeslim_tpu/data/uvdata_interface.py (read_uvh5 :52,
_pol_slots :136, write_uvh5 :148, write_uvh5_part :248,
_read_fits_hdus :294, read_calfits :360, _fits_card /
_fits_header_block :443-458, write_calfits :465, PyVisData :591,
parse_time_params / parse_freq_params :641-674, _select_bls :677,
setup_uvdata :706, complete_uvdata :773, run_rime_sim :803,
uvd_to_visdata :837, get_params_from_uvdata :842). UVH5 is plain HDF5,
read and written with h5py; calfits is read and written by a pure-numpy
FITS parser. h5py and pyuvdata are imported in the functions that use
them: the module imports without either, and a call that needs one
raises ImportError naming it. pyuvdata is optional, as in the JAX
package: only complete_uvdata, get_params_from_uvdata and a UVData
object need it.

write_calfits refuses a CalData whose off-diagonal Jones terms are
nonzero (the calfits layout holds per-feed gains); the JAX function
writes only the diagonal and drops them without a word.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .containers import CalData, VisData, _host
from ..utils.dtypes import _float, resolve_device
from ..utils.indexing import AntposDict

__all__ = ["has_pyuvdata", "PyVisData", "read_uvh5", "write_uvh5",
           "write_uvh5_part", "read_calfits", "write_calfits",
           "run_rime_sim", "setup_uvdata", "complete_uvdata",
           "parse_time_params", "parse_freq_params", "uvd_to_visdata",
           "get_params_from_uvdata"]


def has_pyuvdata():
    """Whether pyuvdata can be imported."""
    try:
        import pyuvdata  # noqa: F401
    except ImportError:
        return False
    return True


def _require_pyuvdata():
    if not has_pyuvdata():
        raise ImportError(
            "pyuvdata is required for the uvdata interface "
            "(pip install pyuvdata); it is an optional dependency.")


def _complex_of(dtype):
    return torch.complex128 if dtype == torch.float64 else torch.complex64


def _ecef_to_enu_matrix(lat_deg, lon_deg):
    """Rotation taking ECEF vectors (relative to the telescope) to local
    East-North-Up at geodetic (lat, lon)."""
    phi, lam = np.radians(lat_deg), np.radians(lon_deg)
    sphi, cphi = np.sin(phi), np.cos(phi)
    slam, clam = np.sin(lam), np.cos(lam)
    return np.array([[-slam, clam, 0.0],
                     [-sphi * clam, -sphi * slam, cphi],
                     [cphi * clam, cphi * slam, sphi]])


# AIPS polarization codes -> feed pairs; feeds map to 'e' / 'n' by the
# file's x_orientation ('east': x -> e, otherwise x -> n)
_AIPS_POL_FEEDS = {-5: "xx", -6: "yy", -7: "xy", -8: "yx"}


def _feed_map(x_orient):
    return ({"x": "e", "y": "n"} if x_orient.lower().startswith("e")
            else {"x": "n", "y": "e"})


def read_uvh5(fname, run_check=True, device=None, dtype=None):
    """Read a UVH5 file into a VisData with h5py (no pyuvdata).

    Baselines are the unique (ant1, ant2) pairs in sorted order; the
    data land in the (Npol, Npol, Nbls, Ntimes, Nfreqs) layout (1 pol,
    or 2 x 2 with data[0, 0] = 'ee' and data[1, 1] = 'nn' through the
    file's x_orientation), slots the file lacks flagged; antenna
    positions are converted ECEF -> ENU; the telescope location is
    (lon, lat, alt) [deg, m]. The data are complex of dtype (default
    the default real dtype) on device (None: CUDA); flags stay on the
    host.
    """
    import h5py
    from ..models.telescope import TelescopeModel

    with h5py.File(fname, "r") as f:
        h = f["Header"]
        lat = float(h["latitude"][()])
        lon = float(h["longitude"][()])
        alt = float(h["altitude"][()])
        ant1 = np.asarray(h["ant_1_array"])
        ant2 = np.asarray(h["ant_2_array"])
        time_array = np.asarray(h["time_array"], dtype=np.float64)
        freqs = np.asarray(h["freq_array"], dtype=np.float64).ravel()
        pol_array = np.asarray(h["polarization_array"]).astype(int)
        ant_nums = np.asarray(h["antenna_numbers"]).astype(int)
        ant_pos_ecef = np.asarray(h["antenna_positions"], dtype=np.float64)
        x_orient = h["x_orientation"][()] if "x_orientation" in h \
            else b"north"
        if isinstance(x_orient, bytes):
            x_orient = x_orient.decode()
        history = h["history"][()] if "history" in h else b""
        if isinstance(history, bytes):
            history = history.decode(errors="replace")
        vis = np.asarray(f["Data"]["visdata"])
        flg = np.asarray(f["Data"]["flags"])

    # old-style files carry a singleton spw axis: (Nblts, 1, Nfreqs, Npols)
    if vis.ndim == 4:
        vis = vis[:, 0]
        flg = flg[:, 0]
    times, t_inv = np.unique(time_array, return_inverse=True)
    blnum = ant1.astype(np.int64) * 100000 + ant2.astype(np.int64)
    ubl, bl_inv = np.unique(blnum, return_inverse=True)
    bls = [(int(b // 100000), int(b % 100000)) for b in ubl]
    Nbls, Ntimes, Nfreqs = len(bls), len(times), len(freqs)
    feed_map = _feed_map(x_orient)
    grid = {"e": 0, "n": 1}
    pols = ["".join(feed_map[c] for c in _AIPS_POL_FEEDS[p])
            for p in pol_array]
    Npol = 1 if len(pols) == 1 else 2
    data = np.zeros((Npol, Npol, Nbls, Ntimes, Nfreqs), dtype=vis.dtype)
    flags = np.ones((Npol, Npol, Nbls, Ntimes, Nfreqs), dtype=bool)
    for k, pname in enumerate(pols):
        i, j = (0, 0) if Npol == 1 else (grid[pname[0]], grid[pname[1]])
        data[i, j, bl_inv, t_inv] = vis[:, :, k]
        flags[i, j, bl_inv, t_inv] = flg[:, :, k]
    enu = ant_pos_ecef @ _ecef_to_enu_matrix(lat, lon).T
    antpos = AntposDict([int(a) for a in ant_nums], enu)

    obj = PyVisData()
    obj.setup_meta(telescope=TelescopeModel((lon, lat, alt)), antpos=antpos)
    obj.setup_data(bls, times, freqs, pol=pols[0] if Npol == 1 else None,
                   data=torch.as_tensor(data, device=resolve_device(device))
                   .to(_complex_of(dtype or _float())),
                   flags=flags, history=history)
    if run_check:
        obj.check()
    return obj


def _pol_slots(vd):
    """(AIPS polarization codes, (i, j) data slots) of a VisData's
    polarization layout under x_orientation 'east'."""
    if vd.data.shape[0] == 1:
        pol = (vd.pol or "ee").lower()
        code = {"ee": -5, "nn": -6, "en": -7, "ne": -8}[pol]
        return [code], [(0, 0)]
    return [-5, -6, -7, -8], [(0, 0), (1, 1), (0, 1), (1, 0)]


def write_uvh5(vd, fname, overwrite=False):
    """Write a VisData as a UVH5 file with h5py (no pyuvdata): time-major
    baseline-time rows, x_orientation 'east', phase_type 'drift',
    antenna positions ENU -> ECEF (read_uvh5's inverse), complex64
    visibilities. Returns fname."""
    import h5py
    from ..models.telescope import JD2LST

    if os.path.exists(fname) and not overwrite:
        raise FileExistsError(f"{fname} exists; pass overwrite=True")
    data = _host(vd.data)
    flags = None if vd.flags is None else _host(vd.flags)
    bls = list(vd.bls)
    times = np.asarray(vd.times, dtype=np.float64)
    freqs = np.asarray(vd.freqs, dtype=np.float64)
    nbl, nt, nf = len(bls), len(times), len(freqs)
    pol_codes, slots = _pol_slots(vd)
    lon, lat, alt = (float(x) for x in vd.telescope.location[:3])
    ants = [int(a) for a in vd.antpos.ants]
    enu = vd.antpos.asnumpy().astype(np.float64)
    ecef = enu @ _ecef_to_enu_matrix(lat, lon)
    ant1 = np.tile(np.asarray([b[0] for b in bls], np.int64), nt)
    ant2 = np.tile(np.asarray([b[1] for b in bls], np.int64), nt)
    time_array = np.repeat(times, nbl)
    a2i = {a: i for i, a in enumerate(ants)}
    uvw = np.tile(np.asarray(
        [enu[a2i[b[1]]] - enu[a2i[b[0]]] for b in bls]), (nt, 1))
    tint = float(np.median(np.diff(np.sort(times)))) * 86400.0 \
        if nt > 1 else 1.0
    df = float(freqs[1] - freqs[0]) if nf > 1 else 1.0
    vis = np.zeros((nbl * nt, nf, len(pol_codes)), np.complex64)
    flg = np.ones((nbl * nt, nf, len(pol_codes)), bool)
    for k, (i, j) in enumerate(slots):
        vis[:, :, k] = np.moveaxis(data[i, j], 1, 0).reshape(nbl * nt, nf)
        flg[:, :, k] = False if flags is None else \
            np.moveaxis(flags[i, j], 1, 0).reshape(nbl * nt, nf)
    with h5py.File(fname, "w") as f:
        h = f.create_group("Header")
        h["latitude"] = lat
        h["longitude"] = lon
        h["altitude"] = alt
        h["telescope_name"] = np.bytes_(
            getattr(vd.telescope, "name", None) or "bayeslim_tpu")
        h["instrument"] = h["telescope_name"][()]
        h["object_name"] = np.bytes_("zenith")
        h["history"] = np.bytes_(vd.history or "written by "
                                 "bayeslim_tpu_torch.write_uvh5")
        h["phase_type"] = np.bytes_("drift")
        h["version"] = np.bytes_("1.0")
        h["x_orientation"] = np.bytes_("east")
        h["Nants_data"] = len(set(ant1) | set(ant2))
        h["Nants_telescope"] = len(ants)
        h["antenna_names"] = np.asarray([np.bytes_(str(a)) for a in ants])
        h["antenna_numbers"] = np.asarray(ants, np.int64)
        h["antenna_positions"] = ecef
        h["Nbls"] = nbl
        h["Nblts"] = nbl * nt
        h["Nfreqs"] = nf
        h["Npols"] = len(pol_codes)
        h["Nspws"] = 1
        h["Ntimes"] = nt
        h["freq_array"] = freqs
        h["channel_width"] = df
        h["polarization_array"] = np.asarray(pol_codes, np.int64)
        h["spw_array"] = np.asarray([0], np.int64)
        h["ant_1_array"] = ant1
        h["ant_2_array"] = ant2
        h["time_array"] = time_array
        h["lst_array"] = np.asarray(JD2LST(time_array, lon), dtype=np.float64)
        h["integration_time"] = np.full(nbl * nt, tint)
        h["uvw_array"] = uvw
        d = f.create_group("Data")
        d.create_dataset("visdata", data=vis)
        d.create_dataset("flags", data=flg)
        d.create_dataset("nsamples", data=np.ones(vis.shape, np.float32))
    return fname


def write_uvh5_part(fname, vd, atol=1e-8):
    """Write a VisData's (baseline, time, freq) block into an existing
    UVH5 file: rows matched by (ant1, ant2, time), frequency columns by
    value; every (bl, time, freq) of vd must be in the file. Returns
    fname."""
    import h5py

    data = _host(vd.data)
    flags = None if vd.flags is None else _host(vd.flags)
    pol_codes, slots = _pol_slots(vd)
    with h5py.File(fname, "r+") as f:
        h = f["Header"]
        fa1 = np.asarray(h["ant_1_array"]).astype(np.int64)
        fa2 = np.asarray(h["ant_2_array"]).astype(np.int64)
        ftime = np.asarray(h["time_array"], np.float64)
        ffreq = np.asarray(h["freq_array"], np.float64).ravel()
        fpols = list(np.asarray(h["polarization_array"]).astype(int))
        key = {(int(a1), int(a2), round(float(t) / atol)): r
               for r, (a1, a2, t) in enumerate(zip(fa1, fa2, ftime))}
        fidx = []
        for fq in np.asarray(vd.freqs, np.float64):
            j = int(np.argmin(np.abs(ffreq - fq)))
            if not abs(ffreq[j] - fq) < max(atol, 1e-3):
                raise ValueError(f"frequency {fq} not in file")
            fidx.append(j)
        contig = fidx == list(range(fidx[0], fidx[0] + len(fidx)))
        fsel = slice(fidx[0], fidx[0] + len(fidx)) if contig else fidx
        vis_ds = f["Data"]["visdata"]
        flg_ds = f["Data"]["flags"]
        for k, (i, j) in enumerate(slots):
            kf = fpols.index(pol_codes[k])
            for ti, t in enumerate(np.asarray(vd.times, np.float64)):
                for bi, bl in enumerate(vd.bls):
                    r = key.get((int(bl[0]), int(bl[1]),
                                 round(float(t) / atol)))
                    if r is None:
                        raise ValueError(f"(bl, time) {(bl, t)} not in "
                                         f"file")
                    vis_ds[r, fsel, kf] = data[i, j, bi, ti].astype(
                        vis_ds.dtype)
                    if flags is not None:
                        flg_ds[r, fsel, kf] = flags[i, j, bi, ti]
    return fname


def _read_fits_hdus(fname):
    """Minimal FITS reader (pure numpy): a list of (header dict, data)
    for a primary image HDU (big-endian, NAXISn reversed to C order) and
    BINTABLE extensions (TFORMn codes A / D / E / J / K / I with repeat
    counts)."""
    hdus = []
    with open(fname, "rb") as f:
        raw = f.read()
    pos = 0
    while pos < len(raw):
        cards = {}
        end = False
        while not end:
            block = raw[pos:pos + 2880]
            if len(block) < 2880:
                return hdus
            pos += 2880
            for i in range(0, 2880, 80):
                card = block[i:i + 80].decode("ascii", errors="replace")
                key = card[:8].strip()
                if key == "END":
                    end = True
                    break
                if "=" in card[:10]:
                    val = card[10:].split("/")[0].strip()
                    cards[key] = val.strip("' ").strip()
        naxis = int(cards.get("NAXIS", 0))
        shape = [int(cards[f"NAXIS{i}"]) for i in range(naxis, 0, -1)]
        n = int(np.prod(shape)) if shape else 0
        n += int(cards.get("PCOUNT", 0))
        bitpix = int(cards.get("BITPIX", 8))
        nbytes = n * (abs(bitpix) // 8)
        data_raw = raw[pos:pos + nbytes]
        pos += ((nbytes + 2879) // 2880) * 2880
        if cards.get("XTENSION", "").startswith("BINTABLE") and naxis:
            fmap = {"D": ">f8", "E": ">f4", "J": ">i4", "K": ">i8",
                    "I": ">i2"}
            names, formats = [], []
            for i in range(1, int(cards["TFIELDS"]) + 1):
                tform = cards[f"TFORM{i}"]
                rep = int(tform[:-1]) if tform[:-1] else 1
                code = tform[-1]
                names.append(cards.get(f"TTYPE{i}", f"col{i}").strip())
                if code == "A":
                    formats.append(f"S{rep}")
                else:
                    formats.append((fmap[code], (rep,)) if rep > 1
                                   else fmap[code])
            dt = np.dtype({"names": names, "formats": formats})
            data = np.frombuffer(data_raw, dtype=dt,
                                 count=int(cards["NAXIS2"]))
        elif naxis:
            dtmap = {8: "u1", 16: ">i2", 32: ">i4", -32: ">f4", -64: ">f8"}
            data = np.frombuffer(data_raw, dtype=dtmap[bitpix]).reshape(shape)
        else:
            data = None
        hdus.append((cards, data))
    return hdus


def read_calfits(fname, device=None):
    """Read a gain calfits file into a CalData (pure numpy, no pyuvdata
    or astropy): the primary HDU (Nants, Nspw, Nfreqs, Ntimes, Njones,
    4) float64 of [re, im, flag, quality], the JONES axis as AIPS codes
    (CRVAL2 / CDELT2, XORIENT), the ANTENNAS table's ANTARR and ANTXYZ.
    Gains complex128 on device (None: CUDA), flags on the host."""
    hdus = _read_fits_hdus(fname)
    hdr, arr = hdus[0]
    if not hdr.get("CALTYPE", "gain").startswith("gain"):
        raise ValueError("only gain-type calfits supported")
    ants_tab = None
    for cards, data in hdus[1:]:
        if cards.get("EXTNAME", "").startswith("ANTENNAS"):
            ants_tab = data
    if ants_tab is None:
        raise ValueError("no ANTENNAS extension")
    na, nspw, nf, nt, nj, _ = arr.shape
    arr = np.asarray(arr, dtype=np.float64)[:, 0]
    gains = arr[..., 0] + 1j * arr[..., 1]
    flags = arr[..., 2] > 0

    def axis_grid(ax, n):
        crval = float(hdr[f"CRVAL{ax}"])
        cdelt = float(hdr.get(f"CDELT{ax}", 1.0))
        crpix = float(hdr.get(f"CRPIX{ax}", 1.0))
        return crval + (np.arange(1, n + 1) - crpix) * cdelt

    freqs = axis_grid(4, nf)
    times = axis_grid(3, nt)
    jones = axis_grid(2, nj).astype(int)
    feed_map = _feed_map(hdr.get("XORIENT", "north"))
    grid = {"e": 0, "n": 1}
    pols = ["".join(feed_map[c] for c in _AIPS_POL_FEEDS[j]) for j in jones]
    ant_nums = np.asarray(ants_tab["ANTARR"], dtype=np.float64).astype(int)
    keep = ant_nums >= 0
    ant_nums = ant_nums[keep]
    gains = gains[keep]
    flags = flags[keep]
    npol = 1 if len(pols) == 1 else 2
    data = np.zeros((npol, npol, len(ant_nums), nt, nf), dtype=complex)
    fl = np.zeros((npol, npol, len(ant_nums), nt, nf), dtype=bool)
    for k, pname in enumerate(pols):
        if pname[0] != pname[1]:
            raise ValueError("calfits gains are per feed (diagonal)")
        i = 0 if npol == 1 else grid[pname[0]]
        data[i, i] = np.moveaxis(gains[..., k], 1, 2)
        fl[i, i] = np.moveaxis(flags[..., k], 1, 2)
    cd = CalData()
    telescope = None
    if "LON" in hdr and "LAT" in hdr:
        from ..models.telescope import TelescopeModel
        telescope = TelescopeModel((float(hdr["LON"]), float(hdr["LAT"]),
                                    float(hdr.get("ALT", 0.0))))
    antpos = None
    if "ANTXYZ" in (ants_tab.dtype.names or ()):
        xyz = np.asarray(ants_tab["ANTXYZ"], dtype=np.float64)[keep]
        antpos = AntposDict([int(a) for a in ant_nums], xyz)
    cd.setup_meta(telescope=telescope, antpos=antpos)
    cd.setup_data([int(a) for a in ant_nums], times, freqs,
                  pol=pols[0] if npol == 1 else None,
                  data=torch.as_tensor(data, device=resolve_device(device)),
                  flags=fl, history=f"read_calfits({fname})")
    return cd


def _fits_card(key, val):
    """One 80-character FITS header card (fixed format where it fits)."""
    k = f"{key:<8}"
    if isinstance(val, (bool, np.bool_)):
        v = f"{'T' if val else 'F':>20}"
    elif isinstance(val, (int, np.integer)):
        v = f"{val:>20d}"
    elif isinstance(val, (float, np.floating)):
        v = f"{f'{float(val):.17g}':>20}"
    else:
        v = f"'{str(val):<8}'"
    return f"{k}= {v}"[:80].ljust(80)


def _fits_header_block(cards):
    """Cards and END as space-padded 2880-byte blocks."""
    hdr = "".join(cards) + "END".ljust(80)
    return (hdr + " " * ((-len(hdr)) % 2880)).encode("ascii")


def write_calfits(cd, fname, overwrite=False, x_orient="east",
                  telescope_name="UNKNOWN", quality=None, cal_style="sky",
                  gain_convention="divide"):
    """Write a CalData as a gain calfits file (pure numpy, the JAX
    package's layout): the primary HDU (Nants, 1, Nfreqs, Ntimes,
    Njones, 4) big-endian float64 of [re, im, flag, quality] with the
    WCS cards of a regular time and frequency grid, and an ANTENNAS
    table. read_calfits of either package reads it back bit for bit.

    Raises ValueError on a nonzero off-diagonal Jones term of a 4-pol
    CalData (the layout holds per-feed gains only) and on irregular
    times or frequencies (the WCS cards hold a regular grid). Returns
    fname.
    """
    if os.path.exists(fname) and not overwrite:
        raise FileExistsError(fname)
    na, nt, nf = cd.Nants, cd.Ntimes, cd.Nfreqs
    npol = cd.Npol
    data = _host(cd.data)
    if npol == 2:
        for i, j in ((0, 1), (1, 0)):
            if np.any(data[i, j] != 0):
                raise ValueError(
                    f"write_calfits: the off-diagonal Jones term data[{i}, "
                    f"{j}] is nonzero, and calfits holds per-feed "
                    f"(diagonal) gains only; write HDF5 instead")
    feed_map = ({"e": "x", "n": "y"} if x_orient.lower().startswith("e")
                else {"e": "y", "n": "x"})
    code = {v: k for k, v in _AIPS_POL_FEEDS.items()}
    pols = [cd.pol] if npol == 1 else ["ee", "nn"]
    jones = [code["".join(feed_map[c] for c in p)] for p in pols]
    order = np.argsort(jones)[::-1]
    jones = [jones[i] for i in order]
    flags = (_host(cd.flags) if cd.flags is not None
             else np.zeros(data.shape, bool))
    qual = (np.asarray(quality, dtype=np.float64) if quality is not None
            else np.zeros((npol, npol, na, nt, nf)))
    arr = np.zeros((na, 1, nf, nt, len(jones), 4), dtype=">f8")
    for k, oi in enumerate(order):
        i = 0 if npol == 1 else int(oi)
        g = np.moveaxis(data[i, i], 1, 2)
        arr[:, 0, :, :, k, 0] = g.real
        arr[:, 0, :, :, k, 1] = g.imag
        arr[:, 0, :, :, k, 2] = np.moveaxis(flags[i, i], 1, 2)
        arr[:, 0, :, :, k, 3] = np.moveaxis(qual[i, i], 1, 2)
    times = np.asarray(cd.times, dtype=np.float64)
    freqs = np.asarray(cd.freqs, dtype=np.float64)
    dt = float(times[1] - times[0]) if nt > 1 else 1.0
    df = float(freqs[1] - freqs[0]) if nf > 1 else 1.0
    # a uniform grid's np.diff wobbles by the ulp of the values (JD times
    # ~2.46e6 have an ulp ~5e-10), so the tolerance carries a magnitude
    # term besides the spacing term
    eps = np.finfo(np.float64).eps
    t_atol = abs(dt) * 1e-6 + 8 * eps * float(np.abs(times).max())
    if nt > 1 and not np.allclose(np.diff(times), dt, rtol=0, atol=t_atol):
        raise ValueError("calfits requires uniformly spaced times; got "
                         "irregular spacing (select a regular subset or "
                         "write HDF5 instead)")
    f_atol = abs(df) * 1e-6 + 8 * eps * float(np.abs(freqs).max())
    if nf > 1 and not np.allclose(np.diff(freqs), df, rtol=0, atol=f_atol):
        raise ValueError("calfits requires uniformly spaced freqs; got "
                         "irregular spacing (select a regular subset or "
                         "write HDF5 instead)")
    cards = [_fits_card("SIMPLE", True), _fits_card("BITPIX", -64),
             _fits_card("NAXIS", 6)]
    for i, n in enumerate(arr.shape[::-1]):
        cards.append(_fits_card(f"NAXIS{i + 1}", int(n)))
    cards.append(_fits_card("EXTEND", True))
    cards.append(_fits_card("TELESCOP", telescope_name))
    if cd.telescope is not None:
        lon, lat, alt = (list(cd.telescope.location) + [0.0])[:3]
        cards += [_fits_card("LAT", float(lat)), _fits_card("LON", float(lon)),
                  _fits_card("ALT", float(alt))]
    cards += [_fits_card("GNCONVEN", gain_convention),
              _fits_card("CALTYPE", "gain"),
              _fits_card("CALSTYLE", cal_style),
              _fits_card("INTTIME", dt * 86400.0 if nt > 1 else 10.0),
              _fits_card("CHWIDTH", df),
              _fits_card("XORIENT", x_orient)]
    axes = [("Narrays", "Integer", 1.0, 1.0),
            ("JONES", "Integer", float(jones[0]),
             float(jones[1] - jones[0]) if len(jones) > 1 else -1.0),
            ("TIME", "JD", float(times[0]), dt),
            ("FREQS", "Hz", float(freqs[0]), df),
            ("IF", "Integer", 1.0, 1.0),
            ("ANTAXIS", "Integer", 1.0, -1.0)]
    for i, (ctype, cunit, crval, cdelt) in enumerate(axes):
        cards += [_fits_card(f"CTYPE{i + 1}", ctype),
                  _fits_card(f"CUNIT{i + 1}", cunit),
                  _fits_card(f"CRPIX{i + 1}", 1),
                  _fits_card(f"CRVAL{i + 1}", crval),
                  _fits_card(f"CDELT{i + 1}", cdelt)]
    payload = arr.tobytes()
    blocks = [_fits_header_block(cards), payload,
              b"\0" * ((-len(payload)) % 2880)]
    if cd.antpos is not None:
        ap = cd.antpos
        xyz = ap.asnumpy()[[ap._ant_idx[int(a)] for a in cd.ants]]
    else:
        xyz = np.zeros((na, 3))
    tab = np.zeros(na, dtype=np.dtype({
        "names": ["ANTNAME", "ANTINDEX", "ANTARR", "ANTXYZ"],
        "formats": ["S8", ">f8", ">f8", (">f8", (3,))]}))
    tab["ANTNAME"] = [f"ant{int(a)}".encode() for a in cd.ants]
    tab["ANTINDEX"] = np.arange(na, dtype=np.float64)
    tab["ANTARR"] = np.asarray(cd.ants, dtype=np.float64)
    tab["ANTXYZ"] = xyz
    tcards = [_fits_card("XTENSION", "BINTABLE"), _fits_card("BITPIX", 8),
              _fits_card("NAXIS", 2),
              _fits_card("NAXIS1", tab.dtype.itemsize),
              _fits_card("NAXIS2", na), _fits_card("PCOUNT", 0),
              _fits_card("GCOUNT", 1), _fits_card("TFIELDS", 4),
              _fits_card("TTYPE1", "ANTNAME"), _fits_card("TFORM1", "8A"),
              _fits_card("TTYPE2", "ANTINDEX"), _fits_card("TFORM2", "D"),
              _fits_card("TTYPE3", "ANTARR"), _fits_card("TFORM3", "D"),
              _fits_card("TTYPE4", "ANTXYZ"), _fits_card("TFORM4", "3D"),
              _fits_card("EXTNAME", "ANTENNAS")]
    tpayload = tab.tobytes()
    blocks += [_fits_header_block(tcards), tpayload,
               b"\0" * ((-len(tpayload)) % 2880)]
    with open(fname, "wb") as f:
        f.write(b"".join(blocks))
    return fname


class PyVisData(VisData):
    """A VisData read from a UVH5 file or a pyuvdata.UVData: a path is
    read by read_uvh5 when pyuvdata is absent, a VisData template is
    copied (or selected from)."""

    @classmethod
    def read_uvdata(cls, fname, run_check=True, device=None, **kwargs):
        if isinstance(fname, VisData):
            return fname.copy() if not kwargs else fname.select(
                inplace=False, **kwargs)
        if isinstance(fname, str) and not has_pyuvdata():
            if kwargs:
                raise TypeError(
                    f"pyuvdata selection kwargs {sorted(kwargs)} require "
                    f"pyuvdata; read_uvh5 reads the whole file: use "
                    f"read_uvh5 and VisData.select instead")
            return read_uvh5(fname, run_check=run_check, device=device)
        _require_pyuvdata()
        from pyuvdata import UVData
        from ..models.telescope import TelescopeModel
        uvd = fname
        if isinstance(fname, str):
            uvd = UVData()
            uvd.read(fname, **kwargs)
        obj = cls()
        ants = [int(a) for a in uvd.antenna_numbers]
        enu = uvd.get_ENU_antpos()[0] if hasattr(uvd, "get_ENU_antpos") \
            else uvd.antenna_positions
        loc = uvd.telescope_location_lat_lon_alt_degrees
        obj.setup_meta(telescope=TelescopeModel((loc[1], loc[0], loc[2])),
                       antpos=AntposDict(ants, np.asarray(enu)))
        bls = uvd.get_antpairs()
        times = np.unique(uvd.time_array)
        freqs = np.asarray(uvd.freq_array).ravel()
        data = np.zeros((1, 1, len(bls), len(times), len(freqs)),
                        dtype=complex)
        for i, bl in enumerate(bls):
            data[0, 0, i] = uvd.get_data(bl)
        obj.setup_data(bls, times, freqs, pol="ee",
                       data=torch.as_tensor(data,
                                            device=resolve_device(device)),
                       history=str(getattr(uvd, "history", "")))
        return obj


def parse_time_params(params):
    """A time grid from {time_array} or {Ntimes, start_time [JD],
    time_cadence [s]}."""
    p = dict(params)
    if p.get("time_array") is not None:
        t = np.asarray(p["time_array"], dtype=np.float64)
        return {"time_array": t, "Ntimes": len(t),
                "time_cadence": float(np.median(np.diff(t)) * 86400.0)
                if len(t) > 1 else None}
    n = int(p["Ntimes"])
    t0 = float(p.get("start_time", 2458168.0))
    dt = float(p.get("time_cadence", 10.0)) / 86400.0
    return {"time_array": t0 + np.arange(n) * dt, "Ntimes": n,
            "time_cadence": float(p.get("time_cadence", 10.0))}


def parse_freq_params(params):
    """A frequency grid [Hz] from {freq_array} or {Nfreqs, start_freq,
    channel_width or bandwidth}."""
    p = dict(params)
    if p.get("freq_array") is not None:
        f = np.asarray(p["freq_array"], dtype=np.float64)
        return {"freq_array": f, "Nfreqs": len(f),
                "channel_width": float(np.median(np.diff(f)))
                if len(f) > 1 else None}
    n = int(p["Nfreqs"])
    f0 = float(p.get("start_freq", 100e6))
    df = float(p["channel_width"]) if p.get("channel_width") is not None \
        else float(p.get("bandwidth", 100e6)) / n
    return {"freq_array": f0 + np.arange(n) * df, "Nfreqs": n,
            "channel_width": df}


def _select_bls(ants, antpos, bls=None, redundancy=None, no_autos=False,
                anchor_ant=None, antenna_nums=None):
    """Baselines of a mock observation: every upper-triangle pair,
    restricted to bls, to one per redundant group (redundancy = redtol),
    to an anchor antenna or to an antenna subset, without autos if
    asked; sorted."""
    _bls = [(a1, a2) for i, a1 in enumerate(ants) for a2 in ants[i:]]
    if redundancy is not None and bls is None:
        from ..models.telescope import build_reds
        reds = build_reds(AntposDict(list(ants), np.asarray(antpos)),
                          redtol=float(redundancy))[0]
        bls = [g[0] for g in reds]
    if bls is not None:
        want = {tuple(b) for b in bls}
        bls = [bl for bl in _bls if bl in want or bl[::-1] in want]
    else:
        bls = _bls
    if anchor_ant is not None:
        bls = [bl for bl in bls if anchor_ant in bl]
    if no_autos:
        bls = [bl for bl in bls if bl[0] != bl[1]]
    if antenna_nums is not None:
        if isinstance(antenna_nums, (int, np.integer)):
            antenna_nums = [antenna_nums]
        ant_set = set(int(a) for a in antenna_nums)
        bls = [bl for bl in bls if bl[0] in ant_set or bl[1] in ant_set]
    return sorted(bls)


def setup_uvdata(antnums=None, antpos=None, bls=None, redundancy=None,
                 no_autos=False, anchor_ant=None, antenna_nums=None,
                 telescope_location=None, telescope_name="mock",
                 freq_array=None, time_array=None, pol="ee",
                 antnames=None, pol_array=None, x_orientation="north",
                 run_check=True, make_data=True, as_uvdata=False,
                 device=None, dtype=None, **time_freq_params):
    """A mock observation from observatory metadata: a VisData of zeros
    (make_data; complex of dtype on device, None: CUDA) or metadata
    only; as_uvdata converts it to a pyuvdata UVData.

    antnums / antpos: antenna numbers and (Nants, 3) ENU positions [m];
    bls / redundancy / no_autos / anchor_ant / antenna_nums: baseline
    selection (_select_bls); telescope_location (lon, lat, alt) [deg,
    m]; freq_array / time_array, or Ntimes / start_time / time_cadence
    and Nfreqs / start_freq / channel_width / bandwidth; pol_array: the
    pol as a one-element list (AIPS codes -5..-8 map to ee / nn / en /
    ne); antnames go to .antnames.
    """
    if antnums is None or antpos is None:
        raise ValueError("setup_uvdata needs antnums and antpos")
    if pol_array is not None:
        p0 = np.atleast_1d(pol_array)[0]
        pol = {-5: "ee", -6: "nn", -7: "en", -8: "ne"}.get(int(p0), pol) \
            if not isinstance(p0, str) else str(p0)
    antnums = [int(a) for a in antnums]
    antpos = np.asarray(antpos, dtype=np.float64)
    tf = dict(time_freq_params)
    times = parse_time_params({"time_array": time_array, **tf}) \
        if time_array is not None or "Ntimes" in tf else \
        {"time_array": np.asarray([2458168.0]), "Ntimes": 1}
    freqs = parse_freq_params({"freq_array": freq_array, **tf}) \
        if freq_array is not None or "Nfreqs" in tf else \
        {"freq_array": np.asarray([1e8]), "Nfreqs": 1}
    sel = _select_bls(antnums, antpos, bls=bls, redundancy=redundancy,
                      no_autos=no_autos, anchor_ant=anchor_ant,
                      antenna_nums=antenna_nums)
    if len(sel) == 0:
        raise ValueError("No baselines selected.")
    from ..models.telescope import TelescopeModel
    loc = telescope_location if telescope_location is not None \
        else (21.428305555, -30.72152777, 1073.0)
    vd = VisData()
    vd.setup_meta(telescope=TelescopeModel(loc, name=telescope_name),
                  antpos=AntposDict(antnums, antpos))
    data = None
    if make_data:
        data = torch.zeros((1, 1, len(sel), times["Ntimes"],
                            freqs["Nfreqs"]),
                           dtype=_complex_of(dtype or _float()),
                           device=resolve_device(device))
    vd.setup_data(sel, times["time_array"], freqs["freq_array"], pol=pol,
                  data=data, history="setup_uvdata mock observation")
    if antnames is not None:
        vd.antnames = {int(a): str(n) for a, n in zip(antnums, antnames)}
    if as_uvdata:
        return complete_uvdata(vd, run_check=run_check)
    return vd


def complete_uvdata(vd, run_check=True):
    """A (mock) VisData as a populated pyuvdata UVData (pyuvdata >= 2.4,
    imported here)."""
    _require_pyuvdata()
    from pyuvdata import UVData
    if not hasattr(UVData, "new"):
        raise ImportError("complete_uvdata needs pyuvdata >= 2.4 "
                          "(UVData.new)")
    uvd = UVData.new(
        freq_array=np.asarray(vd.freqs),
        polarization_array=np.asarray([-5]),
        times=np.asarray(vd.times),
        telescope_location=(vd.telescope.location[1],
                            vd.telescope.location[0],
                            vd.telescope.location[2]),
        telescope_name=getattr(vd.telescope, "name", "mock"),
        antenna_positions={a: p for a, p in
                           zip(vd.antpos.ants, vd.antpos.asnumpy())},
        antpairs=list(vd.bls))
    if vd.data is not None:
        data = _host(vd.data)
        for i, bl in enumerate(vd.bls):
            inds = uvd.antpair2ind(bl)
            uvd.data_array[inds] = data[0, 0, i][..., None] \
                if uvd.data_array.ndim == 4 else data[0, 0, i]
    if run_check:
        uvd.check()
    return uvd


def run_rime_sim(sky, beam, uvd_template, ant2beam=None, partial_read={},
                 freq_interp="linear", array_kwargs={}, outfname=None,
                 overwrite=False, partial_write=False, verbose=False,
                 device=None, dtype=None, **kwargs):
    """Simulate the template's observation (a UVH5 path, a UVData or a
    VisData) through a RIME of sky and beam and return the VisData;
    with outfname, write it as UVH5 (partial_write: into an existing
    file, write_uvh5_part). The array model is built on device (None:
    CUDA) in dtype from the template's antennas; freq_interp moves a
    sky that has freq_interp onto the template's channels; ant2beam may
    name only one shared beam."""
    vd = PyVisData.read_uvdata(uvd_template, device=device, **partial_read)
    if ant2beam is not None and len(set(ant2beam.values())) != 1:
        raise ValueError("only one shared beam model is supported")
    from ..models.rime import RIME
    from ..models.telescope import ArrayModel
    if hasattr(sky, "freq_interp"):
        sky.freq_interp(vd.freqs, kind=freq_interp)
    akw = dict(device=device, dtype=dtype)
    akw.update(array_kwargs)
    arr = ArrayModel(vd.antpos, freqs=vd.freqs, **akw)
    rime = RIME(sky, vd.telescope, beam, arr, vd.bls, vd.times, vd.freqs,
                **kwargs)
    out = rime.run_batches()
    if outfname is not None:
        if partial_write:
            write_uvh5_part(outfname, out)
        else:
            write_uvh5(out, outfname, overwrite=overwrite)
    return out


def uvd_to_visdata(uvd, **kwargs):
    """PyVisData.read_uvdata."""
    return PyVisData.read_uvdata(uvd, **kwargs)


def get_params_from_uvdata(uvd):
    """Observation metadata of a UVData: antnums, ENU antpos, bls,
    times, freqs and telescope_location (lon, lat, alt); needs
    pyuvdata."""
    _require_pyuvdata()
    ants = [int(a) for a in uvd.antenna_numbers]
    enu = uvd.get_ENU_antpos()[0] if hasattr(uvd, "get_ENU_antpos") \
        else uvd.antenna_positions
    loc = uvd.telescope_location_lat_lon_alt_degrees
    return dict(antnums=ants, antpos=np.asarray(enu),
                bls=uvd.get_antpairs(), times=np.unique(uvd.time_array),
                freqs=np.asarray(uvd.freq_array).ravel(),
                telescope_location=(loc[1], loc[0], loc[2]))
