"""
Dirty-map imaging: m = D A^T W v, with the PSF matrix P = D A^T W A*.

Counterpart of bayeslim_tpu/models/imaging.py (make_map :28, compute_P
:38, deconvolve_map :60, VisMapper :79, VisData2MapData :595,
compute_Am :614, compute_Pm :623, get_visdata :633).

For each time, A[b, f, p] = conj(fringe[b, f, p]) beam[f, p] mask[p]
over that time's padded FOV cut (a host precompute: zen / az, the cut
and its mask, the pointing vectors s), with fringe = exp(+2 pi i f
b.s / c). The JAX package builds A per time. At config #5's width one
time of A is 54,615 x 1024 x ~6,144 complex values (2.75 TB), so the
port's kernel route never builds it; it runs the RIME kernel
(``ops.rime_cuda.rime_fwd``) with the delay factored as blvecs @ s / c,
a pixel chunk at a time (``_pix_chunks``). The delays are formed in
float64 and passed as float32 with the float32 rounding's residual
(rime_fwd's tauT_lo): a float32 delay alone moves a config #5 map by
~5e-4 of its rms against float64.

- make_map's map, Re sum_b (w v)[b, f] conj(fringe) beam: one launch
  with baselines as K and pixels as N, conj set and only the real plane
  out (RimeFusedBS.backward's role-swapped launch);
- compute_Am, the forward transform of beam-weighted maps: a forward
  launch (pixels as K, baselines as N);
- compute_Pm: a forward launch, then a role-swapped one;
- compute_P(contract='rowsum'): the forward launch of beam x mask (the
  row sums of conj(A)), then a role-swapped one.

|fringe| = 1, so contract='diag' and the 'Aw' / 'A2w' normalisations
need only |A| = |beam| mask: they are closed forms on both routes.

The beam is evaluated in float64 whatever the beam's and the mapper's
type (``VisMapper._beam``: (Nfreqs, Npad) values a time), and the maps,
P and the norms are accumulated and normalised in float64, then
returned in the mapper's type: an Airy beam evaluated in float32 is off
by ~1e-4 of itself near its nulls, where 'A2w' divides by its square.
Only the kernel's inputs (and a float32 plain route's A) are cast.

The kernel route is taken where ``VisMapper._kernel_route`` allows it:
use_kernel ("auto": on CUDA; True: on the CPU too, where rime_fwd runs
its plain version), a regular frequency grid (a set_freq_inds selection
may not be one), a real beam or none, float32 on CUDA (the kernel's
type), and not inside ``ops.rime_kernel.force_chunked``. Otherwise, and
for contract=None (the full Nfreqs x Npix x Npix P, small problems), the
plain version builds A per time in pixel chunks as the JAX package
does. The JAX package's jit caches (_mm_cache, _an_cache) have no
counterpart: the port runs eagerly.
"""
from __future__ import annotations

import numpy as np
import torch

from ..data.containers import MapData, VisData
from ..ops.phase import fringe_phasor
from ..ops.rime_cuda import _pix_chunks, no_tf32, rime_fwd
from ..ops.rime_kernel import chunked_forced
from ..utils.dtypes import C_MS, _float, resolve_device
from ..utils.indexing import blnum2ants
from .telescope import ArrayModel

__all__ = ["VisMapper", "make_map", "compute_P", "deconvolve_map",
           "VisData2MapData", "compute_Am", "compute_Pm", "get_visdata"]

# elements of one (Nbls, Nfreqs, chunk) block of A on the plain route
_PLAIN_ELEMS = 1 << 24


def _einsum(eq, *ops):
    with no_tf32():
        return torch.einsum(eq, *ops)


def _mm(a, b):
    with no_tf32():
        return a @ b


def make_map(v, w, A):
    """Single-time dirty map Re A^T (w v): v (..., Nbls, Nfreqs), w
    (Nbls, Nfreqs), A (Nbls, Nfreqs, Npix) -> (..., Nfreqs, Npix)."""
    wv = (w * v).to(A.dtype)
    return _einsum("...bf,bfp->...fp", wv, A).real


def compute_P(A, w, D=None, contract=None):
    """PSF matrix D A^T W A*: contract 'diag' its diagonal and 'rowsum'
    its row sums, (Nfreqs, Npix); None the full (Nfreqs, Npix, Npix). D
    (Nfreqs, Npix) multiplies the result (along the rows of the full
    matrix)."""
    w = w.to(A.dtype)
    if contract == "diag":
        P = _einsum("bfp,bf,bfp->fp", A, w, A.conj()).real
    elif contract == "rowsum":
        P = _einsum("bfp,bf,bfq->fp", A, w, A.conj()).real
    else:
        P = _einsum("bfp,bf,bfq->fpq", A, w, A.conj()).real
    if D is not None:
        P = P * (D if contract is not None else D[:, :, None])
    return P


def deconvolve_map(m, P, pinv=True, rcond=1e-15, hermitian=True):
    """pinv(P) m per frequency. pinv=False inverts only P's diagonal; a
    P with m's dimensions is already a diagonal PSF."""
    if P.ndim == m.ndim:
        return m / torch.clamp(P, min=1e-30)
    if pinv:
        Pinv = torch.linalg.pinv(P, rtol=rcond, hermitian=hermitian)
    else:
        Pinv = torch.diag_embed(1.0 / torch.diagonal(P, dim1=1, dim2=2))
    return _einsum("fpq,fq->fp", Pinv, m)


def compute_Am(A, m):
    """conj(A) m, the forward transform of maps through the imaging
    matrix: A (Nbls, Nfreqs, Npix), m (..., Nfreqs, Npix) -> (...,
    Nbls, Nfreqs)."""
    return _einsum("vfp,...fp->...vf", A.conj(), m)


def compute_Pm(A, w, m, D=None):
    """P m = D A^T w (conj(A) m), the PSF's action on maps without the
    (Npix, Npix) P."""
    wAm = w * compute_Am(A, m.to(A.dtype))
    Pm = _einsum("vfp,...vf->...fp", A, wAm).real
    return Pm if D is None else Pm * D


def get_visdata(vd, bl_inds=None, time_inds=None, freq_inds=None,
                squeeze=False):
    """The data of a VisData, a tensor or a list of either (stacked),
    at the given baseline, time and frequency indices."""
    if isinstance(vd, list):
        return torch.stack([get_visdata(v, bl_inds, time_inds, freq_inds,
                                        squeeze) for v in vd])
    data = vd.data if isinstance(vd, VisData) else torch.as_tensor(vd)

    def take(x, idx, dim):
        if idx is None:
            return x
        return x.index_select(dim, torch.as_tensor(
            np.atleast_1d(idx), dtype=torch.int64, device=x.device))
    out = take(data, bl_inds, data.ndim - 3)
    out = take(out, time_inds, data.ndim - 2)
    out = take(out, freq_inds, data.ndim - 1)
    return out.squeeze() if squeeze else out


def VisData2MapData(vd, data=None, angs=None, cov=None, icov=None,
                    cov_axis=None, norm=None, df=None, name=None):
    """A MapData with a VisData's metadata: pols from vd.pol, and flags
    (a channel flagged on every baseline and time) broadcast over the
    pixels."""
    md = MapData()
    md.setup_meta(name=name)
    pols = ["ee", "nn"] if vd.pol is None else [vd.pol]
    npix = np.shape(angs)[1] if angs is not None else 1
    flags = None
    if vd.flags is not None:
        f = vd.flags
        if isinstance(f, torch.Tensor):
            f = f.all(dim=3).all(dim=2)
            flags = f[..., None].expand(tuple(f.shape) + (npix,))
        else:
            f = np.asarray(f).all(axis=(2, 3))
            flags = np.broadcast_to(f[..., None], f.shape + (npix,))
    md.setup_data(vd.freqs, df=df, data=data, pols=pols, angs=angs,
                  flags=flags, cov=cov, icov=icov, cov_axis=cov_axis,
                  norm=norm)
    return md


class VisMapper:
    """Dirty-map imaging of a single-pol VisData.

    For each time the maps are A^T (w v) over that time's FOV pixels,
    accumulated over times and normalised by D (set_normalization):
    'w' 1 / sum w, 'Aw' 1 / sum w |A|, 'A2w' 1 / sum w |A|^2 (least
    squares). vd needs its telescope and antpos (setup_meta); ra / dec
    [deg] are the map's pixels. beam: a PixelBeam (1-pol, the same for
    every antenna), None for none. use_kernel: "auto" images through the
    RIME kernel on CUDA where the problem is eligible, True also on the
    CPU (its plain version), False never (module docstring). pix_chunk:
    pixels a chunk (None: the kernel route's delay-buffer budget, and
    A's element budget on the plain route). device / dtype: default
    those of vd.data.
    """

    def __init__(self, vd, ra, dec, beam=None, fov=180.0, pad_to=None,
                 use_kernel="auto", pix_chunk=None, device=None,
                 dtype=None):
        data = vd.data if isinstance(vd.data, torch.Tensor) else None
        self.device = data.device if device is None and data is not None \
            else resolve_device(device)
        self.dtype = dtype or (data.real.dtype if data is not None
                               else _float())
        self.cdtype = torch.complex128 if self.dtype == torch.float64 \
            else torch.complex64
        self.vd = vd
        self.telescope = vd.telescope
        self.antpos = vd.antpos
        self.ra = np.asarray(ra, dtype=np.float64)
        self.dec = np.asarray(dec, dtype=np.float64)
        self.Npix = len(self.ra)
        self.beam = beam
        self.fov = beam.fov if beam is not None else fov
        self.use_kernel = use_kernel
        self.pix_chunk = pix_chunk
        self.icov = None
        self._vd_full = vd
        self._sel = {}
        self._pad_to = pad_to
        self.set_normalization()
        self._reselect()

    # ------------------------------------------------------- selection
    def _reselect(self):
        vd = self._vd_full.select(**self._sel, inplace=False) \
            if self._sel else self._vd_full
        self.vd = vd
        self.freqs = np.asarray(vd.freqs, dtype=np.float64)
        self.Nfreqs = len(self.freqs)
        self.times = np.asarray(vd.times)
        self.bls = vd.bls
        self.Nbls = len(self.bls)
        av = self.antpos.asnumpy()
        a1 = self.antpos.index([b[0] for b in self.bls])
        a2 = self.antpos.index([b[1] for b in self.bls])
        self.blvecs = torch.as_tensor(av[a2] - av[a1], dtype=self.dtype,
                                      device=self.device)
        self._blvecs64 = torch.as_tensor(av[a2] - av[a1],
                                         dtype=torch.float64,
                                         device=self.device)
        self.D = None
        self._reslice_icov()
        self._precompute(self._pad_to)

    def _reslice_icov(self):
        """The user's icov (of the original VisData's shape) on the
        current selection."""
        if getattr(self, "_icov_full", None) is None:
            return
        inds = self._vd_full.get_inds(**self._sel)
        self.icov = self._vd_full._index_arr(torch.as_tensor(
            self._icov_full), inds)

    def set_bl_inds(self, bl_inds=None, blnums=None):
        """Image only these baselines (indices into the original VisData,
        or blnums); None for all."""
        if bl_inds is not None and blnums is not None:
            raise ValueError("give bl_inds or blnums, not both")
        if bl_inds is None and blnums is None:
            self._sel.pop("bl", None)
        elif bl_inds is not None:
            self._sel["bl"] = [self._vd_full.bls[int(i)]
                               for i in np.atleast_1d(bl_inds)]
        else:
            self._sel["bl"] = [tuple(b) for b in
                               blnum2ants(np.atleast_1d(blnums))]
        self._reselect()

    def set_time_inds(self, time_inds=None, times=None):
        """Image only these times (indices or Julian dates); None for
        all."""
        if time_inds is not None and times is not None:
            raise ValueError("give time_inds or times, not both")
        if time_inds is None and times is None:
            self._sel.pop("times", None)
        else:
            self._sel["times"] = np.asarray(self._vd_full.times)[
                np.atleast_1d(time_inds)] if time_inds is not None \
                else np.atleast_1d(times)
        self._reselect()

    def set_freq_inds(self, freq_inds=None, freqs=None):
        """Image only these frequencies (indices or Hz); None for all."""
        if freq_inds is not None and freqs is not None:
            raise ValueError("give freq_inds or freqs, not both")
        if freq_inds is None and freqs is None:
            self._sel.pop("freqs", None)
        else:
            self._sel["freqs"] = np.asarray(self._vd_full.freqs)[
                np.atleast_1d(freq_inds)] if freq_inds is not None \
                else np.atleast_1d(freqs)
        self._reselect()

    # ------------------------------------------------------ precompute
    def _precompute(self, pad_to=None):
        """Per time (host): zen / az, the FOV cut padded to one size with
        its mask, the pointing vectors s of the true angles, the beam's
        angles with its pointing offset and its interpolation ctx; kept
        as tensors on the mapper's device."""
        raw = [self.telescope.eq2top(t, self.ra, self.dec)
               for t in self.times]
        ncut = max(int((zen < self.fov / 2).sum()) for zen, _ in raw)
        pad = pad_to or max(8, int(np.ceil(ncut / 8) * 8))
        s_l, zen_l, az_l, cut_l, mask_l, ctx_l = [], [], [], [], [], []
        for zen, az in raw:
            idx = np.where(zen < self.fov / 2)[0]
            cut = np.zeros(pad, dtype=np.int64)
            cut[:len(idx)] = idx
            mask = np.zeros(pad, dtype=bool)
            mask[:len(idx)] = True
            s_l.append(ArrayModel.s_vector(zen[cut], az[cut]))
            zen_b, az_b = (self.beam.apply_pointing(zen[cut], az[cut])
                           if self.beam is not None
                           else (zen[cut], az[cut]))
            zen_l.append(zen_b)
            az_l.append(az_b)
            cut_l.append(cut)
            mask_l.append(mask)
            if self.beam is not None and hasattr(self.beam.R, "precompute"):
                ctx_l.append(self.beam.R.precompute(zen_b, az_b))
        self.Npad = pad
        self._s = np.stack(s_l)
        self._cut = np.stack(cut_l)
        self._mask = np.stack(mask_l)
        t = dict(dtype=self.dtype, device=self.device)
        self._s_t = torch.as_tensor(self._s, **t)
        self._s64 = torch.as_tensor(self._s, dtype=torch.float64,
                                    device=self.device)
        self._cut_t = torch.as_tensor(self._cut, device=self.device)
        self._mask_t = torch.as_tensor(self._mask, **t)
        self._zen, self._az = np.stack(zen_l), np.stack(az_l)
        self._ctx = None
        if self.beam is not None:
            bt = dict(dtype=torch.float64, device=self.beam._freqs_t.device)
            self._zen_b = torch.as_tensor(self._zen, **bt)
            self._az_b = torch.as_tensor(self._az, **bt)
            self._bfreqs = torch.as_tensor(self.beam.freqs, **bt)
            if ctx_l:
                self._ctx = (torch.as_tensor(np.stack([c[0] for c in ctx_l]),
                                             device=bt["device"]),
                             torch.as_tensor(np.stack([c[1] for c in ctx_l]),
                                             **bt))
            self._beam_complex = self._beam(0).is_complex()
        else:
            self._beam_complex = False

    def set_normalization(self, method="A2w", icov=None, clip=1e-8):
        """method 'w', 'Aw' or 'A2w'; icov (the original VisData's
        shape) weights the maps, re-sliced by the set_*_inds
        selections (default the VisData's icov, else ones); D = 1 /
        max(norm, clip)."""
        if method not in ("w", "Aw", "A2w"):
            raise ValueError(f"unknown normalization {method!r}")
        self.method = method
        self._icov_full = icov
        self.icov = icov
        self.clip = clip
        self.D = None
        if getattr(self, "_sel", None):
            self._reslice_icov()

    # ----------------------------------------------------- the pieces
    def _beam_fidx(self):
        """Indices of the mapper's channels in the beam's own (None when
        they are the beam's)."""
        if self.beam is None:
            return None
        bf = np.asarray(self.beam.freqs)
        if len(bf) == len(self.freqs) and np.allclose(bf, self.freqs):
            return None
        return np.asarray([int(np.argmin(np.abs(bf - f)))
                           for f in self.freqs])

    def _beam(self, i):
        """Time i's beam (Nfreqs, Npad) at the mapper's channels, squared
        for a field beam, in float64 (complex128 for a complex beam): the
        beam's params, angles, interpolation weights and channels are
        cast before it is evaluated; None without a beam."""
        if self.beam is None:
            return None
        ctx = None if self._ctx is None else (self._ctx[0][i],
                                              self._ctx[1][i])
        p = self.beam.params
        p = p.to(torch.complex128 if p.is_complex() else torch.float64)
        b = self.beam.gen_beam(self._zen_b[i], self._az_b[i], ctx=ctx,
                               params=p, angles_offset=True,
                               freqs=self._bfreqs)[0, 0, 0]
        if b.real.dtype != torch.float64:
            raise TypeError(f"the beam's response {type(self.beam.R)} "
                            f"gave {b.dtype} from float64 params and "
                            "angles; imaging needs it in float64")
        fidx = self._beam_fidx()
        if fidx is not None and b.shape[0] != self.Nfreqs:
            b = b[torch.as_tensor(fidx, device=b.device)]
        if not self.beam.powerbeam:
            b = b ** 2
        return b.to(self.device)

    def _w(self, i, icov=None):
        """Time i's weights (Nbls, Nfreqs)."""
        icov = self._icov() if icov is None else icov
        if icov is not None:
            return icov[0, 0, :, i, :].real.to(device=self.device,
                                                dtype=self.dtype)
        return torch.ones((self.Nbls, self.Nfreqs), dtype=self.dtype,
                          device=self.device)

    def _icov(self):
        return self.icov if self.icov is not None else self.vd.icov

    def _kernel_route(self):
        """True where the maps, compute_Am / compute_Pm and a rowsum P
        go through rime_fwd (module docstring)."""
        if not self.use_kernel or chunked_forced() or self._beam_complex:
            return False
        if self.Nfreqs > 1:
            d = np.diff(self.freqs)
            if not np.allclose(d, d[0], rtol=1e-10):
                return False
        if self.device.type == "cuda":
            return self.dtype == torch.float32
        return self.use_kernel is True

    def _grid(self):
        f0 = float(self.freqs[0])
        df = float(self.freqs[1] - self.freqs[0]) if self.Nfreqs > 1 else 0.0
        return f0, df

    def _chunks(self, kernel):
        if self.pix_chunk is not None:
            c = int(self.pix_chunk)
            return [slice(i, min(i + c, self.Npad))
                    for i in range(0, self.Npad, c)]
        if kernel:
            return _pix_chunks(self.Nbls, self.Npad)
        c = max(1, _PLAIN_ELEMS // max(self.Nbls * self.Nfreqs, 1))
        return [slice(i, min(i + c, self.Npad))
                for i in range(0, self.Npad, c)]

    def _A(self, i, sl, b):
        """The plain route's imaging matrix of time i on the pixels sl
        of its cut: (Nbls, Nfreqs, len(sl)) complex."""
        tau = _mm(self.blvecs, self._s_t[i][:, sl]) / C_MS
        A = fringe_phasor(tau, self.freqs, conj=True).movedim(-1, 1)
        if b is not None:
            b = b[:, sl]
            A = A * b.to(self.cdtype if b.is_complex() else self.dtype)
        return A * self._mask_t[i][sl]

    def build_A(self, time_ind):
        """Time time_ind's imaging matrix (Nbls, Nfreqs, Npad), built
        whole (small problems)."""
        return self._A(time_ind, slice(None), self._beam(time_ind))

    def build_v(self, time_ind, vd=None):
        vd = self.vd if vd is None else vd
        return vd.data[0, 0, :, time_ind, :]

    def build_w(self, time_ind):
        return self._w(time_ind)

    def _delays(self, i, sl, swapped):
        """Time i's delays b.s / c on the pixels sl for a rime_fwd launch,
        (Nbls, C) role-swapped, (C, Nbls) forward: formed in float64,
        returned as (tauT, tauT_lo), the float32 delays and their
        rounding's residual (tauT_lo None for a float64 mapper)."""
        with no_tf32():
            tau = (self._blvecs64 @ self._s64[i][:, sl] if swapped
                   else self._s64[i][:, sl].t() @ self._blvecs64.t()) / C_MS
        if self.dtype == torch.float64:
            return tau, None
        hi = tau.float()
        return hi, (tau - hi.double()).float()

    def _swapped(self, i, ps, b, chunks):
        """Re sum_b ps[r, b] conj(fringe[b, r, p]) beam mask over time
        i's cut: rime_fwd with baselines as K, pixels as N, conj set, the
        real plane out, a launch a chunk. ps (R, Nbls) complex, R a
        multiple of Nfreqs. Returns (R, Npad) in float64 (the float64
        beam applied to the kernel's output)."""
        f0, df = self._grid()
        ps = ps.to(self.cdtype).contiguous()
        out = torch.zeros((ps.shape[0], self.Npad), dtype=self.dtype,
                          device=self.device)
        for sl in chunks:
            tauT, lo = self._delays(i, sl, True)               # (Nbls, C)
            out[:, sl] = rime_fwd(ps, tauT, f0, df, self.Nfreqs, conj=True,
                                  out_imag=False, tauT_lo=lo)
        bm = self._mask_t[i] if b is None else b * self._mask_t[i]
        nl = ps.shape[0] // self.Nfreqs
        return (out.reshape(nl, self.Nfreqs, self.Npad) * bm).reshape(
            out.shape)

    def _forward(self, i, mc, b, chunks):
        """sum_p mc[r, p] beam mask fringe[b, r, p] over time i's cut:
        rime_fwd with pixels as K, baselines as N, a launch a chunk. mc
        (R, Npad) real or complex. Returns (R, Nbls) complex."""
        f0, df = self._grid()
        nl = mc.shape[0] // self.Nfreqs
        bm = self._mask_t[i] if b is None else b * self._mask_t[i]
        ps = (mc.reshape(nl, self.Nfreqs, self.Npad) * bm).reshape(mc.shape)
        ps = ps.to(self.cdtype if ps.is_complex() else self.dtype)
        out = None
        for sl in chunks:
            tauT, lo = self._delays(i, sl, False)              # (C, Nbls)
            o = rime_fwd(ps[:, sl].contiguous(), tauT, f0, df, self.Nfreqs,
                         conj=False, tauT_lo=lo)
            out = o if out is None else out + o
        return out

    def _norm(self, Aw, w, b, i):
        """Add time i's part of the normalisation: sum_b w (method 'w'),
        sum_b w |A| = sum_b w |beam| mask ('Aw') or sum_b w |A|^2 =
        sum_b w |beam|^2 mask ('A2w'), on the cut's pixels, in float64."""
        ws = w.to(torch.float64).sum(0)[:, None]
        if self.method == "w":
            return Aw + ws
        a = torch.ones_like(self._mask_t[i]) if b is None else b.abs()
        if self.method == "A2w":
            a = a * a
        return Aw.index_add(1, self._cut_t[i], ws * a * self._mask_t[i])

    def _psf(self, i, w, b, contract, kernel):
        """Time i's P over its cut: (Nfreqs, Npad) for 'diag' / 'rowsum',
        (Nfreqs, Npad, Npad) for None; in float64."""
        if contract == "diag":
            a = torch.ones_like(self._mask_t[i]) if b is None else b.abs()
            return (w.to(torch.float64).sum(0)[:, None] * a * a
                    * self._mask_t[i])
        if contract is None:
            return compute_P(self.build_A(i), w, contract=None).double()
        if contract != "rowsum":
            raise ValueError(f"unknown contract {contract!r}")
        if kernel:
            chunks = self._chunks(True)
            ones = torch.ones((self.Nfreqs, self.Npad), dtype=self.dtype,
                              device=self.device)
            S = self._forward(i, ones, b, chunks)      # (F, Nb): sum_q A*
            return self._swapped(i, w.t() * S, b, chunks)
        chunks = self._chunks(False)
        S = None
        for sl in chunks:
            s = self._A(i, sl, b).conj().sum(-1)
            S = s if S is None else S + s
        P = torch.zeros((self.Nfreqs, self.Npad), dtype=torch.float64,
                        device=self.device)
        for sl in chunks:
            P[:, sl] = _einsum("bfp,bf->fp", self._A(i, sl, b), w * S).real
        return P

    @staticmethod
    def _maps2tensor(maps):
        """MapData, list or tensor -> (..., Nfreqs, Npix) tensor."""
        def m2t(m):
            return m.get_data() if isinstance(m, MapData) else m
        if isinstance(maps, list):
            return torch.stack([torch.as_tensor(m2t(m)) for m in maps])
        return torch.as_tensor(m2t(maps))

    # ---------------------------------------------------- entry points
    def make_map(self, vd=None, return_P=True, contract="diag"):
        """Maps accumulated over times and normalised: (maps (...,
        Nfreqs, Npix), P (None without return_P)); D is kept as self.D.
        vd: another VisData (or a list, imaged as a leading axis) on
        this mapper's geometry; the weights are always this mapper's."""
        vd = self.vd if vd is None else vd
        if isinstance(vd, (list, tuple)):
            data = torch.stack([torch.as_tensor(v.data) for v in vd])
        else:
            data = torch.as_tensor(vd.data)
        data = data.to(device=self.device, dtype=self.cdtype)
        icov = self._icov()
        lead = tuple(data.shape[:-5])
        nf, npx = self.Nfreqs, self.Npix
        kernel = self._kernel_route()
        chunks = self._chunks(kernel)
        rt = dict(dtype=torch.float64, device=self.device)
        maps = torch.zeros(lead + (nf, npx), **rt)
        Aw = torch.zeros((nf, 1 if self.method == "w" else npx), **rt)
        P = None
        if return_P:
            P = torch.zeros((nf, npx) if contract is not None
                            else (nf, npx, npx), **rt)
        fidx = torch.arange(nf, device=self.device)
        for i in range(len(self.times)):
            cut, mask = self._cut_t[i], self._mask_t[i]
            b = self._beam(i)
            w = self._w(i, icov)
            v = data[..., 0, 0, :, i, :]                  # (..., Nb, F)
            if kernel:
                ps = (w * v).movedim(-1, -2).reshape(-1, self.Nbls)
                m = self._swapped(i, ps, b, chunks).reshape(
                    lead + (nf, self.Npad))
            else:
                m = torch.zeros(lead + (nf, self.Npad), **rt)
                for sl in chunks:
                    m[..., sl] = make_map(v, w, self._A(i, sl, b))
            maps = maps.index_add(maps.ndim - 1, cut, m * mask)
            if return_P:
                _P = self._psf(i, w, b, contract, kernel)
                if contract is not None:
                    P = P.index_add(1, cut, _P * mask)
                else:
                    P = P.index_put((fidx[:, None, None], cut[None, :, None],
                                     cut[None, None, :]), _P,
                                    accumulate=True)
            Aw = self._norm(Aw, w, b, i)
        D = 1.0 / torch.clamp(Aw, min=self.clip)
        maps = (maps * D).to(self.dtype)
        if return_P:
            P = (P * (D if contract is not None else D[:, :, None])).to(
                self.dtype)
        self.D = D.to(self.dtype)
        return maps, P

    def compute_P(self, D=None, contract="diag"):
        """The PSF over all sky pixels, summed over times and normalised
        by D (default this mapper's normalisation): contract 'diag' /
        'rowsum' -> (Nfreqs, Npix), None -> (Nfreqs, Npix, Npix)."""
        nf, npx = self.Nfreqs, self.Npix
        kernel = self._kernel_route()
        rt = dict(dtype=torch.float64, device=self.device)
        icov = self._icov()
        P = torch.zeros((nf, npx) if contract is not None
                        else (nf, npx, npx), **rt)
        Aw = torch.zeros((nf, 1 if self.method == "w" else npx), **rt)
        fidx = torch.arange(nf, device=self.device)
        for i in range(len(self.times)):
            cut, mask = self._cut_t[i], self._mask_t[i]
            b = self._beam(i)
            w = self._w(i, icov)
            _P = self._psf(i, w, b, contract, kernel)
            if contract is not None:
                P = P.index_add(1, cut, _P * mask)
            else:
                P = P.index_put((fidx[:, None, None], cut[None, :, None],
                                 cut[None, None, :]), _P, accumulate=True)
            if D is None:
                Aw = self._norm(Aw, w, b, i)
        if D is None:
            D = 1.0 / torch.clamp(Aw, min=self.clip)
        else:
            D = torch.as_tensor(D, **rt)
        return (P * (D if contract is not None else D[:, :, None])).to(
            self.dtype)

    def compute_Am(self, maps):
        """A* maps for each time: the RIME forward transform of maps
        (MapData, list or tensor (..., Nfreqs, Npix)) -> (..., Nbls,
        Ntimes, Nfreqs) complex, the leading axis dropped when maps had
        none."""
        maps = self._maps2tensor(maps).to(self.device)
        squeeze = maps.ndim == 2
        m = maps[None] if squeeze else maps.reshape((-1,) + maps.shape[-2:])
        kernel = self._kernel_route()
        chunks = self._chunks(kernel)
        out = [self._Am(i, m, kernel, chunks)
               for i in range(len(self.times))]
        v = torch.stack(out, dim=2)                      # (M, Nb, Nt, F)
        if squeeze:
            return v[0]
        return v.reshape(maps.shape[:-2] + v.shape[1:])

    def _Am(self, i, m, kernel, chunks):
        """(M, Nbls, Nfreqs) of time i for maps m (M, Nfreqs, Npix)."""
        mc = m[..., self._cut_t[i]]
        if not mc.is_complex():
            mc = mc.to(self.dtype)
        b = self._beam(i)
        if kernel:
            o = self._forward(i, mc.reshape(-1, self.Npad), b, chunks)
            return o.reshape(m.shape[0], self.Nfreqs,
                             self.Nbls).movedim(-1, -2)
        out = None
        for sl in chunks:
            A = self._A(i, sl, b)
            o = compute_Am(A, mc[..., sl].to(A.dtype))
            out = o if out is None else out + o
        return out

    def compute_Pm(self, maps, D=None):
        """The PSF's action on maps, P maps = D A^T w (A* maps), summed
        over times with this mapper's normalisation (or D):
        (..., Nfreqs, Npix)."""
        maps = self._maps2tensor(maps).to(self.device)
        squeeze = maps.ndim == 2
        m = maps[None] if squeeze else maps.reshape((-1,) + maps.shape[-2:])
        nf, npx, M = self.Nfreqs, self.Npix, m.shape[0]
        kernel = self._kernel_route()
        chunks = self._chunks(kernel)
        rt = dict(dtype=torch.float64, device=self.device)
        icov = self._icov()
        Pm = torch.zeros((M, nf, npx), **rt)
        Aw = torch.zeros((nf, 1 if self.method == "w" else npx), **rt)
        for i in range(len(self.times)):
            cut, mask = self._cut_t[i], self._mask_t[i]
            b = self._beam(i)
            w = self._w(i, icov)
            wAm = w * self._Am(i, m, kernel, chunks)       # (M, Nb, F)
            if kernel:
                ps = wAm.movedim(-1, -2).reshape(-1, self.Nbls)
                _Pm = self._swapped(i, ps, b, chunks).reshape(
                    M, nf, self.Npad)
            else:
                _Pm = torch.zeros((M, nf, self.Npad), **rt)
                for sl in chunks:
                    _Pm[..., sl] = _einsum("vfp,...vf->...fp",
                                           self._A(i, sl, b), wAm).real
            Pm = Pm.index_add(2, cut, _Pm * mask)
            if D is None:
                Aw = self._norm(Aw, w, b, i)
        D = 1.0 / torch.clamp(Aw, min=self.clip) if D is None \
            else torch.as_tensor(D, **rt)
        Pm = (Pm * D).to(self.dtype)
        if squeeze:
            return Pm[0]
        return Pm.reshape(maps.shape[:-2] + Pm.shape[1:])

    def deconvolve_map(self, m, P, **kwargs):
        return deconvolve_map(m, P, **kwargs)

    def to_MapData(self, maps, name="dirty_map"):
        return VisData2MapData(
            self.vd, data=torch.as_tensor(maps)[None, None],
            angs=np.stack([self.ra, self.dec]), norm=self.D, name=name)
