"""
Cosmology: a self-contained flat Lambda-CDM background with 21 cm
intensity-mapping helpers.

Counterpart of bayeslim_tpu/models/cosmology.py (Cosmology :23-127,
gauss1d :129, cube2lcone :138, cube2map :188), kept as its own copy:
host numpy plus scipy's interp1d, no device code. The background
(H(z), comoving distance) is integrated directly, with one massive
neutrino counted as matter and CMB radiation, so that distances match
astropy's FlatLambdaCDM(H0=67.7, Om0=0.3075, Tcmb0=2.725, Neff=3.05,
m_nu=[0, 0, 0.06] eV) to < 0.05 % over 0 < z < 50.
"""
from __future__ import annotations

import numpy as np

__all__ = ["Cosmology", "gauss1d", "cube2lcone", "cube2map"]

C_KMS = 299792.458  # speed of light [km/s]
F21 = 1.420405751e9
W21 = 0.211061140542


class Cosmology:
    """Flat Lambda-CDM with 21 cm helpers.

    Distances are in Mpc, H0 in km/s/Mpc. Neutrino treatment: one massive
    (0.06 eV) species approximated as matter at z <~ 100 (the relevant
    regime for 21 cm work), two massless counted in radiation; this
    matches astropy's FlatLambdaCDM(H0=67.7, Om0=0.3075, Tcmb0=2.725,
    Neff=3.05, m_nu=[0,0,0.06] eV) comoving distances to <0.05% over
    0 < z < 50.
    """

    def __init__(self, H0=67.7, Om0=0.3075, Ob0=0.0486, Tcmb0=2.725,
                 Neff=3.05, m_nu_eV=0.06):
        self.H0 = float(H0)
        self.Om0 = float(Om0)
        self.Ob0 = float(Ob0)
        self.Tcmb0 = float(Tcmb0)
        self.Neff = float(Neff)
        self._f21 = F21
        self._w21 = W21

        h = self.H0 / 100.0
        # photon density
        self.Ogamma0 = 2.4729e-5 * (Tcmb0 / 2.725) ** 4 / h ** 2
        # massless neutrinos (2 species of Neff)
        nu_massless = 2.0
        self.Onu0_rel = self.Ogamma0 * 0.2271 * Neff * (nu_massless / 3.0)
        # massive neutrino as matter (Omega_nu h^2 = m_nu / 93.04 eV)
        self.Onu0_mass = m_nu_eV / 93.04 / h ** 2
        self.Or0 = self.Ogamma0 + self.Onu0_rel
        self.Ode0 = 1.0 - self.Om0 - self.Or0 - self.Onu0_mass

        self._r_of_z = None  # lazy interpolation table

    # --- background ----------------------------------------------------------
    def Efunc(self, z):
        zp = 1.0 + np.asarray(z, dtype=np.float64)
        return np.sqrt((self.Om0 + self.Onu0_mass) * zp ** 3
                       + self.Or0 * zp ** 4 + self.Ode0)

    def H(self, z):
        """Hubble parameter [km/s/Mpc]."""
        return self.H0 * self.Efunc(z)

    def _build_r_table(self, zmax=60.0, n=3000):
        zs = np.concatenate([[0.0], np.geomspace(1e-4, zmax, n)])
        integrand = lambda zz: 1.0 / self.Efunc(zz)
        # cumulative trapezoid on a dense grid
        zg = np.linspace(0, zmax, 20000)
        f = integrand(zg)
        cum = np.concatenate([[0.0], np.cumsum((f[1:] + f[:-1]) / 2 *
                                               np.diff(zg))])
        r = C_KMS / self.H0 * cum
        # lazy: scipy.interpolate import deferred off the package import
        from scipy.interpolate import interp1d
        self._r_of_z = interp1d(zg, r, kind="cubic")
        self._z_of_r = interp1d(r, zg, kind="cubic")

    def comoving_distance(self, z):
        """LOS comoving distance [Mpc]."""
        if self._r_of_z is None:
            self._build_r_table()
        return self._r_of_z(np.asarray(z, dtype=np.float64))

    def comoving_transverse_distance(self, z):
        """= comoving_distance for flat cosmology."""
        return self.comoving_distance(z)

    # --- 21 cm helpers -----------------------------------------------------
    def f2z(self, freq):
        return self._f21 / np.asarray(freq, dtype=np.float64) - 1

    def z2f(self, z):
        return self._f21 / (np.asarray(z, dtype=np.float64) + 1)

    def f2r(self, f):
        return self.comoving_distance(self.f2z(f))

    def r2f(self, r):
        if self._r_of_z is None:
            self._build_r_table()
        return self.z2f(self._z_of_r(np.asarray(r, dtype=np.float64)))

    def dRperp_dtheta(self, z):
        """[Mpc / radian]."""
        return self.comoving_transverse_distance(z)

    def dRpara_df(self, z):
        """[Mpc / Hz]."""
        z = np.asarray(z, dtype=np.float64)
        return (1 + z) ** 2 / self.H(z) * C_KMS / self._f21

    def X2Y(self, z):
        """[Mpc^3 / (radian^2 Hz)]."""
        return self.dRperp_dtheta(z) ** 2 * self.dRpara_df(z)

    def bl_to_kperp(self, z):
        """baseline [m] -> k_perp [Mpc^-1 / m] (Parsons 2012 convention)."""
        return 2 * np.pi / (self.dRperp_dtheta(z)
                            * (C_KMS * 1e3 / self.z2f(z)))

    def tau_to_kpara(self, z):
        """delay [s] -> k_parallel [Mpc^-1 / s]."""
        return 2 * np.pi / self.dRpara_df(z)


def gauss1d(x, scale=1.0, loc=0.0):
    """Normalized 1D Gaussian window."""
    w = np.atleast_2d(np.exp(-0.5 * (np.asarray(x) - loc) ** 2 / scale ** 2))
    w = w / w.sum(axis=1, keepdims=True)
    if w.size == 1:
        w = w[0, 0]
    return w


def cube2lcone(sims, sim_r, r, sim_res, angs=None, rinterp="nearest",
               interp="nearest", cosmo=None, roll=None):
    """Project coeval simulation cubes onto a lightcone (after P.
    Kittisiwit's cosmotile).

    sims : (Nsim, Npix, Npix, Npix) coeval cubes (or one cube), or a
        .npy filepath
    sim_r : (Nsim,) comoving distance of each cube [Mpc]
    r : (Nr,) output radial comoving distances [Mpc]
    sim_res : cube voxel resolution [Mpc]
    angs : optional (theta, phi) [rad] colat/az sampling (2, Npix);
        default samples the cube's own X, Y grid
    rinterp : radial interpolation between coeval cubes
        ('nearest' | 'linear' | 'quadratic'); quadratic is an exact
        3-point Lagrange fit
    interp : spatial interpolation inside a cube ('nearest' | 'linear')

    Returns the (Nr, ...) lightcone.
    """
    if isinstance(sims, str):
        sims = np.load(sims)
    sims = np.asarray(sims)
    if sims.ndim == 3:
        sims = sims[None]
    sim_r = np.atleast_1d(np.asarray(sim_r, dtype=np.float64))
    r = np.atleast_1d(np.asarray(r, dtype=np.float64))
    lcone = []
    for rr in r:
        order = np.argsort(np.abs(rr - sim_r))
        if rinterp == "nearest" or len(sim_r) == 1:
            cube = sims[order[0]]
        elif rinterp == "linear":
            s1, s2 = sorted(order[:2])
            b = (sims[s2] - sims[s1]) / (sim_r[s2] - sim_r[s1])
            cube = b * rr + (sims[s1] - b * sim_r[s1])
        elif rinterp == "quadratic":
            s1, s2, s3 = sorted(order[:3])
            r1, r2, r3 = sim_r[s1], sim_r[s2], sim_r[s3]
            L1 = (rr - r2) * (rr - r3) / ((r1 - r2) * (r1 - r3))
            L2 = (rr - r1) * (rr - r3) / ((r2 - r1) * (r2 - r3))
            L3 = (rr - r1) * (rr - r2) / ((r3 - r1) * (r3 - r2))
            cube = sims[s1] * L1 + sims[s2] * L2 + sims[s3] * L3
        else:
            raise ValueError(rinterp)
        lcone.append(cube2map(cube, rr, sim_res, angs=angs, roll=roll,
                              interp=interp))
    return np.asarray(lcone)


def cube2map(cube, dc, sim_res, angs=None, roll=None, interp="nearest"):
    """Tile a simulation cube and sample a shell at comoving distance dc:
    nearest or trilinear lookup at the (theta, phi) [rad] sample
    directions, or along the z axis only when angs is None."""
    cube = np.asarray(cube)
    nx, ny, nz = cube.shape
    if roll is not None:
        if isinstance(roll, (int, np.integer)):
            roll = (roll, roll, roll)
        cube = np.roll(cube, roll, axis=(0, 1, 2))

    if angs is not None:
        theta, phi = np.asarray(angs[0]), np.asarray(angs[1])
        st = np.sin(theta)
        xr = st * np.cos(phi) * dc / sim_res
        yr = st * np.sin(phi) * dc / sim_res
        zr = np.cos(theta) * dc / sim_res
        if interp == "nearest":
            xi = np.mod(np.around(xr).astype(int), nx)
            yi = np.mod(np.around(yr).astype(int), ny)
            zi = np.mod(np.around(zr).astype(int), nz)
            return np.asarray(cube[xi, yi, zi])
        if interp == "linear":
            xd, yd, zd = xr % 1, yr % 1, zr % 1
            x0, x1 = (np.mod(np.floor(xr).astype(int), nx),
                      np.mod(np.ceil(xr).astype(int), nx))
            y0, y1 = (np.mod(np.floor(yr).astype(int), ny),
                      np.mod(np.ceil(yr).astype(int), ny))
            z0, z1 = (np.mod(np.floor(zr).astype(int), nz),
                      np.mod(np.ceil(zr).astype(int), nz))
            c00 = cube[x0, y0, z0] * (1 - xd) + cube[x1, y0, z0] * xd
            c01 = cube[x0, y0, z1] * (1 - xd) + cube[x1, y0, z1] * xd
            c10 = cube[x0, y1, z0] * (1 - xd) + cube[x1, y1, z0] * xd
            c11 = cube[x0, y1, z1] * (1 - xd) + cube[x1, y1, z1] * xd
            c0 = c00 * (1 - yd) + c10 * yd
            c1 = c01 * (1 - yd) + c11 * yd
            return c0 * (1 - zd) + c1 * zd
        raise ValueError(interp)

    # no angs: sample the z axis only (a tiled slab, not a true map)
    zr = dc / sim_res
    if interp == "nearest":
        return np.asarray(cube[..., np.mod(int(np.around(zr)), nz)])
    if interp == "linear":
        zd = zr % 1
        z0 = np.mod(int(np.floor(zr)), nz)
        z1 = np.mod(int(np.ceil(zr)), nz)
        return cube[..., z0] * (1 - zd) + cube[..., z1] * zd
    raise ValueError(interp)
