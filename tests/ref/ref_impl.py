"""Scalar NumPy transcription of the reference kernels — the executable spec
for parity tests (SURVEY.md §4: "kernel parity vs a NumPy scalar reference
implementation transcribed from the cited kernels").

Transcribed (independently, in float64, loop form) from:
- advance_p / move_p : src/species_advance/standard/advance_p.cxx:68-183,
                       src/species_advance/standard/move_p.c:20-136
- load_interpolator  : src/sf_interface/load_interpolator.cxx:72-121
- unload_accumulator : src/sf_interface/unload_accumulator.cxx:40-63
- advance_b          : src/field_advance/standard/advance_b.c:12-14,90-160
- advance_e (vacuum) : src/field_advance/standard/advance_e.c:8-25 with
                       decay=drive=rmu=1
- accumulate_rho_p   : src/species_advance/standard/rho_p.c:24-79

Everything is periodic (optionally with reflecting particle walls on x),
single domain, vacuum.  Arrays are [z,y,x] with one
ghost layer; voxel index i = x + (nx+2)*(y + (ny+2)*z).
"""

import numpy as np


REFLECT = -1   # neighbor code of a reflecting particle boundary


class G:
    def __init__(self, nx, ny, nz, lx=1.0, ly=1.0, lz=1.0, dt=0.05,
                 cvac=1.0, eps0=1.0, damp=0.0, reflect_x=False):
        self.nx, self.ny, self.nz = nx, ny, nz
        self.dt, self.cvac, self.eps0, self.damp = dt, cvac, eps0, damp
        self.dx, self.dy, self.dz = lx / nx, ly / ny, lz / nz
        self.rdx, self.rdy, self.rdz = nx / lx, ny / ly, nz / lz
        self.nxg, self.nyg, self.nzg = nx + 2, ny + 2, nz + 2
        self.nv = self.nxg * self.nyg * self.nzg
        self.neighbor = self._periodic_neighbors()
        if reflect_x:
            # reflecting particle walls on both x faces (set_pbc with
            # reflect_particles, grid/ops.c)
            for z in range(1, nz + 1):
                for y in range(1, ny + 1):
                    self.neighbor[self.voxel(1, y, z), 0] = REFLECT
                    self.neighbor[self.voxel(nx, y, z), 3] = REFLECT

    def voxel(self, x, y, z):
        return x + self.nxg * (y + self.nyg * z)

    def _periodic_neighbors(self):
        nb = np.zeros((self.nv, 6), np.int64)
        for z in range(1, self.nz + 1):
            for y in range(1, self.ny + 1):
                for x in range(1, self.nx + 1):
                    i = self.voxel(x, y, z)
                    wrap = lambda c, n: n if c == 0 else (1 if c == n + 1 else c)
                    nb[i, 0] = self.voxel(wrap(x - 1, self.nx), y, z)
                    nb[i, 1] = self.voxel(x, wrap(y - 1, self.ny), z)
                    nb[i, 2] = self.voxel(x, y, wrap(z - 1, self.nz))
                    nb[i, 3] = self.voxel(wrap(x + 1, self.nx), y, z)
                    nb[i, 4] = self.voxel(x, wrap(y + 1, self.ny), z)
                    nb[i, 5] = self.voxel(x, y, wrap(z + 1, self.nz))
        return nb


def zero_fields(g):
    return {k: np.zeros((g.nzg, g.nyg, g.nxg)) for k in
            ("ex", "ey", "ez", "cbx", "cby", "cbz", "tcax", "tcay", "tcaz",
             "jfx", "jfy", "jfz", "rhof", "rhob", "div_e_err", "div_b_err")}


# ---------------------------------------------------------------------------
# interpolation
# ---------------------------------------------------------------------------

def load_interpolator(f, g):
    ip = np.zeros((g.nv, 18))
    for z in range(1, g.nz + 1):
        for y in range(1, g.ny + 1):
            for x in range(1, g.nx + 1):
                i = g.voxel(x, y, z)
                w0, w1 = f["ex"][z, y, x], f["ex"][z, y + 1, x]
                w2, w3 = f["ex"][z + 1, y, x], f["ex"][z + 1, y + 1, x]
                ip[i, 0] = 0.25 * (w0 + w1 + w2 + w3)
                ip[i, 1] = 0.25 * (-w0 + w1 - w2 + w3)
                ip[i, 2] = 0.25 * (-w0 - w1 + w2 + w3)
                ip[i, 3] = 0.25 * (w0 - w1 - w2 + w3)
                w0, w1 = f["ey"][z, y, x], f["ey"][z + 1, y, x]
                w2, w3 = f["ey"][z, y, x + 1], f["ey"][z + 1, y, x + 1]
                ip[i, 4] = 0.25 * (w0 + w1 + w2 + w3)
                ip[i, 5] = 0.25 * (-w0 + w1 - w2 + w3)
                ip[i, 6] = 0.25 * (-w0 - w1 + w2 + w3)
                ip[i, 7] = 0.25 * (w0 - w1 - w2 + w3)
                w0, w1 = f["ez"][z, y, x], f["ez"][z, y, x + 1]
                w2, w3 = f["ez"][z, y + 1, x], f["ez"][z, y + 1, x + 1]
                ip[i, 8] = 0.25 * (w0 + w1 + w2 + w3)
                ip[i, 9] = 0.25 * (-w0 + w1 - w2 + w3)
                ip[i, 10] = 0.25 * (-w0 - w1 + w2 + w3)
                ip[i, 11] = 0.25 * (w0 - w1 - w2 + w3)
                w0, w1 = f["cbx"][z, y, x], f["cbx"][z, y, x + 1]
                ip[i, 12] = 0.5 * (w0 + w1)
                ip[i, 13] = 0.5 * (-w0 + w1)
                w0, w1 = f["cby"][z, y, x], f["cby"][z, y + 1, x]
                ip[i, 14] = 0.5 * (w0 + w1)
                ip[i, 15] = 0.5 * (-w0 + w1)
                w0, w1 = f["cbz"][z, y, x], f["cbz"][z + 1, y, x]
                ip[i, 16] = 0.5 * (w0 + w1)
                ip[i, 17] = 0.5 * (-w0 + w1)
    return ip


# ---------------------------------------------------------------------------
# particle push
# ---------------------------------------------------------------------------

def _accumulate_j(a, i, q, sd, sm):
    """ACCUMULATE_J over the three axis permutations into a (nv,12) array."""
    v5 = q * sd[0] * sd[1] * sd[2] / 3.0
    col = 0
    for X, Y, Z in ((0, 1, 2), (1, 2, 0), (2, 0, 1)):
        vX = q * sd[X]
        a[i, col + 0] += vX * (1 - sm[Y]) * (1 - sm[Z]) + v5
        a[i, col + 1] += vX * (1 + sm[Y]) * (1 - sm[Z]) - v5
        a[i, col + 2] += vX * (1 - sm[Y]) * (1 + sm[Z]) - v5
        a[i, col + 3] += vX * (1 + sm[Y]) * (1 + sm[Z]) + v5
        col += 4


def move_p(pos, i, disp, u, q, a, g, max_iter=64):
    """Returns (pos, i, disp, u, status): status 0 done, 1 stuck at a
    non-local, non-reflecting boundary (never happens with the tables
    built by G)."""
    for _ in range(max_iter):
        sdir = np.where(np.asarray(disp) > 0, 1.0, -1.0)
        frac = [
            3.4e38 if disp[a_] == 0 else (sdir[a_] - pos[a_]) / disp[a_]
            for a_ in range(3)]
        v3, typ = 2.0, 3
        for a_ in range(3):
            if frac[a_] < v3:
                v3, typ = frac[a_], a_
        v3 *= 0.5
        sd = [disp[a_] * v3 for a_ in range(3)]
        sm = [pos[a_] + sd[a_] for a_ in range(3)]
        _accumulate_j(a, i, q, sd, sm)
        disp = [disp[a_] - sd[a_] for a_ in range(3)]
        pos = [pos[a_] + 2 * sd[a_] for a_ in range(3)]
        if typ == 3:
            return pos, i, disp, u, 0
        v0 = sdir[typ]
        face = typ + (3 if v0 > 0 else 0)
        nb = g.neighbor[i, face]
        if nb == REFLECT:
            # move_p.c: land exactly on the face, flip the momentum and
            # the remaining displacement along the axis, keep walking
            pos[typ] = v0
            u = list(u)
            u[typ] = -u[typ]
            disp[typ] = -disp[typ]
            continue
        if nb < 0 or nb >= g.nv:
            pos[typ] = v0
            return pos, i, disp, u, 1
        i = int(nb)
        pos[typ] = -v0
    raise RuntimeError("walker did not terminate")


def advance_p(p, q_m, ip, a, g):
    """p: dict of arrays dx,dy,dz,i,ux,uy,uz,q (modified in place)."""
    qdt_2mc = 0.5 * q_m * g.dt / g.cvac
    cdt_dx = g.cvac * g.dt * g.rdx
    cdt_dy = g.cvac * g.dt * g.rdy
    cdt_dz = g.cvac * g.dt * g.rdz
    n = len(p["i"])
    for k in range(n):
        dx, dy, dz = p["dx"][k], p["dy"][k], p["dz"][k]
        i = p["i"][k]
        c = ip[i]
        hax = qdt_2mc * ((c[0] + dy * c[1]) + dz * (c[2] + dy * c[3]))
        hay = qdt_2mc * ((c[4] + dz * c[5]) + dx * (c[6] + dz * c[7]))
        haz = qdt_2mc * ((c[8] + dx * c[9]) + dy * (c[10] + dx * c[11]))
        cbx = c[12] + dx * c[13]
        cby = c[14] + dy * c[15]
        cbz = c[16] + dz * c[17]
        ux, uy, uz = p["ux"][k] + hax, p["uy"][k] + hay, p["uz"][k] + haz
        v0 = qdt_2mc / np.sqrt(1 + ux * ux + uy * uy + uz * uz)
        v1 = cbx * cbx + cby * cby + cbz * cbz
        v2 = v0 * v0 * v1
        v3 = v0 * (1 + v2 * (1 / 3 + v2 * 2 / 15))
        v4 = v3 / (1 + v1 * v3 * v3)
        v4 += v4
        w0 = ux + v3 * (uy * cbz - uz * cby)
        w1 = uy + v3 * (uz * cbx - ux * cbz)
        w2 = uz + v3 * (ux * cby - uy * cbx)
        ux += v4 * (w1 * cbz - w2 * cby)
        uy += v4 * (w2 * cbx - w0 * cbz)
        uz += v4 * (w0 * cby - w1 * cbx)
        ux, uy, uz = ux + hax, uy + hay, uz + haz
        p["ux"][k], p["uy"][k], p["uz"][k] = ux, uy, uz
        v0 = 1 / np.sqrt(1 + ux * ux + uy * uy + uz * uz)
        ddx, ddy, ddz = ux * cdt_dx * v0, uy * cdt_dy * v0, uz * cdt_dz * v0
        mx, my, mz = dx + ddx, dy + ddy, dz + ddz
        nx_, ny_, nz_ = mx + ddx, my + ddy, mz + ddz
        if (abs(nx_) <= 1 and abs(ny_) <= 1 and abs(nz_) <= 1):
            p["dx"][k], p["dy"][k], p["dz"][k] = nx_, ny_, nz_
            _accumulate_j(a, i, p["q"][k], (ddx, ddy, ddz), (mx, my, mz))
        else:
            pos, i2, disp, u, status = move_p(
                [dx, dy, dz], int(i), [ddx, ddy, ddz],
                [ux, uy, uz], p["q"][k], a, g)
            assert status == 0
            p["dx"][k], p["dy"][k], p["dz"][k] = pos
            p["ux"][k], p["uy"][k], p["uz"][k] = u
            p["i"][k] = i2


def accumulate_rho_p(f, p, g):
    r8V = 0.125 * g.rdx * g.rdy * g.rdz
    rhof = f["rhof"].reshape(-1)
    sx, sy = 1, g.nxg
    sz = g.nxg * g.nyg
    for k in range(len(p["i"])):
        dx, dy, dz, q = p["dx"][k], p["dy"][k], p["dz"][k], p["q"][k]
        i = p["i"][k]
        w = r8V * q
        for oz, wz in ((0, 1 - dz), (1, 1 + dz)):
            for oy, wy in ((0, 1 - dy), (1, 1 + dy)):
                for ox, wx in ((0, 1 - dx), (1, 1 + dx)):
                    rhof[i + ox * sx + oy * sy + oz * sz] += w * wx * wy * wz


# ---------------------------------------------------------------------------
# fields (periodic vacuum)
# ---------------------------------------------------------------------------

def _wrapped_ghost_tang_b(f, g):
    """Periodic self-join ghost fill (remote.c:61-134 with the rank sending
    to itself)."""
    nx, ny, nz = g.nx, g.ny, g.nz
    # x faces: cby ghost over y 1..ny+1, z 1..nz ; cbz over y 1..ny, z 1..nz+1
    f["cby"][1:nz + 1, 1:ny + 2, 0] = f["cby"][1:nz + 1, 1:ny + 2, nx]
    f["cby"][1:nz + 1, 1:ny + 2, nx + 1] = f["cby"][1:nz + 1, 1:ny + 2, 1]
    f["cbz"][1:nz + 2, 1:ny + 1, 0] = f["cbz"][1:nz + 2, 1:ny + 1, nx]
    f["cbz"][1:nz + 2, 1:ny + 1, nx + 1] = f["cbz"][1:nz + 2, 1:ny + 1, 1]
    # y faces: cbz ghost over z 1..nz+1? (zy ranges) ; cbx
    f["cbz"][1:nz + 2, 0, 1:nx + 1] = f["cbz"][1:nz + 2, ny, 1:nx + 1]
    f["cbz"][1:nz + 2, ny + 1, 1:nx + 1] = f["cbz"][1:nz + 2, 1, 1:nx + 1]
    f["cbx"][1:nz + 1, 0, 1:nx + 2] = f["cbx"][1:nz + 1, ny, 1:nx + 2]
    f["cbx"][1:nz + 1, ny + 1, 1:nx + 2] = f["cbx"][1:nz + 1, 1, 1:nx + 2]
    # z faces: cbx, cby
    f["cbx"][0, 1:ny + 1, 1:nx + 2] = f["cbx"][nz, 1:ny + 1, 1:nx + 2]
    f["cbx"][nz + 1, 1:ny + 1, 1:nx + 2] = f["cbx"][1, 1:ny + 1, 1:nx + 2]
    f["cby"][0, 1:ny + 2, 1:nx + 1] = f["cby"][nz, 1:ny + 2, 1:nx + 1]
    f["cby"][nz + 1, 1:ny + 2, 1:nx + 1] = f["cby"][1, 1:ny + 2, 1:nx + 1]


def advance_b(f, g, frac):
    nx, ny, nz = g.nx, g.ny, g.nz
    px = frac * g.cvac * g.dt * g.rdx if nx > 1 else 0
    py = frac * g.cvac * g.dt * g.rdy if ny > 1 else 0
    pz = frac * g.cvac * g.dt * g.rdz if nz > 1 else 0
    ex, ey, ez = f["ex"], f["ey"], f["ez"]
    for z in range(1, nz + 1):
        for y in range(1, ny + 1):
            for x in range(1, nx + 2):
                f["cbx"][z, y, x] -= (
                    py * (ez[z, y + 1, x] - ez[z, y, x])
                    - pz * (ey[z + 1, y, x] - ey[z, y, x]))
    for z in range(1, nz + 1):
        for y in range(1, ny + 2):
            for x in range(1, nx + 1):
                f["cby"][z, y, x] -= (
                    pz * (ex[z + 1, y, x] - ex[z, y, x])
                    - px * (ez[z, y, x + 1] - ez[z, y, x]))
    for z in range(1, nz + 2):
        for y in range(1, ny + 1):
            for x in range(1, nx + 1):
                f["cbz"][z, y, x] -= (
                    px * (ey[z, y, x + 1] - ey[z, y, x])
                    - py * (ex[z, y + 1, x] - ex[z, y, x]))


def advance_e_vacuum(f, g):
    """Vacuum periodic advance_e: tca = (1+damp)c dt curl cB - damp*tca;
    e = e + (tca - dt/eps0 jf)."""
    nx, ny, nz = g.nx, g.ny, g.nz
    damp = g.damp
    px = (1 + damp) * g.cvac * g.dt * g.rdx if nx > 1 else 0
    py = (1 + damp) * g.cvac * g.dt * g.rdy if ny > 1 else 0
    pz = (1 + damp) * g.cvac * g.dt * g.rdz if nz > 1 else 0
    cj = g.dt / g.eps0
    _wrapped_ghost_tang_b(f, g)
    cbx, cby, cbz = f["cbx"], f["cby"], f["cbz"]
    for z in range(1, nz + 2):
        for y in range(1, ny + 2):
            for x in range(1, nx + 1):
                t = (py * (cbz[z, y, x] - cbz[z, y - 1, x])
                     - pz * (cby[z, y, x] - cby[z - 1, y, x])) \
                    - damp * f["tcax"][z, y, x]
                f["tcax"][z, y, x] = t
                f["ex"][z, y, x] += t - cj * f["jfx"][z, y, x]
    for z in range(1, nz + 2):
        for y in range(1, ny + 1):
            for x in range(1, nx + 2):
                t = (pz * (cbx[z, y, x] - cbx[z - 1, y, x])
                     - px * (cbz[z, y, x] - cbz[z, y, x - 1])) \
                    - damp * f["tcay"][z, y, x]
                f["tcay"][z, y, x] = t
                f["ey"][z, y, x] += t - cj * f["jfy"][z, y, x]
    for z in range(1, nz + 1):
        for y in range(1, ny + 2):
            for x in range(1, nx + 2):
                t = (px * (cby[z, y, x] - cby[z, y, x - 1])
                     - py * (cbx[z, y, x] - cbx[z, y - 1, x])) \
                    - damp * f["tcaz"][z, y, x]
                f["tcaz"][z, y, x] = t
                f["ez"][z, y, x] += t - cj * f["jfz"][z, y, x]


def unload_accumulator(f, a, g):
    av = a.reshape(g.nzg, g.nyg, g.nxg, 12)
    cx = 0.25 * g.rdy * g.rdz / g.dt
    cy = 0.25 * g.rdz * g.rdx / g.dt
    cz = 0.25 * g.rdx * g.rdy / g.dt
    for z in range(1, g.nz + 2):
        for y in range(1, g.ny + 2):
            for x in range(1, g.nx + 2):
                f["jfx"][z, y, x] += cx * (
                    av[z, y, x, 0] + av[z, y - 1, x, 1]
                    + av[z - 1, y, x, 2] + av[z - 1, y - 1, x, 3])
                f["jfy"][z, y, x] += cy * (
                    av[z, y, x, 4] + av[z - 1, y, x, 5]
                    + av[z, y, x - 1, 6] + av[z - 1, y, x - 1, 7])
                f["jfz"][z, y, x] += cz * (
                    av[z, y, x, 8] + av[z, y, x - 1, 9]
                    + av[z, y - 1, x, 10] + av[z, y - 1, x - 1, 11])
