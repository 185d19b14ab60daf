"""Plain reference of the five-parameter thermal fin, written from its
description and independent of the package under test: it imports nothing
of it and keeps no state of it. The ROM+NN forward here evaluates whatever
basis and MLP weights it is handed; PERF.md says which checks hand it the
package's, and which other check holds that state against this module's own
full-order solve.

The fin: a post of width 1 and height 4 (x in [-0.5, 0.5], y in [0, 4]) with
four pairs of subfins, each 0.25 thick and reaching x = +-3, at heights
[0.75, 1.0] + i. Conductivity k_i on subfin pair i (i = 0..3) and k_4 on the
post; a unit heat flux enters through the root (y = 0, |x| <= 0.5); every
other boundary edge cools with the Robin (Biot) coefficient. P1 elements on a
structured grid of cell size h = 0.25 / resolution over [-3, 3] x [0, 4]:
cells whose centre lies in the fin are kept and split along their
(0, 0)-(1, 1) diagonal. The five observables are the mean temperature of
each region (the four subfin pairs, then the post).

Solutions are vectors over the fin's own nodes; ``lattice`` gives each
node's place ix * (ny + 1) + iy on the full (24 R + 1) x (16 R + 1) node
lattice, the order in which the package returns its solution fields.

Also here: a batched Jacobi-preconditioned CG in any torch dtype (float64 is
the reference; bfloat16 is the lower-precision control), a POD basis of
snapshots, the Galerkin reduced model on a given basis, the reduced solve of
a fixed iteration count and the tanh MLP error model of the ROM+NN forward,
in float64.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch

N_REGIONS = 5


def cell_regions(resolution: int) -> np.ndarray:
    """(nx, ny) region id of each grid cell by its centre, -1 outside."""
    R = int(resolution)
    h = 0.25 / R
    nx, ny = 24 * R, 16 * R
    xc = -3.0 + (np.arange(nx) + 0.5) * h
    yc = (np.arange(ny) + 0.5) * h
    X, Y = np.meshgrid(xc, yc, indexing="ij")
    reg = np.full((nx, ny), -1, dtype=np.int64)
    for i in range(4):
        reg[(np.abs(X) < 3.0) & (Y > 0.75 + i) & (Y < 1.0 + i)] = i
    reg[(np.abs(X) < 0.5) & (Y < 4.0)] = 4
    return reg


@dataclass
class Fin:
    """The assembled fin on ``device``: each node's row of the operator as up
    to seven (column, values) pairs (ELL rows, padded with zero values on
    the diagonal's column), six value columns per pair (k_0..k_4's
    stiffness, then the Robin mass), the root load F, the observation rows Q
    and each node's place on the lattice."""

    resolution: int
    biot: float
    cols: torch.Tensor  # (N, 7) int64
    comps: torch.Tensor  # (N, 7, 6) float64
    diag: torch.Tensor  # (N,) int64: each row's slot holding its diagonal
    F: torch.Tensor  # (N,) float64
    Q: torch.Tensor  # (5, N) float64
    lattice: torch.Tensor  # (N,) int64

    @property
    def N(self) -> int:
        return self.F.shape[0]

    @classmethod
    def build(cls, resolution: int, biot: float, device="cpu") -> "Fin":
        R = int(resolution)
        h = 0.25 / R
        nx, ny = 24 * R, 16 * R
        reg = cell_regions(R)
        ci, cj = np.nonzero(reg >= 0)
        creg = reg[ci, cj]
        node = lambda i, j: i * (ny + 1) + j  # lattice id
        v00, v10, v01, v11 = node(ci, cj), node(ci + 1, cj), node(ci, cj + 1), node(ci + 1, cj + 1)
        tris = np.concatenate([np.stack([v00, v10, v11], 1), np.stack([v00, v11, v01], 1)])
        treg = np.concatenate([creg, creg])
        used = np.unique(tris)
        compact = np.full((nx + 1) * (ny + 1), -1, dtype=np.int64)
        compact[used] = np.arange(used.size)
        N = used.size
        xy = np.stack([-3.0 + (used // (ny + 1)) * h, (used % (ny + 1)) * h], 1)
        t = compact[tris]

        # P1 stiffness of each triangle: grad phi_a = (b_a, c_a) / (2 area)
        p = xy[t]
        x, y = p[..., 0], p[..., 1]
        b = np.stack([y[:, 1] - y[:, 2], y[:, 2] - y[:, 0], y[:, 0] - y[:, 1]], 1)
        c = np.stack([x[:, 2] - x[:, 1], x[:, 0] - x[:, 2], x[:, 1] - x[:, 0]], 1)
        area = 0.5 * (b[:, 0] * c[:, 1] - b[:, 1] * c[:, 0])
        if np.any(area <= 0):
            raise ValueError("a triangle is not counter-clockwise")
        Ke = (b[:, :, None] * b[:, None, :] + c[:, :, None] * c[:, None, :]) / (4.0 * area[:, None, None])
        r_e = np.repeat(t, 3, axis=1).reshape(-1)
        c_e = np.tile(t, (1, 3)).reshape(-1)
        ch_e = np.repeat(treg, 9)
        v_e = Ke.reshape(-1)

        # boundary edges of the kept cells: a side whose neighbour cell is not kept
        keep = np.pad(reg >= 0, 1)
        sides = (  # (neighbour offset, the side's two nodes)
            ((0, -1), v00, v10), ((0, 1), v01, v11), ((-1, 0), v00, v01), ((1, 0), v10, v11),
        )
        ext_a, ext_b, root_a, root_b = [], [], [], []
        for (di, dj), a, bb in sides:
            open_ = ~keep[ci + 1 + di, cj + 1 + dj]
            root = open_ & (dj == -1) & (cj == 0) & (creg == 4)
            ext_a.append(a[open_ & ~root])
            ext_b.append(bb[open_ & ~root])
            root_a.append(a[root])
            root_b.append(bb[root])
        ea, eb = compact[np.concatenate(ext_a)], compact[np.concatenate(ext_b)]
        ra, rb = compact[np.concatenate(root_a)], compact[np.concatenate(root_b)]
        # Robin mass of each exterior edge, (h / 6) [[2, 1], [1, 2]]
        r_m = np.concatenate([ea, ea, eb, eb])
        c_m = np.concatenate([ea, eb, ea, eb])
        v_m = np.concatenate([np.full(ea.size, 2 * h / 6), np.full(ea.size, h / 6),
                              np.full(ea.size, h / 6), np.full(ea.size, 2 * h / 6)])

        rows_all = np.concatenate([r_e, r_m])
        cols_all = np.concatenate([c_e, c_m])
        ch_all = np.concatenate([ch_e, np.full(r_m.size, N_REGIONS)])
        v_all = np.concatenate([v_e, v_m])
        key = rows_all * N + cols_all
        uniq, pos = np.unique(key, return_inverse=True)
        vals = np.zeros((uniq.size, N_REGIONS + 1))
        np.add.at(vals, (pos, ch_all), v_all)
        rows, cols = uniq // N, uniq % N
        # ELL rows: the pattern is sorted by row, so each entry's slot is its rank in its row
        start = np.searchsorted(rows, np.arange(N))
        slot = np.arange(rows.size) - start[rows]
        if slot.max() >= 7:
            raise ValueError("a row has more than seven entries")
        ell_cols = np.repeat(np.arange(N)[:, None], 7, 1)
        ell_vals = np.zeros((N, 7, N_REGIONS + 1))
        ell_cols[rows, slot] = cols
        ell_vals[rows, slot] = vals
        on_diag = rows == cols
        diag = np.full(N, -1)
        diag[rows[on_diag]] = slot[on_diag]
        if np.any(diag < 0):
            raise ValueError("a node has no diagonal entry")

        F = np.zeros(N)
        np.add.at(F, np.concatenate([ra, rb]), h / 2)
        Q = np.zeros((N_REGIONS, N))
        np.add.at(Q, (np.repeat(treg, 3), t.reshape(-1)), np.repeat(area / 3.0, 3))
        Q /= Q.sum(1, keepdims=True)

        T = lambda a, dt=torch.float64: torch.as_tensor(a, dtype=dt, device=device)
        return cls(resolution=R, biot=float(biot), cols=T(ell_cols, torch.int64), comps=T(ell_vals),
                   diag=T(diag, torch.int64), F=T(F), Q=T(Q), lattice=T(used, torch.int64))

    # --- the operator ------------------------------------------------------
    def values(self, ks: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
        """(B, 5) conductivities -> (B, N, 7) values of A(k)'s rows."""
        w = torch.cat([ks.to(dtype), torch.full_like(ks[:, :1], self.biot, dtype=dtype)], 1)
        return torch.einsum("bc,nsc->bns", w, self.comps.to(dtype))

    def matvec(self, vals: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
        """(B, N, 7) values, (B, N) vectors -> (B, N) A X, row by row."""
        return torch.sum(vals * X[:, self.cols], -1)

    def component_apply(self, ch: int, V: torch.Tensor) -> torch.Tensor:
        """(N, r) -> (N, r): one component (0..4 stiffness, 5 Robin mass)."""
        return torch.sum(self.comps[:, :, ch, None].to(V.dtype) * V[self.cols], 1)

    def solve(self, ks: torch.Tensor, *, tol: float = 1e-12, maxiter: int = 100_000,
              dtype=torch.float64, check_every: int = 32) -> tuple[torch.Tensor, torch.Tensor]:
        """Jacobi-preconditioned CG for each row of ks (B, 5), all in
        ``dtype``: (u (B, N), iterations (B,)). A sample stops once
        ||r|| <= tol ||F||, or at maxiter."""
        vals = self.values(ks, dtype)
        dinv = 1.0 / torch.gather(vals, 2, self.diag.expand(vals.shape[0], -1)[..., None])[..., 0]
        B = ks.shape[0]
        F = self.F.to(dtype).expand(B, -1)
        x = torch.zeros_like(F)
        r = F.clone()
        z = r * dinv
        p = z.clone()
        rz = torch.sum(r * z, 1)
        stop = float(tol * torch.linalg.norm(self.F)) ** 2
        its = torch.zeros(B, dtype=torch.int64, device=F.device)
        for i in range(maxiter):
            active = torch.sum(r.double() ** 2, 1) > stop
            if i % check_every == 0 and not bool(active.any()):
                break
            Ap = self.matvec(vals, p)
            pAp = torch.sum(p * Ap, 1)
            alpha = torch.where(active & (pAp > 0), rz / torch.where(pAp > 0, pAp, 1), 0)
            x = x + alpha[:, None] * p
            r = r - alpha[:, None] * Ap
            z = r * dinv
            rz_new = torch.sum(r * z, 1)
            beta = torch.where(active & (rz > 0), rz_new / torch.where(rz > 0, rz, 1), 0)
            p = z + beta[:, None] * p
            rz = torch.where(active, rz_new, rz)
            its += active.to(torch.int64)
        return x, its

    def observe(self, u: torch.Tensor) -> torch.Tensor:
        return u @ self.Q.to(u.dtype).T

    def from_lattice(self, v: torch.Tensor) -> torch.Tensor:
        """(..., n) vectors in the lattice order (padded or not) -> (..., N)
        on the fin's nodes."""
        return v[..., self.lattice]


def misfit(y: torch.Tensor, data: torch.Tensor, sigma: float) -> torch.Tensor:
    """The Gaussian data misfit 0.5 ||y - d||^2 / sigma^2 of each row."""
    r = y - data.to(y.dtype)
    return 0.5 * torch.sum(r * r, -1) / sigma**2


def rom_iters(basis_size: int, noise_sigma: float, online_iters: int = 0) -> int:
    """The deployed reduced-CG iteration count of the configuration: given,
    or max(15, r / 2), raised to 3 r / 4 below a noise of 5e-4."""
    if online_iters:
        return int(online_iters)
    it = max(15, basis_size // 2)
    return max(it, 3 * basis_size // 4) if noise_sigma < 5e-4 else it


@dataclass
class RomNN:
    """The ROM+NN forward, float64: the Galerkin projection of the fin onto
    the basis V, the reduced solve by ``iters`` steps of CG preconditioned by
    the inverse at k = 1 and started from it, the observables of the reduced
    solution, plus the tanh MLP's predicted ROM error at log k."""

    Ahat: torch.Tensor  # (6, r, r): five stiffness components, then the Robin mass
    Fhat: torch.Tensor  # (r,)
    Bhat: torch.Tensor  # (5, r)
    P0: torch.Tensor  # (r, r)
    layers: list  # [(W (in, out), b (out,)), ...] float64
    norm: tuple  # (x_mean, x_std, y_mean, y_std) float64
    biot: float
    iters: int

    @classmethod
    def project(cls, fin: Fin, V: torch.Tensor, layers, norm, iters: int) -> "RomNN":
        """V (N, r): the basis on the fin's nodes; layers and norm: the MLP's
        weights and normaliser."""
        V = V.to(torch.float64)
        Ahat = torch.stack([V.T @ fin.component_apply(c, V) for c in range(N_REGIONS + 1)])
        Ahat = 0.5 * (Ahat + Ahat.transpose(1, 2))
        Fhat = V.T @ fin.F
        Bhat = fin.Q @ V
        A1 = Ahat[:N_REGIONS].sum(0) + fin.biot * Ahat[N_REGIONS]
        f64 = lambda a: torch.as_tensor(a, dtype=torch.float64, device=V.device)
        return cls(Ahat=Ahat, Fhat=Fhat, Bhat=Bhat, P0=torch.linalg.inv(A1),
                   layers=[(f64(W), f64(b)) for W, b in layers], norm=tuple(f64(a) for a in norm),
                   biot=fin.biot, iters=int(iters))

    def to(self, dtype) -> "RomNN":
        """The same model with every array in ``dtype``."""
        c = lambda a: a.to(dtype)
        return RomNN(Ahat=c(self.Ahat), Fhat=c(self.Fhat), Bhat=c(self.Bhat), P0=c(self.P0),
                     layers=[(c(W), c(b)) for W, b in self.layers], norm=tuple(c(a) for a in self.norm),
                     biot=self.biot, iters=self.iters)

    def reduced(self, theta: torch.Tensor) -> torch.Tensor:
        """(C, 5) log k -> (C, 5) observables of the reduced solve."""
        k = torch.exp(theta.to(self.Ahat.dtype))
        w = torch.cat([k, torch.full_like(k[:, :1], self.biot)], 1)
        A = torch.einsum("cj,jab->cab", w, self.Ahat)
        Amul = lambda v: torch.einsum("cab,cb->ca", A, v)
        b = self.Fhat.expand(k.shape[0], -1)
        x = b @ self.P0.T
        res = b - Amul(x)
        z = res @ self.P0.T
        p = z
        rz = torch.sum(res * z, -1)
        for _ in range(self.iters):
            Ap = Amul(p)
            pAp = torch.sum(p * Ap, -1)
            alpha = rz / torch.where(pAp != 0, pAp, 1.0)
            x = x + alpha[:, None] * p
            res = res - alpha[:, None] * Ap
            z = res @ self.P0.T
            rz_new = torch.sum(res * z, -1)
            p = z + (rz_new / torch.where(rz != 0, rz, 1.0))[:, None] * p
            rz = rz_new
        return x @ self.Bhat.T

    def error_model(self, theta: torch.Tensor) -> torch.Tensor:
        x_mean, x_std, y_mean, y_std = self.norm
        h = (theta.to(x_mean.dtype) - x_mean) / x_std
        for i, (W, b) in enumerate(self.layers):
            h = h @ W + b
            if i < len(self.layers) - 1:
                h = torch.tanh(h)
        return h * y_std + y_mean

    def forward(self, theta: torch.Tensor) -> torch.Tensor:
        return self.reduced(theta) + self.error_model(theta)


def pod_basis(snapshots: torch.Tensor, r: int) -> torch.Tensor:
    """(B, N) snapshots -> (N, r): the leading r left singular vectors, in
    float64."""
    U, _, _ = torch.linalg.svd(snapshots.to(torch.float64).T, full_matrices=False)
    return U[:, :r]


def pcn_proposal(theta: torch.Tensor, xi: torch.Tensor, beta: torch.Tensor, mean: float,
                 sigma: float) -> torch.Tensor:
    """pCN's proposal against the prior N(mean, sigma^2 I):
    m + sqrt(1 - b^2) (theta - m) + b sigma xi, per chain."""
    b = beta[:, None]
    return mean + torch.sqrt(1.0 - b * b) * (theta - mean) + b * sigma * xi


def no_tf32() -> None:
    """Keep float32 products in float32: the reference never runs in TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def tf32():
    """float32 products in TF32 on the card (the control's precision for a
    float32 computation that the configuration runs with TF32 off)."""
    before = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


