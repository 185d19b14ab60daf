"""Two-level deflation preconditioner for the fused stencil-CG kernel.

Jacobi-CG iteration counts on the fin grow like 1/h^2 because diagonal
scaling leaves the smooth end of A(k)'s spectrum untouched. The additive
coarse correction

    M^-1 = D^-1 + W B(k)^-1 W^T,      B(k) = W^T A(k) W,

removes it. W (n, m) is one coarse space shared by every conductivity
sample, so B(k) inherits the operator's affine structure:
B(k) = sum_i k_i C_i + Bi * C_ext, with C_* = W^T A_* W computed once per
mesh on the host in float64. The coarse space is the m lowest generalized
eigenvectors of (A(1), D(1)) (SciPy shift-invert Lanczos), with smooth
cosine modes as the fallback when the eigensolve fails.

The per-sample inverses B(k)^-1 are a batched Cholesky inverse outside the
kernel (the JAX package uses a Newton-Schulz iteration there only because
its TPU compile path could not build a factorisation).
"""

from __future__ import annotations

import inspect
from dataclasses import dataclass

import numpy as np
import torch

from bayesianinferencedl_tpu_torch.utils.device import resolve_device
from bayesianinferencedl_tpu_torch.utils.precision import fp32_matmul


@dataclass(frozen=True)
class DeflationBasis:
    """Shared coarse basis + affine-Galerkin component projections.

    Wt: (m, n) orthonormal smooth modes, transposed; the kernel streams it
        as ``Wt_bf16`` (preconditioner accuracy only moves the convergence
        rate, never the solution).
    C:  (6, m, m) components: C[0..4] = W^T A_i W, C[5] = W^T M_ext W.
    """

    Wt: torch.Tensor
    Wt_bf16: torch.Tensor
    C: torch.Tensor
    m: int

    @classmethod
    def create(
        cls,
        host,
        biot: float = 0.1,
        *,
        m: int = 128,
        dtype=torch.float32,
        device="cuda",
        basis: str = "eig",
    ) -> "DeflationBasis":
        """Build from a FinFEMDiaHost; all algebra in host float64, the result
        on ``device`` (the card unless the caller asks for "cpu"). basis
        "eig" takes the eigenmodes, falling back to cosine modes if the
        eigensolve fails; "cosine" takes the cosine modes."""
        if basis not in ("eig", "cosine"):
            raise ValueError(f"basis must be 'eig' or 'cosine', got {basis!r}")
        device = resolve_device(device)
        As, Mext = host.to_scipy_components()
        mask = sum(A.diagonal() for A in As) > 0  # stiffness-domain rows

        W = None
        if basis == "eig":
            try:
                W = _eig_modes(As, Mext, biot, mask, m)
            except RuntimeError:  # ARPACK non-convergence or a singular LU
                W = None
        if W is None:
            W = _cosine_modes(host, mask, m)
        W[~mask] = 0.0  # scrub QR's ~1e-16 dust off the structurally-zero rows

        C = np.stack([W.T @ (A @ W) for A in As] + [W.T @ (Mext @ W)])
        Wt = torch.as_tensor(W.T.copy(), dtype=dtype, device=device)
        return cls(
            Wt=Wt,
            Wt_bf16=Wt.to(torch.bfloat16),
            C=torch.as_tensor(C, dtype=dtype, device=device),
            m=m,
        )

    def coarse_matrices(self, ks: torch.Tensor, biot: float) -> torch.Tensor:
        """(B, 5) conductivities -> (B, m, m) coarse Galerkin matrices."""
        ks = torch.as_tensor(ks, dtype=self.C.dtype, device=self.C.device)
        with fp32_matmul():
            return torch.einsum("bi,imk->bmk", ks, self.C[:5]) + biot * self.C[5][None]

    def coarse_inverses(self, ks: torch.Tensor, biot: float, n_iters: int = 24) -> torch.Tensor:
        """(B, 5) -> (B, m, m) inverses of the SPD coarse matrices by a
        batched Cholesky factorisation. B(k) is SPD for positive k. The
        factorisation's status stays on the device, so that a chain step
        that solves the FOM never waits on the host: a sample whose factor
        failed gets an all-NaN inverse (the JAX package's Newton-Schulz
        iteration diverges there), and ``solve_fom_stencil`` returns NaN
        for it. n_iters, the JAX package's Newton-Schulz iteration count, is
        accepted and unused: the Cholesky inverse has no iterations."""
        return _spd_inverse(self.coarse_matrices(ks, biot))

    def coarse_matrices_from_vals(self, op, vals: torch.Tensor, chunk: int = 64) -> torch.Tensor:
        """Exact coarse matrices of an operator that is not affine (the nodal
        full-field operator): each sample's assembled planes vals (B, n, 7)
        projected through the basis, B_ij = w_i . A(vals) w_j, as m stencil
        applies (``op.matvec``'s arithmetic) and one product per sample,
        symmetrised (the float32 products are not exactly symmetric).
        ``chunk`` samples at a time: the (chunk, m, n) block of products is
        all the memory it takes."""
        Wt = self.Wt.to(vals.dtype)
        n, h = op.n, op.max_offset
        Wp = torch.nn.functional.pad(Wt, (h, h))
        shifted = [Wp[:, h + off: h + off + n] for off in op.offsets]  # w_j[. + off_s]
        out = []
        with fp32_matmul():
            for i in range(0, vals.shape[0], chunk):
                v = vals[i:i + chunk, None]  # (c, 1, n, 7)
                # rows A w_j, the stencil matvec accumulated in place: one
                # (c, m, n) block, read and written once a plane
                AW = v[..., 0] * shifted[0]
                for s in range(1, len(shifted)):
                    AW.addcmul_(v[..., s], shifted[s])
                Bk = torch.matmul(Wt, AW.transpose(-1, -2))  # B[i, j] = w_i . (A w_j)
                out.append(0.5 * (Bk + Bk.transpose(-1, -2)))
        return torch.cat(out) if out else vals.new_zeros((0, self.m, self.m))

    def coarse_inverses_from_vals(self, op, vals: torch.Tensor, n_iters: int = 24,
                                  chunk: int = 64) -> torch.Tensor:
        """The inverses of ``coarse_matrices_from_vals`` (B, m, m), by the
        batched Cholesky of ``coarse_inverses``, NaN where a factorisation
        fails (n_iters, as there, unused)."""
        return torch.cat([_spd_inverse(self.coarse_matrices_from_vals(op, vals[i:i + chunk], chunk))
                          for i in range(0, vals.shape[0], chunk)] or [vals.new_zeros((0, self.m, self.m))])


def _spd_inverse(Bk: torch.Tensor) -> torch.Tensor:
    """Batched Cholesky inverse of SPD (B, m, m); all-NaN where the
    factorisation fails."""
    L, info = torch.linalg.cholesky_ex(Bk)
    return torch.where((info == 0)[:, None, None], torch.cholesky_inverse(L), torch.nan)


def _eig_modes(As, Mext, biot: float, mask: np.ndarray, m: int) -> np.ndarray:
    """(n, m) f64 orthonormal: the m lowest generalized eigenvectors of
    (A(1), D(1)) at the geometric-mean conductivity, via shift-invert
    Lanczos on the symmetrically scaled S = D^-1/2 A D^-1/2 (off-domain
    rows get identity so S is SPD). A fixed start vector and restart seed,
    for reproducible builds."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    n = Mext.shape[0]
    A = biot * Mext
    for Ai in As:
        A = A + Ai
    A = (A + sp.diags(np.where(mask, 0.0, 1.0))).tocsr()
    d = A.diagonal()
    Dm = sp.diags(1.0 / np.sqrt(d))
    S = (Dm @ A @ Dm).tocsc()
    lu = spla.splu(S)
    op = spla.LinearOperator(S.shape, matvec=lu.solve)
    v0 = np.full(n, 1.0 / np.sqrt(n))
    # the restarts' random vectors from a fixed seed: where the wanted modes
    # reach the padding rows' eigenvalue 1 (res1, m = 128), ARPACK restarts
    # inside that degenerate eigenspace, and unseeded draws made every build
    # differ (SciPy >= 1.15 takes rng; older ones seed ARPACK themselves)
    seed = {"rng": 0} if "rng" in inspect.signature(spla.eigsh).parameters else {}
    # preconditioner-grade modes only need the right subspace to a few digits
    _, vecs = spla.eigsh(S, k=m, sigma=0, which="LM", OPinv=op, tol=1e-4, v0=v0, **seed)
    V = Dm @ vecs  # undo the scaling: generalized modes of (A, D)
    V[~mask] = 0.0
    W, _ = np.linalg.qr(V)
    return W


def _cosine_modes(host, mask: np.ndarray, m: int) -> np.ndarray:
    """(n, m) f64 orthonormal: the m lowest-frequency tensor-cosine modes on
    the structured grid, masked to the stiffness domain and
    QR-orthonormalized."""
    n = host.n
    res = host.resolution
    x0g, y0g = 24 * res + 1, 16 * res + 1
    side = int(np.ceil(np.sqrt(m))) + 4
    freqs = sorted(
        ((a / x0g) ** 2 + (b / y0g) ** 2, a, b)
        for a in range(side * 2)
        for b in range(side * 2)
    )[:m]
    ix = np.arange(x0g)
    iy = np.arange(y0g)
    modes = np.empty((m, n))
    for i, (_, a, b) in enumerate(freqs):
        cx = np.cos(np.pi * a * (ix + 0.5) / x0g)
        cy = np.cos(np.pi * b * (iy + 0.5) / y0g)
        v = np.zeros(n)
        v[: x0g * y0g] = np.outer(cx, cy).reshape(-1)
        v[~mask] = 0.0
        modes[i] = v
    W, _ = np.linalg.qr(modes.T)
    return W
