"""Full-field (nodal) conductivity fin model.

The non-affine variant: the conductivity is a nodal field k(x) =
exp(theta(x)) drawn from a Gaussian random field. Two operators apply
A(k):

- ``ElementOperator``: matrix-free per element (gather the nodal values,
  scale the unit element stiffness by the element's mean conductivity,
  scatter-add), the plain route of ``FullFieldFin``;
- ``fem.dia_nonaffine.NodalStencilOperator``: the same operator as seven
  stencil planes, which the pipeline (``api_full_field.py``) solves on the
  stencil kernels.

``RandomField`` keeps its random-Fourier-feature weights W (2, M) and
phases b (M,) beside the features, so that a coarser mesh can evaluate the
same field (the mid rung of MLDA) and a field drawn elsewhere can be
rebuilt from its W and b (``RandomField.from_weights``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from bayesianinferencedl_tpu_torch.fem import p1
from bayesianinferencedl_tpu_torch.fem.dia import FinFEMDiaHost, StencilOperator
from bayesianinferencedl_tpu_torch.fem.solve import pcg
from bayesianinferencedl_tpu_torch.geometry.mesh import FinMesh
from bayesianinferencedl_tpu_torch.infer.oed import mesh_node_grid_ids
from bayesianinferencedl_tpu_torch.infer.priors import GaussianPrior
from bayesianinferencedl_tpu_torch.utils.device import resolve_device
from bayesianinferencedl_tpu_torch.utils.precision import fp32_matmul


@dataclass(frozen=True)
class ElementOperator:
    """Matrix-free per-element stiffness apply for a nodal conductivity.

    tri:       (nt, 3) row of each element vertex in the vectors it acts on
    Ke_unit:   (nt, 3, 3) unit-conductivity element stiffness
    diag_unit: (nt, 3) its diagonal
    n:         vector length (the padded grid)"""

    tri: torch.Tensor
    Ke_unit: torch.Tensor
    diag_unit: torch.Tensor
    n: int

    @classmethod
    def from_mesh(cls, mesh: FinMesh, n_padded: int, dtype=torch.float32, device="cuda",
                  node_ids=None) -> "ElementOperator":
        """node_ids: (n_nodes,) row of each mesh node (the structured-grid ids
        of ``infer.oed.mesh_node_grid_ids`` for the stencil layout); None
        keeps the mesh numbering."""
        dev = resolve_device(device)
        Ke, _ = p1.element_stiffness(mesh.nodes, mesh.triangles)
        tri = mesh.triangles if node_ids is None else np.asarray(node_ids)[mesh.triangles]
        return cls(
            tri=torch.as_tensor(tri, dtype=torch.int64, device=dev),
            Ke_unit=torch.as_tensor(Ke, dtype=dtype, device=dev),
            diag_unit=torch.as_tensor(Ke[:, [0, 1, 2], [0, 1, 2]], dtype=dtype, device=dev),
            n=int(n_padded),
        )

    def elem_conductivity(self, k_nodal: torch.Tensor) -> torch.Tensor:
        """Element conductivity: the mean of its 3 nodal values."""
        return torch.mean(k_nodal[..., self.tri], dim=-1)

    def _scatter(self, w_e: torch.Tensor) -> torch.Tensor:
        out = w_e.new_zeros((*w_e.shape[:-2], self.n))
        return out.index_add(-1, self.tri.reshape(-1), w_e.reshape(*w_e.shape[:-2], -1))

    def apply(self, k_nodal: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """u -> A(k) u (stiffness part only), over leading batch dimensions."""
        ke = self.elem_conductivity(k_nodal)
        with fp32_matmul():
            w_e = ke[..., None] * torch.einsum("eab,...eb->...ea", self.Ke_unit, u[..., self.tri])
        return self._scatter(w_e)

    def diag(self, k_nodal: torch.Tensor) -> torch.Tensor:
        return self._scatter(self.elem_conductivity(k_nodal)[..., None] * self.diag_unit)


class RandomField(NamedTuple):
    """Squared-exponential Gaussian random field by random Fourier features:
    theta(x) ~ GP(mean, sigma^2 exp(-|x - x'|^2 / (2 ell^2))), with M
    features, so a sample is one (n, M) matvec.

    features: (n, M) sqrt(2/M) cos(x W + b) at each mesh node's row
    W: (2, M) frequencies (already divided by ell); b: (M,) phases"""

    features: torch.Tensor
    sigma: float
    mean: float
    W: Optional[torch.Tensor] = None
    b: Optional[torch.Tensor] = None

    @classmethod
    def create(
        cls,
        mesh: FinMesh,
        n_padded: int,
        *,
        ell: float = 1.0,
        sigma: float = 0.5,
        mean: float = 0.0,
        n_features: int = 256,
        seed: int = 0,
        dtype=torch.float32,
        device="cuda",
        node_ids=None,
    ) -> "RandomField":
        """W ~ N(0, 1) / ell and b ~ U(0, 2 pi) from a float64 CPU
        ``torch.Generator`` seeded with ``seed`` (so the same field on every
        device; the JAX package draws them with its own generator, whose
        stream torch does not reproduce: carry its W and b with
        ``from_weights``). node_ids as in ``from_weights``."""
        g = torch.Generator().manual_seed(int(seed))
        W = torch.randn((2, n_features), generator=g, dtype=torch.float64) / ell
        b = torch.rand((n_features,), generator=g, dtype=torch.float64) * (2.0 * math.pi)
        return cls.from_weights(mesh, n_padded, W, b, sigma=sigma, mean=mean, dtype=dtype,
                                device=device, node_ids=node_ids)

    @classmethod
    def from_weights(cls, mesh: FinMesh, n_padded: int, W, b, *, sigma: float = 0.5,
                     mean: float = 0.0, dtype=torch.float32, device="cuda",
                     node_ids=None) -> "RandomField":
        """The field of given W (2, M) and b (M,), its features evaluated in
        float64 at the mesh's node coordinates. node_ids: (n_nodes,) row of
        each mesh node in the layout that reads the field: the
        structured-grid ids (``infer.oed.mesh_node_grid_ids``) for the
        stencil operators, None for the mesh numbering. The placement must
        be the operator's: a field laid out in the wrong numbering is a
        node-scrambled, partly constant field, not the GP. Rows no mesh node
        owns are zero (the field is its mean there; the operator never
        reads them)."""
        dev = resolve_device(device)
        f64 = lambda a: (a.detach().cpu().double().numpy() if torch.is_tensor(a)
                         else np.array(a, np.float64))
        W64, b64 = f64(W), f64(b)
        M = W64.shape[1]
        ids = np.arange(mesh.n_nodes) if node_ids is None else np.asarray(node_ids)
        feats = np.zeros((n_padded, M))
        feats[ids] = np.sqrt(2.0 / M) * np.cos(np.asarray(mesh.nodes, np.float64) @ W64 + b64)
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
        return cls(features=t(feats), sigma=float(sigma), mean=float(mean), W=t(W64), b=t(b64))

    @property
    def n_features(self) -> int:
        return self.features.shape[1]

    def theta(self, z: torch.Tensor) -> torch.Tensor:
        """RFF coefficients z (..., M) -> nodal log-conductivity (..., n)."""
        with fp32_matmul():
            return self.mean + self.sigma * (z @ self.features.T)

    def sample(self, gen: Optional[torch.Generator] = None,
               n_samples: Optional[int] = None) -> torch.Tensor:
        """Prior draws of theta, (n,) or (n_samples, n)."""
        shape = (self.n_features,) if n_samples is None else (n_samples, self.n_features)
        return self.theta(torch.randn(shape, generator=gen, dtype=self.features.dtype,
                                      device=self.features.device))


class _ElementSolve(torch.autograd.Function):
    """u = A(k)^-1 F for the element operator; backward: one adjoint solve
    (A symmetric) and dL/dk = -d/dk [lam . A(k) u] at fixed lam and u."""

    @staticmethod
    def forward(ctx, k, fin):
        u = fin._pcg(k, fin.op.F_root.expand(*k.shape[:-1], fin.op.n))
        ctx.save_for_backward(k, u)
        ctx.fin = fin
        return u

    @staticmethod
    def backward(ctx, g):
        k, u = ctx.saved_tensors
        fin = ctx.fin
        lam = fin._pcg(k, g)
        with torch.enable_grad():
            kk = k.detach().requires_grad_()
            (grad_k,) = torch.autograd.grad(-torch.sum(lam * fin.elem.apply(kk, u)), kk)
        return grad_k, None


@dataclass
class FullFieldFin:
    """Fin forward model with nodal log-conductivity theta (non-affine), on
    the stencil layout's vectors: ``op`` supplies the Robin mass, the
    padding identity, the loads and the QoI; ``elem`` the stiffness."""

    op: StencilOperator
    elem: ElementOperator
    field: RandomField
    cg_tol: float = 1e-10
    cg_maxiter: int = 3000

    @classmethod
    def create(cls, mesh: FinMesh, host: FinFEMDiaHost, *, biot: float = 0.1,
               dtype=torch.float32, device="cuda", ell: float = 1.0, sigma: float = 0.5,
               n_features: int = 256, seed: int = 0, cg_tol: float = 1e-10,
               cg_maxiter: int = 3000) -> "FullFieldFin":
        """host: the stencil assembly (``fem.dia.assemble_fin_dia``)."""
        op = StencilOperator.from_host(host, biot=biot, dtype=dtype, device=device)
        gid = mesh_node_grid_ids(mesh)
        elem = ElementOperator.from_mesh(mesh, host.n, dtype=dtype, device=device, node_ids=gid)
        field = RandomField.create(mesh, host.n, ell=ell, sigma=sigma, n_features=n_features,
                                   seed=seed, dtype=dtype, device=device, node_ids=gid)
        return cls(op=op, elem=elem, field=field, cg_tol=cg_tol, cg_maxiter=cg_maxiter)

    def _robin(self, u: torch.Tensor) -> torch.Tensor:
        return self.op.matvec(self.op.biot * self.op.ext_mass + self.op.fixed, u)

    def apply(self, theta: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """u -> A(exp(theta)) u, the Robin boundary and padding identity included."""
        return self.elem.apply(torch.exp(theta), u) + self._robin(u)

    def _pcg(self, k: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        k = k.detach()
        rob = self.op.diag(self.op.biot * self.op.ext_mass + self.op.fixed)
        x, _, _ = pcg(lambda v: self.elem.apply(k, v) + self._robin(v), b,
                      self.elem.diag(k) + rob, tol=self.cg_tol, maxiter=self.cg_maxiter)
        return x

    def solve(self, theta: torch.Tensor) -> torch.Tensor:
        """A(exp theta) u = F_root for theta (n,) or (B, n), differentiable
        in theta (first order: an adjoint solve)."""
        theta = torch.as_tensor(theta, dtype=self.op.dtype, device=self.op.device)
        return _ElementSolve.apply(torch.exp(theta), self)

    def forward(self, theta: torch.Tensor) -> torch.Tensor:
        """G: theta -> subfin-average observables."""
        return self.op.observe(self.solve(theta))

    def forward_batch(self, thetas: torch.Tensor) -> torch.Tensor:
        return self.forward(thetas)

    def sample_prior(self, gen: Optional[torch.Generator] = None,
                     n_samples: Optional[int] = None) -> torch.Tensor:
        return self.field.sample(gen, n_samples)

    # --- the coefficient-space view ----------------------------------------
    def theta_from_coeff(self, z: torch.Tensor) -> torch.Tensor:
        """RFF coefficients z (..., M) -> the nodal log-conductivity field."""
        return self.field.theta(z)

    def forward_coeff(self, z: torch.Tensor) -> torch.Tensor:
        """G in coefficient space, z -> observables: under the N(0, I) prior
        on z the whitened setup pCN wants."""
        return self.forward(self.theta_from_coeff(z))

    def coeff_prior(self, dtype=None) -> GaussianPrior:
        """N(0, I_M) over the RFF coefficients."""
        f = self.field.features
        return GaussianPrior.iid(self.field.n_features, mean=0.0, sigma=1.0,
                                 dtype=dtype or f.dtype, device=f.device)
