"""The plain reference against the package on the CPU at small sizes: the
assembled operator entry for entry, the float64 CG against a direct solve,
the ROM+NN forward and the pCN proposal to rounding. (The reference itself
imports nothing of the package; these tests do.)"""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spl
import torch

from portbench.reference import fin5


def _matrix(fin, ch):
    rows = np.repeat(np.arange(fin.N), 7)
    return sp.coo_matrix((fin.comps[:, :, ch].numpy().ravel(), (rows, fin.cols.numpy().ravel())),
                         shape=(fin.N, fin.N)).tocsr()


@pytest.mark.parametrize("res", [1, 2, 3])
def test_assembly_equals_the_packages(res):
    from bayesianinferencedl_tpu_torch.fem.dia import assemble_fin_dia
    from bayesianinferencedl_tpu_torch.geometry.mesh import build_fin_mesh

    fin = fin5.Fin.build(res, 0.1)
    host = assemble_fin_dia(build_fin_mesh(res))
    comps, M = host.to_scipy_components()
    lat = fin.lattice.numpy()
    for ch in range(6):
        theirs = (comps[ch] if ch < 5 else M)[lat][:, lat]
        assert abs(_matrix(fin, ch) - theirs).max() < 1e-14
    assert np.abs(fin.F.numpy() - host.F_root[lat]).max() < 1e-15
    assert np.abs(fin.Q.numpy() - host.qoi[:, lat]).max() < 1e-15
    # the package's lattice holds nothing on nodes outside the fin
    outside = np.setdiff1d(np.arange(host.n_grid), lat)
    assert np.all(host.F_root[outside] == 0) and np.all(host.qoi[:, outside] == 0)


@pytest.mark.parametrize("res", [2, 4])
def test_float64_cg_matches_a_direct_solve(res):
    fin = fin5.Fin.build(res, 0.1)
    ks = torch.exp(torch.randn(3, 5, dtype=torch.float64, generator=torch.Generator().manual_seed(res)))
    u, its = fin.solve(ks)
    for b in range(3):
        A = sum(ks[b, c].item() * _matrix(fin, c) for c in range(5)) + 0.1 * _matrix(fin, 5)
        direct = spl.spsolve(A.tocsc(), fin.F.numpy())
        assert np.linalg.norm(u[b].numpy() - direct) / np.linalg.norm(direct) < 1e-11
    assert int(its.max()) < 100_000


def test_bfloat16_cg_is_far_from_float64():
    fin = fin5.Fin.build(2, 0.1)
    ks = torch.exp(0.5 * torch.randn(4, 5, dtype=torch.float64, generator=torch.Generator().manual_seed(1)))
    u64, _ = fin.solve(ks)
    u16, its = fin.solve(ks, tol=1e-7, maxiter=480, dtype=torch.bfloat16)
    gap = torch.linalg.norm(u16.double() - u64, dim=1) / torch.linalg.norm(u64, dim=1)
    assert torch.all(torch.isfinite(gap)) and float(gap.min()) > 1e-3


def test_rom_nn_forward_matches_the_package_to_rounding():
    from bayesianinferencedl_tpu_torch import api
    from bayesianinferencedl_tpu_torch.config import PipelineConfig, MeshConfig, ROMConfig, SurrogateConfig, FEMConfig

    cfg = PipelineConfig(mesh=MeshConfig(resolution=2), fem=FEMConfig(biot=0.1, cg_tol=1e-7, cg_maxiter=480),
                         rom=ROMConfig(n_snapshots=32, basis_size=8),
                         surrogate=SurrogateConfig(hidden=(16, 16), n_train=64, epochs=3))
    pipe = api.build_pipeline(cfg, device="cpu")
    fin = fin5.Fin.build(2, 0.1)
    rom = fin5.RomNN.project(fin, fin.from_lattice(pipe.rom.V.double().T).T, [(W.double(), b.double()) for W, b in pipe.surrogate.params],
                             tuple(a.double() for a in pipe.surrogate.norm), pipe.rom_pcg_iters)
    assert rom.iters == fin5.rom_iters(8, cfg.mcmc.noise_sigma)
    theta = 0.6 * torch.randn(64, 5, generator=torch.Generator().manual_seed(2))
    theirs = pipe.working_forward_fn("rom_nn")(theta).double()
    ours = rom.forward(theta.double())
    assert float((theirs - ours).abs().max() / ours.abs().max()) < 1e-5
    assert torch.allclose(rom.Ahat[:5], pipe.rom.Ahat.double(), rtol=1e-5, atol=1e-6 * float(rom.Ahat.abs().max()))


def test_pcn_proposal_matches_the_packages():
    from bayesianinferencedl_tpu_torch.infer.pcn import pcn_step
    from bayesianinferencedl_tpu_torch.infer.pcn import PCNState
    from bayesianinferencedl_tpu_torch.infer.priors import GaussianPrior

    prior = GaussianPrior.iid(5, mean=0.0, sigma=0.6, dtype=torch.float64, device="cpu")
    g = torch.Generator().manual_seed(3)
    theta = torch.randn(16, 5, dtype=torch.float64, generator=g)
    xi = torch.randn(16, 5, dtype=torch.float64, generator=g)
    beta = torch.rand(16, dtype=torch.float64, generator=g)
    seen = {}

    def misfit(x):
        seen["prop"] = x
        return torch.zeros(x.shape[0], dtype=x.dtype)

    state = PCNState(theta=theta, phi=torch.zeros(16, dtype=torch.float64), n_accept=torch.zeros(16, dtype=torch.int32))
    pcn_step(misfit, prior, beta, state, normals=xi, uniforms=torch.full((16,), 0.5, dtype=torch.float64))
    assert torch.allclose(seen["prop"], fin5.pcn_proposal(theta, xi, beta, 0.0, 0.6), atol=1e-14)
