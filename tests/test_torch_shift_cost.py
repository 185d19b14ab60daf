"""Kernel K5's module (bayesianinferencedl_tpu_torch.experimental.shift_cost)
against the JAX package's shift-cost probe (``scripts/diag_roll_cost.run``,
loaded by path) in interpret mode, in float64 at res1: 16 samples in tiles
of 8, with and without the stencil shifts.

The reference rolls with wrap-around onto zero planes, the port masks reads
outside the vector; the two loops do the same arithmetic, so with the shifts
they agree to 1e-10 relative over 32 iterations. Without the shifts the
operator is the diagonal of A's row sums, which vanish up to rounding at
every node off the convective boundary: from the second iteration on,
p.Ap is a sum of rounding errors whose value depends on the summation order,
and alpha = r.z / p.Ap amplifies it without bound. That variant is compared
after its one determined iteration, and its growth is checked over 32. On the CPU the wrapper runs the plain version; chip_smoke.py holds
the CUDA kernel against it."""

import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from bayesianinferencedl_tpu.fem.dia import StencilOperator as JStencil
from bayesianinferencedl_tpu.fem.dia import assemble_fin_dia as j_assemble
from bayesianinferencedl_tpu_torch.experimental import shift_cost as K5
from bayesianinferencedl_tpu_torch.fem.dia import StencilOperator, assemble_fin_dia

B, TILE, N_ITERS = 16, 8, 32


@pytest.fixture(scope="module")
def setup(mesh_r1):
    path = Path(__file__).resolve().parents[1] / "scripts" / "diag_roll_cost.py"
    spec = importlib.util.spec_from_file_location("diag_roll_cost", path)
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    jop = JStencil.from_host(j_assemble(mesh_r1, pad_to=128), biot=0.1, dtype=jnp.float64)
    top = StencilOperator.from_host(assemble_fin_dia(mesh_r1, pad_to=128), biot=0.1,
                                    dtype=torch.float64, device="cpu")
    ks = np.exp(np.random.default_rng(6).uniform(np.log(0.1), np.log(10), (B, 5)))
    return ref, jop, top, ks


@pytest.mark.parametrize("use_rolls,n_iters", [(True, N_ITERS), (False, 1)], ids=["shifts", "no_shifts"])
def test_plain_version_matches_reference(setup, use_rolls, n_iters):
    ref, jop, top, ks = setup
    jvals = jnp.stack([jop.vals(jnp.asarray(k)) for k in ks])
    with pltpu.force_tpu_interpret_mode():
        xj = np.asarray(ref.run(jvals, jop.F_root, offsets=tuple(int(o) for o in jop.offsets),
                                n_iters=n_iters, use_rolls=use_rolls, tile=TILE))
    before = K5.launches
    vals = top.vals(torch.from_numpy(ks))
    xt = K5.shift_cost(vals, top.F_root, offsets=top.offsets, n_iters=n_iters, use_rolls=use_rolls,
                       tile=TILE).numpy()
    assert K5.launches == before  # CPU tensors: the plain version, no launch
    assert xt.shape == (B, top.n) and np.isfinite(xt).all()
    for b in range(B):
        rel = np.linalg.norm(xt[b] - xj[b]) / np.linalg.norm(xj[b])
        assert rel < 1e-10, (b, rel)
    if not use_rolls:  # the growth the module docstring describes
        grown = K5.shift_cost(vals, top.F_root, offsets=top.offsets, n_iters=N_ITERS, use_rolls=False,
                              tile=TILE)
        assert np.abs(xt).max() < 1e3 and grown.abs().max() > 1e6


def test_wrapper_checks_inputs(setup):
    _, _, top, ks = setup
    vals = top.vals(torch.from_numpy(ks))
    kw = dict(offsets=top.offsets, n_iters=2, use_rolls=True)
    assert K5.shift_cost(vals, top.F_root, tile=TILE, **kw).shape == (B, top.n)
    with pytest.raises(ValueError, match="tile"):
        K5.shift_cost(vals, top.F_root, tile=3, **kw)
    with pytest.raises(ValueError, match="tile"):
        K5.shift_cost(vals[:12], top.F_root, tile=TILE, **kw)
    with pytest.raises(ValueError, match="offsets"):
        K5.shift_cost(vals, top.F_root, tile=TILE, offsets=top.offsets[::-1], n_iters=2, use_rolls=True)
    with pytest.raises(ValueError, match=r"\(B, n, 7\)"):
        K5.shift_cost(vals[..., :4], top.F_root, tile=TILE, **kw)
    with pytest.raises(TypeError):
        K5.shift_cost(vals.half(), top.F_root.half(), tile=TILE, **kw)
    with pytest.raises(ValueError, match="F must be"):
        K5.shift_cost(vals, top.F_root[:-1], tile=TILE, **kw)


def test_main_prints_reference_keys(capsys):
    K5.main(["1", "8", "cpu"])
    lines = [line for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    rows = [json.loads(line) for line in lines]
    assert [r["use_rolls"] for r in rows] == [True, False]
    for r in rows:
        assert set(r) == {"res", "tile", "use_rolls", "per_tile_iter_us", "total_s"}
        assert r["res"] == 1 and r["tile"] == 8 and r["total_s"] > 0
