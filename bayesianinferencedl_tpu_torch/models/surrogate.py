"""MLP error surrogate + the in-repo Adam update.

The network maps log-conductivity to the QoI-space ROM error
e(k) = y_FOM(k) - y_ROM(k). Weights keep the JAX package's (in, out)
layout, ``h @ W + b``, so converted parameters load as they are. Training
uses the same Adam formula as the reference (its bias correction differs
from ``torch.optim.Adam`` in where eps enters), the same best-validation
snapshot selection, and autograd for the gradients.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import NamedTuple, Sequence

import torch
from torch import nn

from bayesianinferencedl_tpu_torch.utils.device import resolve_device
from bayesianinferencedl_tpu_torch.utils.precision import fp32_matmul

_ACTIVATIONS = {
    "tanh": torch.tanh,
    "relu": torch.relu,
    "gelu": lambda x: nn.functional.gelu(x, approximate="tanh"),
    "softplus": nn.functional.softplus,
}


class MLP(nn.Module):
    """Fully connected net with sizes (in, hidden..., out), built on the card
    unless ``device`` names another ("cuda" without a card raises)."""

    def __init__(
        self,
        sizes: Sequence[int],
        activation: str = "tanh",
        *,
        generator: torch.Generator | None = None,
        dtype=torch.float32,
        device="cuda",
    ):
        super().__init__()
        device = resolve_device(device)
        self.sizes = tuple(int(s) for s in sizes)
        self.activation = activation
        self._act = _ACTIVATIONS[activation]
        self.weights = nn.ParameterList()
        self.biases = nn.ParameterList()
        for din, dout in zip(self.sizes[:-1], self.sizes[1:]):
            W = torch.randn((din, dout), generator=generator, dtype=dtype, device=device)
            self.weights.append(nn.Parameter(W * math.sqrt(2.0 / din)))
            self.biases.append(nn.Parameter(torch.zeros(dout, dtype=dtype, device=device)))

    @classmethod
    def from_params(cls, params, activation: str = "tanh") -> "MLP":
        """Build from [(W (in, out), b (out,)), ...] tensors."""
        sizes = [params[0][0].shape[0]] + [W.shape[1] for W, _ in params]
        W0 = params[0][0]
        mlp = cls(sizes, activation, dtype=W0.dtype, device=W0.device)
        with torch.no_grad():
            for (W, b), pw, pb in zip(params, mlp.weights, mlp.biases):
                pw.copy_(W)
                pb.copy_(b)
        return mlp

    def params(self) -> list[torch.Tensor]:
        """Flat parameter list [W0, b0, W1, b1, ...]."""
        out = []
        for W, b in zip(self.weights, self.biases):
            out += [W, b]
        return out

    @fp32_matmul()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        last = len(self.weights) - 1
        for i, (W, b) in enumerate(zip(self.weights, self.biases)):  # no ParameterList slices: they build modules
            h = h @ W + b
            if i < last:
                h = self._act(h)
        return h


@dataclass
class AdamState:
    step: int
    mu: list
    nu: list


def adam_init(params: Sequence[torch.Tensor]) -> AdamState:
    return AdamState(0, [torch.zeros_like(p) for p in params], [torch.zeros_like(p) for p in params])


@torch.no_grad()
def adam_update(params, grads, state: AdamState, lr, b1=0.9, b2=0.999, eps=1e-8) -> AdamState:
    """One Adam step, in place on ``params``; the reference's formula
    p -= lr sqrt(1 - b2^t) / (1 - b1^t) * m / (sqrt(v) + eps), each
    product and sum in the reference's order. The leaves go through
    multi-tensor (``_foreach``) ops: a handful of launches a step for any
    number of leaves, with the same elementwise arithmetic."""
    params, grads = list(params), list(grads)
    step = state.step + 1
    mu = torch._foreach_add(torch._foreach_mul(state.mu, b1), torch._foreach_mul(grads, 1 - b1))
    nu = torch._foreach_add(torch._foreach_mul(state.nu, b2),
                            torch._foreach_mul(torch._foreach_mul(grads, 1 - b2), grads))
    lr = torch.as_tensor(lr, dtype=params[0].dtype, device=params[0].device)
    t = torch.tensor(float(step), dtype=torch.float32, device=params[0].device)
    scale = lr * torch.sqrt(1 - b2**t) / (1 - b1**t)
    den = torch._foreach_add(torch._foreach_sqrt(nu), eps)
    torch._foreach_sub_(params, torch._foreach_div(torch._foreach_mul(mu, scale), den))
    return AdamState(step, mu, nu)


class Normalizer(NamedTuple):
    """Affine input/output normalisation baked into the surrogate."""

    x_mean: torch.Tensor
    x_std: torch.Tensor
    y_mean: torch.Tensor
    y_std: torch.Tensor

    @classmethod
    def fit(cls, x, y):
        return cls(
            x_mean=x.mean(0),
            x_std=x.std(0, correction=0) + 1e-8,
            y_mean=y.mean(0),
            y_std=y.std(0, correction=0) + 1e-8,
        )


class TrainedSurrogate(NamedTuple):
    mlp: MLP
    norm: Normalizer

    @property
    def params(self) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """The layers as [(W (in, out), b (out,)), ...], detached: the
        reference's ``surrogate.params`` layout."""
        return [(W.detach(), b.detach()) for W, b in zip(self.mlp.weights, self.mlp.biases)]

    def predict(self, log_k: torch.Tensor, *, differentiable: bool = False) -> torch.Tensor:
        """NN error prediction e_hat(k) from log-conductivity, (..., 5) ->
        (..., m); differentiable=True keeps the graph to log_k (the
        gradient samplers), else no graph is recorded."""
        with contextlib.nullcontext() if differentiable else torch.no_grad():
            x = (log_k - self.norm.x_mean) / self.norm.x_std
            return self.mlp(x) * self.norm.y_std + self.norm.y_mean


def _train_loop(mlp: MLP, norm: Normalizer, x, y, gen: torch.Generator, lr,
                batch_size: int, steps: int, n_val: int, idx: torch.Tensor | None = None):
    """Adam on minibatches drawn with replacement; returns (best-validation
    params, per-step training losses, best validation loss). The tail
    ``n_val`` rows are the validation split (rows are iid draws). ``idx``
    (steps, batch_size), if given, holds pre-drawn minibatch rows in place
    of draws from ``gen``, so another generator's draws can be replayed."""
    n = x.shape[0] - n_val
    xn = (x - norm.x_mean) / norm.x_std
    yn = (y - norm.y_mean) / norm.y_std
    x_tr, y_tr = xn[:n], yn[:n]
    x_val, y_val = xn[n:], yn[n:]
    params = mlp.params()

    def loss_fn(xb, yb):
        return torch.mean((mlp(xb) - yb) ** 2)

    # anchor the selection with the constant-mean predictor (last layer
    # zeroed => the net outputs 0 and predict() returns y_mean): the deployed
    # surrogate then never validates worse than "no pointwise correction"
    with torch.no_grad():
        best = [p.detach().clone() for p in params]
        best[-2].zero_()
        best[-1].zero_()
        best_val = torch.mean(y_val**2)

    opt = adam_init(params)
    losses = []
    for t in range(steps):
        rows = idx[t] if idx is not None else torch.randint(
            0, n, (batch_size,), generator=gen, device=gen.device)
        with fp32_matmul():  # the backward's contractions too
            loss = loss_fn(x_tr[rows], y_tr[rows])
            grads = torch.autograd.grad(loss, params)
        opt = adam_update(params, grads, opt, lr)
        with torch.no_grad():
            val = loss_fn(x_val, y_val)
            better = val < best_val
            best = [torch.where(better, p, q) for p, q in zip(params, best)]
            best_val = torch.where(better, val, best_val)
        losses.append(loss.detach())
    return best, torch.stack(losses) if losses else torch.zeros(0), best_val


def train_surrogate(
    log_ks: torch.Tensor,
    errors: torch.Tensor,
    *,
    hidden: Sequence[int] = (64, 64),
    activation: str = "tanh",
    lr: float = 1e-3,
    batch_size: int = 128,
    steps: int = 5000,
    seed: int = 0,
    val_frac: float = 0.1,
    params=None,
    idx: torch.Tensor | None = None,
) -> tuple[TrainedSurrogate, torch.Tensor]:
    """Train the ROM-error surrogate on (log k, e) pairs. Returns the model
    at its best-validation snapshot and the per-step training losses. The
    last ``val_frac`` of the rows is the validation split; where that is no
    row (val_frac=0, or too few rows) the training rows validate
    themselves, so the best-training snapshot is returned, as the JAX
    package's code does. params: initial [(W (in, out), b), ...] in place of
    the seeded draw; idx (steps, batch_size): pre-drawn minibatch rows (as
    ``_train_loop`` takes them), so another generator's run can be
    replayed."""
    dtype, dev = log_ks.dtype, log_ks.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    if params is None:
        mlp = MLP((log_ks.shape[1], *hidden, errors.shape[1]), activation,
                  generator=gen, dtype=dtype, device=dev)
    else:
        mlp = MLP.from_params([(torch.as_tensor(W, dtype=dtype, device=dev),
                                torch.as_tensor(b, dtype=dtype, device=dev)) for W, b in params],
                              activation)
    norm = Normalizer.fit(log_ks, errors)
    n_val = int(val_frac * log_ks.shape[0])
    x, y = log_ks, errors
    if n_val == 0:
        n_val = log_ks.shape[0]
        x, y = torch.cat([log_ks, log_ks]), torch.cat([errors, errors])
    best, losses, _ = _train_loop(mlp, norm, x, y, gen, lr, batch_size, steps, n_val, idx)
    with torch.no_grad():
        for p, q in zip(mlp.params(), best):
            p.copy_(q)
    return TrainedSurrogate(mlp=mlp, norm=norm), losses
