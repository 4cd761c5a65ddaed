"""The policy MLP as an ``nn.Module``.

Counterpart of ``repro.core.networks`` (``init_mlp_net`` /
``apply_mlp_net``): ReLU between layers, weights stored (in, out) as the
reference's ``{"w", "b"}`` layer lists store them, so ``x @ w + b`` is
the reference's arithmetic and a layer list converts without transposes.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn


class MLP(nn.Module):
    """sizes = (in, h1, ..., out).  He-normal weights (std sqrt(2/in))
    and zero biases drawn from a ``torch.Generator`` seeded by ``seed`` on
    the host — the global RNG is left alone."""

    def __init__(self, sizes: tuple[int, ...], seed: int = 0):
        super().__init__()
        g = torch.Generator().manual_seed(int(seed))
        self.weights = nn.ParameterList()
        self.biases = nn.ParameterList()
        for din, dout in zip(sizes[:-1], sizes[1:]):
            w = torch.randn((din, dout), generator=g) * (2.0 / din) ** 0.5
            self.weights.append(nn.Parameter(w))
            self.biases.append(nn.Parameter(torch.zeros(dout)))

    @property
    def sizes(self) -> tuple[int, ...]:
        return (self.weights[0].shape[0],
                *(w.shape[1] for w in self.weights))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        last = len(self.weights) - 1
        for i, (w, b) in enumerate(zip(self.weights, self.biases)):
            x = x @ w + b
            if i < last:
                x = torch.relu(x)
        return x

    def to_layers(self) -> list[dict]:
        """The reference's layer list: ``[{"w": (in, out), "b": (out,)}]``
        as float32 numpy arrays."""
        return [{"w": w.detach().cpu().numpy(), "b": b.detach().cpu().numpy()}
                for w, b in zip(self.weights, self.biases)]

    @classmethod
    def from_layers(cls, layers) -> "MLP":
        """An MLP holding a reference layer list's weights (any array
        type numpy can read, or tensors), on the host."""
        ws = [torch.as_tensor(np.asarray(layer["w"], np.float32))
              for layer in layers]
        bs = [torch.as_tensor(np.asarray(layer["b"], np.float32))
              for layer in layers]
        net = cls((ws[0].shape[0], *(w.shape[1] for w in ws)))
        with torch.no_grad():
            for p, v in zip([*net.weights, *net.biases], [*ws, *bs]):
                p.copy_(v)
        return net
